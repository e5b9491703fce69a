"""PyTorch port vs the JAX package: the two collecting elimination sweeps
at ranks 1-8, kernel 6 (the solve+inverse sweep of the analytic backward,
csrc/backward_sweep.cu) and kernel 8 (the solve's sweep,
csrc/solve_sweep.cu), on shapes that exercise their designs.

Both run csrc/pipeline.cuh's split sweep: lane groups of 32 chunk lanes
(fewer where shared memory is short), two to a thread block where they
fit, each with one warp running the elimination's carried part down
tiles of 3 rows from a ring of 3 input tiles (2 where shared memory is
short), and three warps that copy the rows in ahead of it and form each
row's hats, its log-det and its terms of the sums from what the chain
parks.  So the shapes here hold C = 35 and 45 chunks (no multiple of 32:
a ragged second lane group) and s = 2 (one row, the first row's seeding
from O_0 alone), 4 (one tile) and 15 (five tiles, the ring wrapping, the
two tile buffers alternating); on the card also C = 1 (a lone lane),
s = 128 (the main path's chunk length) and C = 70 (a ragged second
block).

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``forward_sweep_solveinv_pallas`` and
``forward_sweep_collect_pallas``, float64, pivot jitter 1e-3) with the
bar of tests/test_torch_posterior.py.  The kernels against their twins, at
ranks 1, 5 and 8, run only on a card (marked ``cuda``, skipped here); the
JAX package is imported inside the reference helper, so the card tests
collect without it:
``python -m pytest --noconftest tests/test_torch_elim_sweeps.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import sweep_cuda
from test_torch_ksys_walk import _close
from test_torch_post_walks import _system

torch.set_num_threads(1)

_JITTER = 1e-3
_CPU = [(2, 35), (4, 45), (15, 35)]  # (s, C)
_CARD = _CPU + [(2, 1), (4, 1), (15, 45), (128, 70)]
# kernel 6 and kernel 8 by the name of their wrappers' stem
_SWEEPS = ("forward_sweep_solveinv", "forward_sweep_collect")


def _inputs(d, s, c, seed, dtype=torch.float64):
    """(R_cm, O_cm, y_cm) of a block-tridiagonal system diagonally dominant
    at every block size d, s rows by c chunks."""
    return [t.to(dtype).contiguous() for t in _system(d, s, c, seed)[:3]]


def _pallas_sweep(stem, args, key):
    """The TPU kernel ``{stem}_pallas`` in interpret mode on ``args``,
    pivot jitter 1e-3, computed once per test run (numpy outputs, the hat
    stacks cut to the true chunk count: the TPU kernels pad C to their
    lane tile)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep
    from torch_reference_cache import shared

    c = args[0].shape[-1]
    fn = getattr(pallas_sweep, f"{stem}_pallas")

    def compute():
        with pltpu.force_tpu_interpret_mode():
            out = fn(*(jnp.asarray(a.numpy()) for a in args),
                     jitter=_JITTER)
        return [np.asarray(o)[..., :c] if np.ndim(o) else np.asarray(o)
                for o in out]

    return shared(key, compute)


@pytest.mark.parametrize("stem", _SWEEPS)
@pytest.mark.parametrize("s,c", _CPU)
def test_sweep_twin_matches_pallas(stem, s, c, no_persistent_cache_writes):
    """forward_sweep_solveinv_plain (kernel 6's twin) and
    forward_sweep_collect_plain (kernel 8's) == their TPU kernels in
    interpret mode, float64, rank 5, every output (the last state, mh, ld,
    the hat stacks, pinv for kernel 6, ld_rows): rtol 1e-10, atol 1e-12 of
    each output's scale (the bar of tests/test_torch_posterior.py)."""
    args = _inputs(5, s, c, seed=10 * s + c + len(stem))
    with torch.no_grad():
        got = getattr(sweep_cuda, f"{stem}_cuda")(*args, _JITTER)
    ref = _pallas_sweep(stem, args, f"elim_{stem}_{s}_{c}")
    assert len(got) == len(ref) == (13 if stem == _SWEEPS[0] else 12)
    assert got[8].shape == (s - 1, 5, 5, c)
    _close(got, ref, 1e-10, 1e-12, f"{stem}, s = {s}, C = {c}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrappers run their twins and count nothing."""
    k6 = sweep_cuda.forward_sweep_solveinv_cuda
    k8 = sweep_cuda.forward_sweep_collect_cuda
    before = (k6.launches, k6.launches_split, k6.launches_warp,
              k8.launches, k8.launches_split, k8.launches_rt)
    with torch.no_grad():
        k6(*_inputs(2, 3, 4, seed=0), _JITTER)
        k8(*_inputs(2, 3, 4, seed=0), _JITTER)
    assert (k6.launches_split, k8.launches_split) == (0, 0)
    assert (k6.launches, k6.launches_split, k6.launches_warp,
            k8.launches, k8.launches_split, k8.launches_rt) == before


# ---------------------------------------------------------------------------
# On the card: the kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _bars(dtype):
    """chip_smoke.py's bars: rtol and atol of each output's scale."""
    return (1e-3, 1e-4) if dtype == torch.float32 else (1e-9, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", _CARD)
@pytest.mark.parametrize("stem", _SWEEPS)
def test_sweep_on_card(card, stem, dtype, r, s, c):
    """Kernel 6 or 8 == its twin, every output (the last state, mh, ld,
    the hat stacks, pinv, ld_rows), the same bits on a second run, and
    each launch on the design the table names (``launches_split``, or
    ``launches_thread`` where ``sweep_cuda.THREAD_F64`` names the
    instance: float64 rank 8, where the split design falls into local
    memory; none on kernel 6's warp instance or kernel 8's runtime-d
    one)."""
    args = [a.to(card) for a in _inputs(r, s, c, seed=10 * s + c + r,
                                        dtype=dtype)]
    kern = getattr(sweep_cuda, f"{stem}_cuda")
    other = "launches_warp" if stem == _SWEEPS[0] else "launches_rt"
    design = f"launches_{sweep_cuda._elim_design(stem, dtype, r, c)}"
    with torch.no_grad():
        n, n_design, n_other = (kern.launches, getattr(kern, design),
                                getattr(kern, other))
        got = kern(*args, _JITTER)
        again = kern(*args, _JITTER)
        torch.cuda.synchronize()
        assert (kern.launches - n, getattr(kern, design) - n_design,
                getattr(kern, other) - n_other) == (2, 2, 0)
        ref = getattr(sweep_cuda, f"{stem}_plain")(*args, _JITTER)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    _close(got, [b.cpu() for b in ref], *_bars(dtype),
           f"{stem}, rank {r}, {dtype}")
