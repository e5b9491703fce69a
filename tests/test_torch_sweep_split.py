"""PyTorch port vs the JAX package: the likelihood's sweep (kernel 1,
csrc/forward_sweep.cu) and the selected inversion's sweep (kernel 10,
csrc/inverse_sweep.cu) at ranks 1-8, on shapes that exercise their
design.

Both run csrc/pipeline.cuh's split sweep, the one of kernels 6 and 8
(tests/test_torch_elim_sweeps.py): lane groups of 32 chunk lanes (fewer
where shared memory is short), two to a thread block where they fit, each
with one warp running the elimination's carried part down tiles of 3 rows
and three warps that copy the rows in ahead of it and form each row's
outputs from what the chain parks -- for kernel 1 only its log-det and
its terms of the sums, for kernel 10 (no right-hand side) the raw factors
D, 1/diag D, C and W0.  Where the split design loses to one thread per
chunk lane (``sweep_cuda.THREAD_F64``), the wrappers launch that kernel.  So
the shapes hold C = 35 and 45 chunks (a ragged second lane group) and
s = 2 (one row), 4 (one tile) and 15 (five tiles, the ring wrapping); on
the card also C = 1 (a lone lane), s = 128 (the main path's chunk length)
and C = 70 (a ragged second block).

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``forward_sweep_pallas`` and
``forward_sweep_inverse_pallas``, float64, pivot jitter 1e-3) with the
bar of tests/test_torch_posterior.py.  The kernels against their twins,
at ranks 1, 5 and 8, and both designs at the ranks that have two, run
only on a card (marked ``cuda``, skipped here); the JAX package is
imported inside the reference helper, so the card tests collect without
it: ``python -m pytest --noconftest tests/test_torch_sweep_split.py -m
cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import _build, sweep_cuda
from test_torch_elim_sweeps import _CARD, _CPU, _JITTER, _bars, _inputs
from test_torch_ksys_walk import _close

torch.set_num_threads(1)

# kernel 1 and kernel 10 by the stem of their wrappers
_SWEEPS = ("forward_sweep", "forward_sweep_inverse")
# the four elimination sweeps, kernels 1, 6, 8 and 10
_ELIM = ("forward_sweep", "forward_sweep_solveinv", "forward_sweep_collect",
         "forward_sweep_inverse")


def _args(stem, ins):
    """The wrapper's inputs: kernel 10 has no right-hand side."""
    return ins[:2] if stem == "forward_sweep_inverse" else ins


def _pallas_sweep(stem, args, key):
    """The TPU kernel ``{stem}_pallas`` in interpret mode on ``args``,
    pivot jitter 1e-3, computed once per test run (numpy outputs, cut to
    the true chunk count: the TPU kernels pad C to their lane tile; kernel
    10's 1/diag D stack [s-1, d, 1, C] as the port's [s-1, d, C])."""
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
        out = [np.asarray(o)[..., :c] if np.ndim(o) else np.asarray(o)
               for o in out]
        if stem == "forward_sweep_inverse":
            out[5] = out[5][:, :, 0, :]
        return out

    return shared(key, compute)


@pytest.mark.parametrize("stem", _SWEEPS)
@pytest.mark.parametrize("s,c", _CPU)
def test_sweep_twin_matches_pallas(stem, s, c, no_persistent_cache_writes):
    """forward_sweep_plain (kernel 1's twin) and forward_sweep_inverse_plain
    (kernel 10's) == their TPU kernels in interpret mode, float64, rank 5,
    every output (kernel 1: the last state, mh, ld, ld_rows; kernel 10:
    acc00, the last state and the four raw-factor stacks): rtol 1e-10,
    atol 1e-12 of each output's scale (the bar of
    tests/test_torch_posterior.py)."""
    args = _args(stem, _inputs(5, s, c, seed=10 * s + c + len(stem)))
    with torch.no_grad():
        got = getattr(sweep_cuda, f"{stem}_cuda")(*args, _JITTER)
    ref = _pallas_sweep(stem, args, f"split_{stem}_{s}_{c}")
    assert len(got) == len(ref) == (9 if stem == _SWEEPS[0] else 8)
    assert got[-1].shape == ((s - 1, c) if stem == _SWEEPS[0]
                             else (s - 1, 5, 5, c))
    _close(got, ref, 1e-10, 1e-12, f"{stem}, s = {s}, C = {c}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the four elimination sweeps run their twins and
    count nothing, on no counter (the new ``launches_split`` of kernels 1
    and 10 and ``launches_thread`` of all four included)."""
    kerns = [getattr(sweep_cuda, f"{stem}_cuda") for stem in _ELIM]
    names = ("launches", "launches_split", "launches_thread")

    def counts():
        return [getattr(k, n) for k in kerns for n in names]

    before = counts()
    ins = _inputs(2, 3, 4, seed=0)
    with torch.no_grad():
        for stem, kern in zip(_ELIM, kerns):
            kern(*_args(stem, ins), _JITTER)
    assert counts() == before


def test_design_table_names_thread_instances_only():
    """The design table names only instances that have a thread-per-lane
    kernel (the four elimination sweeps, float64 at THREAD_RANKS), and
    `_elim_design` follows it: "thread" there from the table's chunk count
    on, "split" below it, at float32 and at every other rank 1..8, and no
    design at 9..16 (one instance there)."""
    for (stem, r), least in sweep_cuda.THREAD_F64.items():
        assert stem in _ELIM and r in _build.THREAD_RANKS and least >= 1
    for stem in _ELIM:
        for r in _build.RANKS:
            least = sweep_cuda.THREAD_F64.get((stem, r))
            for c in (1, 782, 4224, 4225, 7813, 8448, 8449, 15625):
                assert sweep_cuda._elim_design(stem, torch.float32, r,
                                               c) == "split"
                want = ("thread" if least is not None and c >= least
                        else "split")
                assert sweep_cuda._elim_design(stem, torch.float64, r,
                                               c) == want
        for d in (9, 15, 16):
            assert sweep_cuda._elim_design(stem, torch.float64, d, 1) is None


# ---------------------------------------------------------------------------
# On the card: the kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", _CARD)
@pytest.mark.parametrize("stem", _SWEEPS)
def test_sweep_on_card(card, stem, dtype, r, s, c):
    """Kernel 1 or 10 == its twin, every output, the same bits on a second
    run, and each launch on the design the table names (``launches_split``,
    or ``launches_thread`` where ``sweep_cuda.THREAD_F64`` names the
    instance), none on the runtime-d instance."""
    args = [a.to(card) for a in _args(stem, _inputs(
        r, s, c, seed=10 * s + c + r, dtype=dtype))]
    kern = getattr(sweep_cuda, f"{stem}_cuda")
    design = f"launches_{sweep_cuda._elim_design(stem, dtype, r, c)}"
    with torch.no_grad():
        n, n_design, n_rt = (kern.launches, getattr(kern, design),
                             kern.launches_rt)
        got = kern(*args, _JITTER)
        again = kern(*args, _JITTER)
        torch.cuda.synchronize()
        assert (kern.launches - n, getattr(kern, design) - n_design,
                kern.launches_rt - n_rt) == (2, 2, 0)
        ref = getattr(sweep_cuda, f"{stem}_plain")(*args, _JITTER)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    _close(got, [b.cpu() if isinstance(b, torch.Tensor) else b
                 for b in ref], *_bars(dtype), f"{stem}, rank {r}, {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("r", _build.THREAD_RANKS)
@pytest.mark.parametrize("stem", _ELIM)
def test_both_designs_on_card(card, stem, r):
    """At the float64 ranks that have both designs, each of the four
    elimination sweeps launched on either (through the wrappers' own
    launcher, which counts nothing) == its twin, every output."""
    args = [a.to(card) for a in _args(stem, _inputs(
        r, 15, 45, seed=100 + r, dtype=torch.float64))]
    y = args[2] if len(args) > 2 else None
    kern = getattr(sweep_cuda, f"{stem}_cuda")
    with torch.no_grad():
        ref = getattr(sweep_cuda, f"{stem}_plain")(*args, _JITTER)
        for symbol in (f"cgt_{stem}", f"cgt_{stem}_thread"):
            n = (kern.launches, kern.launches_split, kern.launches_thread)
            got = sweep_cuda._elim_launch(stem, symbol, args[0], args[1], y,
                                          _JITTER)
            torch.cuda.synchronize()
            assert (kern.launches, kern.launches_split,
                    kern.launches_thread) == n
            _close(got, [b.cpu() if isinstance(b, torch.Tensor) else b
                         for b in ref], *_bars(torch.float64),
                   f"{stem}, rank {r}, {symbol}")


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(k for k in sweep_cuda.THREAD_F64
                                       if sweep_cuda.THREAD_F64[k] > 1))
@pytest.mark.parametrize("below", [True, False])
def test_table_bound_on_card(card, key, below):
    """Where the table's choice depends on the chunk count (float64 rank
    7), the wrapper at one chunk below the bound launches the split
    design and at the bound the thread-per-lane one, each == its twin
    (s = 2: one row)."""
    stem, r = key
    c = sweep_cuda.THREAD_F64[key] - below
    args = [a.to(card) for a in _args(stem, _inputs(
        r, 2, c, seed=c, dtype=torch.float64))]
    kern = getattr(sweep_cuda, f"{stem}_cuda")
    design = "launches_split" if below else "launches_thread"
    with torch.no_grad():
        n = getattr(kern, design)
        got = kern(*args, _JITTER)
        torch.cuda.synchronize()
        assert getattr(kern, design) == n + 1
        ref = getattr(sweep_cuda, f"{stem}_plain")(*args, _JITTER)
    _close(got, [b.cpu() if isinstance(b, torch.Tensor) else b
                 for b in ref], *_bars(torch.float64),
           f"{stem}, rank {r}, C = {c}")
