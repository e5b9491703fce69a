"""PyTorch port vs the JAX package: kernel 3, the K-system emission
(csrc/gap_emission.cu), and kernel 7 at ranks 1-8, the back-substitution
and Takahashi walk (csrc/backward_sweep.cu), on inputs that exercise their
designs.

Kernel 3 builds every gap in a thread of its own, in thread blocks of 32
chunk lanes by 7 rows, with one more row of threads building the gap above
the tile (whose d_left the tile's first K row needs; ``wrap`` at the first
tile).  Kernel 7 takes 32 chunk lanes a thread block (16 or 8 where its
shared memory is short): one warp runs the rows' chain in tiles of 3 rows
while three warps form the selected-inverse blocks of the tile before.  So the shapes
here hold C = 35 and 45 chunks (no multiple of 32), s = 9 rows (no
multiple of 7: a ragged last tile) and, for the walk, s = 2 (the seed row
alone) and s = 7 (two tiles of 3 rows and one of 0: the seed, a tile
boundary inside the chain and a ragged last tile).

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``k_system_pallas`` on
tests/test_torch_gap_kernels.py's mixed gaps,
``backward_solve_takahashi_pallas`` at float64) with the bars of tests/test_torch_emission.py and
tests/test_torch_grad.py.  The kernels against their twins, at ranks 1, 5
and 8, run only on a card (marked ``cuda``, skipped here); the JAX package
is imported inside the reference helpers, so the card tests collect
without it:
``python -m pytest --noconftest tests/test_torch_ksys_walk.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda

torch.set_num_threads(1)

_ROUNDS = (0, 1, 2, 3, 5, 7, 9)  # squaring rounds of the emission's gaps


def _generator(r, seed):
    """A seeded default-init LEG generator and its boost block, float32."""
    p = leg.init_params(r, 2, generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    with torch.no_grad():
        llt = leg.lambda_lambda_t(p)
        boost = p.b.T @ torch.linalg.solve(llt, p.b)
        return leg.g_matrix(p).contiguous(), boost.contiguous()


def _ksys_inputs(r, seed, s, c):
    """k_system's arguments: gaps that mix, in every 32 consecutive ones,
    ``_ROUNDS`` squaring rounds and both sides of the Van Loan branch
    (dt ||G/2|| = 0.9 and 1.1), each scaled by a seeded factor in [0.9, 1],
    every 7th gap and the last two padding (gv = 0), as
    tests/test_torch_gap_kernels.py builds them; a seeded point-validity
    mask and the wrap row of the gaps."""
    g, boost = _generator(r, seed)
    _, half, augn = expm_cuda._generator_norms(g.double())
    half, augn = float(half), float(augn)
    kinds = [3.92 * 2.0 ** (n - 0.5) / augn if n else 1.96 / augn
             for n in _ROUNDS] + [0.9 / half, 1.1 / half]
    rng = np.random.RandomState(seed)
    m = np.arange(s * c)
    dt = np.array(kinds)[m % len(kinds)] * rng.uniform(0.9, 1.0, s * c)
    gv = np.where(m % 7 == 6, 0.0, 1.0)
    gv[-2:] = 0.0
    dt, gv = (torch.as_tensor(a.reshape(s, c), dtype=torch.float32)
              for a in (dt, gv))
    real = torch.as_tensor((rng.rand(s, c) < 0.8).astype(np.float32))
    with torch.no_grad():
        wrap = leg._wrap_row(g, dt, gv, s).contiguous()
    return (g, boost, dt, gv, real, wrap)


def _walk_inputs(d, s, c, seed, dtype=torch.float64):
    """Kernel 7's inputs: kernel 6's four hat stacks (its twin, pivot
    jitter 1e-3) on a block-tridiagonal system diagonally dominant at
    every block size d (q q^T / d + 4 I on the diagonal, off-diagonal
    blocks randn / 2d), s rows by c chunks, then hat_W1, x_b, x_b_next,
    p00, p01, p10, p11 drawn from a numpy seed (scale 0.3)."""
    rng = np.random.RandomState(seed)
    n = s * c
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / (2 * d)
    y = rng.randn(n, d)
    R_cm, O_cm, y_cm, _ = pt._chunk_layout(
        *(torch.tensor(a, dtype=torch.float64) for a in (diag, off, y)), s)
    with torch.no_grad():
        stacks = sweep_cuda.forward_sweep_solveinv_plain(
            R_cm.contiguous(), O_cm.contiguous(), y_cm.contiguous(),
            1e-3)[8:12]
    extra = [torch.tensor(rng.randn(*shape) * 0.3) for shape in
             [(d, d, c), (d, c), (d, c)] + [(d, d, c)] * 4]
    return [t.to(dtype).contiguous() for t in list(stacks) + extra]


def _close(got, ref, rtol, atol_of_scale, label):
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a.detach().cpu(), dtype=np.float64)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol_of_scale * np.max(np.abs(b)),
                                   err_msg=f"{label} out {i}")


def _pallas(module, fn_name, args, c, key):
    """A TPU kernel in interpret mode on ``args``, computed once per test
    run (numpy outputs, chunk axis cut to ``c``: the TPU kernels pad C to
    their lane tile)."""
    import importlib

    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from torch_reference_cache import shared

    fn = getattr(importlib.import_module(f"cyclic_gps_tpu.ops.{module}"),
                 fn_name)

    def compute():
        with pltpu.force_tpu_interpret_mode():
            out = fn(*(jnp.asarray(a.numpy()) for a in args))
        return [np.asarray(o)[..., :c] for o in out]

    return shared(key, compute)


@pytest.mark.parametrize("r", [5, 8])
def test_ksys_twin_matches_pallas(r, no_persistent_cache_writes):
    """k_system_plain (kernel 3's twin) == k_system_pallas in interpret
    mode on the mixed gaps at s = 9, C = 35, all three outputs: rtol 1e-4,
    atol 1e-5 of each output's scale (the bar of
    tests/test_torch_emission.py, there absolute at unit scale; K ~ Q1^{-1}
    amplifies float32 rounding for small gaps)."""
    s, c = 9, 35
    args = _ksys_inputs(r, seed=r, s=s, c=c)
    with torch.no_grad():
        got = expm_cuda.k_system_cuda(*args)
    ref = _pallas("expm_pallas", "k_system_pallas", args, c, f"ksys_{r}")
    assert len(got) == len(ref) == 3
    _close(got, ref, 1e-4, 1e-5, f"rank {r}")


@pytest.mark.parametrize("s,c", [(2, 35), (7, 45)])
def test_walk_twin_matches_pallas(s, c, no_persistent_cache_writes):
    """backward_solve_takahashi_plain (kernel 7's twin) ==
    backward_solve_takahashi_pallas in interpret mode, float64, rank 5, on
    kernel 6's stacks with random boundary inputs, all five outputs: rtol
    1e-10, atol 1e-12 of each output's scale (the bar of
    tests/test_torch_grad.py: one algorithm, reassociated)."""
    args = _walk_inputs(5, s, c, seed=10 * s + c)
    with torch.no_grad():
        got = sweep_cuda.backward_solve_takahashi_cuda(*args)
    ref = _pallas("pallas_sweep", "backward_solve_takahashi_pallas", args, c,
                  f"walk_{s}_{c}")
    assert len(got) == len(ref) == 5
    _close(got, ref, 1e-10, 1e-12, f"s = {s}, C = {c}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrappers run their twins and count nothing."""
    k3 = expm_cuda.k_system_cuda
    k7 = sweep_cuda.backward_solve_takahashi_cuda
    before = (k3.launches, k3.launches_tiled, k7.launches,
              k7.launches_split, k7.launches_warp)
    with torch.no_grad():
        k3(*_ksys_inputs(2, seed=0, s=3, c=4))
        k7(*_walk_inputs(2, 3, 4, seed=0))
    assert (k3.launches, k3.launches_tiled, k7.launches, k7.launches_split,
            k7.launches_warp) == before


# ---------------------------------------------------------------------------
# On the card: the kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", [(9, 35), (7, 45), (128, 64), (2, 1)])
def test_ksys_on_card(card, r, s, c):
    """Kernel 3 == its twin on the mixed gaps, all three outputs (rtol
    1e-3, atol 1e-4 of each output's scale, chip_smoke.py's bar), the same
    bits on a second run, and one launch of the tiled design each."""
    args = [a.to(card) for a in _ksys_inputs(r, seed=10 * r + s, s=s, c=c)]
    k3 = expm_cuda.k_system_cuda
    with torch.no_grad():
        n, n_tiled = k3.launches, k3.launches_tiled
        got = k3(*args)
        again = k3(*args)
        torch.cuda.synchronize()
        assert (k3.launches - n, k3.launches_tiled - n_tiled) == (2, 2)
        ref = expm_cuda.k_system_plain(*args)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    _close(got, [b.cpu() for b in ref], 1e-3, 1e-4, f"rank {r}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", [(2, 1), (3, 35), (7, 45), (128, 70)])
def test_walk_on_card(card, dtype, r, s, c):
    """Kernel 7 == its twin, all five outputs (rtol 1e-3, atol 1e-4 of each
    output's scale at float32, 1e-9 and 1e-10 at float64: chip_smoke.py's
    bars), the same bits on a second run, and one launch of the split
    design each."""
    args = [a.to(card) for a in _walk_inputs(r, s, c, seed=10 * s + c,
                                             dtype=dtype)]
    k7 = sweep_cuda.backward_solve_takahashi_cuda
    with torch.no_grad():
        n, n_split, n_warp = k7.launches, k7.launches_split, k7.launches_warp
        got = k7(*args)
        again = k7(*args)
        torch.cuda.synchronize()
        assert (k7.launches - n, k7.launches_split - n_split,
                k7.launches_warp - n_warp) == (2, 2, 0)
        ref = sweep_cuda.backward_solve_takahashi_plain(*args)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    rtol, atol = (1e-3, 1e-4) if dtype == torch.float32 else (1e-9, 1e-10)
    _close(got, [b.cpu() for b in ref], rtol, atol, f"rank {r}, {dtype}")
