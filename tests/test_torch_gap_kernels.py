"""PyTorch port vs the JAX package: kernel 5, the LEG emission adjoint
(csrc/gap_adjoint.cu), and kernel 4, the fused emission sweep
(csrc/gap_emission.cu), on inputs that exercise their designs.

Kernel 5 sorts each thread block's gaps by branch and squaring rounds,
stores the inputs of rounds 0-3 and recomputes deeper ones; kernel 4 takes
32 chunk lanes a thread block and walks their gaps in tiles of 3 rows.  So
the inputs here mix, in every 32 consecutive gaps, gaps of 0, 1, 2, 3, 5,
7 and 9 squaring rounds on both sides of the Van Loan branch, with padded
gaps (gv = 0), on C = 35 chunks of s = 7 gaps (neither a multiple of the
lanes per block nor of the tile's rows), at ranks 5 and 8.

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``k_system_adjoint_pallas``,
``gap_mahal_sweep_pallas``) with the bars of tests/test_torch_grad.py and
tests/test_torch_emission.py.  The kernels against their twins, at ranks
1, 5 and 8, run only on a card (marked ``cuda``, skipped here); the JAX
package is imported inside the reference helpers, so the card tests
collect without it:
``python -m pytest --noconftest tests/test_torch_gap_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda

torch.set_num_threads(1)

_S, _C = 7, 35
_ROUNDS = (0, 1, 2, 3, 5, 7, 9)  # squaring rounds of the fixture's gaps


def _generator(r, seed):
    """A seeded default-init LEG generator and its boost block, float32."""
    p = leg.init_params(r, 2, generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    with torch.no_grad():
        llt = leg.lambda_lambda_t(p)
        boost = p.b.T @ torch.linalg.solve(llt, p.b)
        return leg.g_matrix(p).contiguous(), boost.contiguous()


def _mixed_gaps(g, s, c, seed):
    """Chunk-major gaps dt [s, c] and validity gv [s, c], float32: gap
    m = j c + cc takes kind m mod len(kinds), so every 32 consecutive gaps
    hold each kind -- ``_ROUNDS`` squaring rounds, and gaps just inside
    and just outside the Van Loan branch (dt ||G/2|| = 0.9 and 1.1) --
    each scaled by a seeded factor in [0.9, 1].  The last chunk's last
    two gaps and every 7th gap are padding (gv = 0)."""
    _, half, augn = expm_cuda._generator_norms(g.double())
    half, augn = float(half), float(augn)
    kinds = [3.92 * 2.0 ** (n - 0.5) / augn if n else 1.96 / augn
             for n in _ROUNDS] + [0.9 / half, 1.1 / half]
    rng = np.random.RandomState(seed)
    m = np.arange(s * c)
    dt = np.array(kinds)[m % len(kinds)] * rng.uniform(0.9, 1.0, s * c)
    gv = np.where(m % 7 == 6, 0.0, 1.0)
    gv[-2:] = 0.0
    return (torch.as_tensor(dt.reshape(s, c), dtype=torch.float32),
            torch.as_tensor(gv.reshape(s, c), dtype=torch.float32))


def _adjoint_inputs(r, seed, s=_S, c=_C):
    """k_system_adjoint's arguments on `_mixed_gaps` with seeded per-gap
    cotangents."""
    g, _ = _generator(r, seed)
    dt, gv = _mixed_gaps(g, s, c, seed)
    rng = np.random.RandomState(seed + 1)
    cots = [torch.as_tensor(rng.randn(*shape).astype(np.float32))
            for shape in [(s, r, r, c)] * 3 + [(s, c)]]
    return (g, dt, gv, *cots)


def _sweep_inputs(r, seed, s=_S, c=_C):
    """gap_mahal_sweep's arguments on `_mixed_gaps`: the boost block, a
    seeded point-validity mask, the wrap row of the gaps and a seeded
    right-hand side."""
    g, boost = _generator(r, seed)
    dt, gv = _mixed_gaps(g, s, c, seed)
    rng = np.random.RandomState(seed + 2)
    real = torch.as_tensor((rng.rand(s, c) < 0.8).astype(np.float32))
    with torch.no_grad():
        wrap = leg._wrap_row(g, dt, gv, s).contiguous()
    y = torch.as_tensor(rng.randn(s, r, c).astype(np.float32))
    return (g, boost, dt, gv, real, wrap, y)


def _close(got, ref, rtol, atol_of_scale, label):
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a.detach().cpu(), dtype=np.float64)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol_of_scale * np.max(np.abs(b)),
                                   err_msg=f"{label} out {i}")


@pytest.mark.parametrize("r", [5, 8])
def test_mixed_gaps_cover_the_designs(r):
    """The fixture holds what the redesigns change: every round count of
    `_ROUNDS` (so rounds past the 4 stored ones are recomputed) and both
    branches inside one warp's 32 gaps, and padded gaps."""
    g, _ = _generator(r, r)
    dt, gv = _mixed_gaps(g, _S, _C, r)
    _, half, augn = expm_cuda._generator_norms(g.double())
    nsq = torch.clamp(torch.ceil(torch.log2(torch.clamp(
        dt.double() * augn / expm_cuda._THETA7, min=1.0))), 0,
        expm_cuda._MAXSQ).reshape(-1)
    vl = (dt.double() * half < 1.0).reshape(-1)
    warp = slice(32, 64)
    assert set(_ROUNDS) <= set(nsq[warp].int().tolist())
    assert bool(vl[warp].any()) and bool((~vl[warp]).any())
    assert 0.0 in gv and int(nsq.max()) >= 7


def _pallas(fn_name, args, key):
    """A TPU kernel of expm_pallas in interpret mode on ``args``, computed
    once per test run (numpy outputs, chunk axis cut to ``_C``)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import expm_pallas
    from torch_reference_cache import shared

    def compute():
        with pltpu.force_tpu_interpret_mode():
            out = getattr(expm_pallas, fn_name)(
                *(jnp.asarray(a.numpy()) for a in args))
        return [np.asarray(o)[..., :_C] if np.ndim(o) and
                np.shape(o)[-1] >= _C else np.asarray(o) for o in out]

    return shared(key, compute)


@pytest.mark.parametrize("r", [5, 8])
def test_adjoint_twin_matches_pallas(r, no_persistent_cache_writes):
    """k_system_adjoint_plain (kernel 5's twin) == k_system_adjoint_pallas
    in interpret mode on the mixed gaps: rtol 1e-3, atol 1e-4 of each
    output's scale (the bar of tests/test_torch_grad.py; the adjoint
    solves against chol(Q1), which amplifies float32 rounding by cond(Q1)
    for small gaps)."""
    args = _adjoint_inputs(r, seed=r)
    with torch.no_grad():
        got = expm_cuda.k_system_adjoint_cuda(*args)
    ref = _pallas("k_system_adjoint_pallas", args, f"gap_adjoint_{r}")
    assert len(got) == len(ref) == 3
    _close(got, ref, 1e-3, 1e-4, f"rank {r}")


@pytest.mark.parametrize("r", [5, 8])
def test_sweep_twin_matches_pallas(r, no_persistent_cache_writes):
    """gap_mahal_sweep_plain (kernel 4's twin) == gap_mahal_sweep_pallas in
    interpret mode on the mixed gaps, all 11 outputs: rtol 1e-4, atol 1e-5
    of each output's scale (the bar of tests/test_torch_emission.py, there
    absolute at unit scale)."""
    args = _sweep_inputs(r, seed=r)
    with torch.no_grad():
        got = expm_cuda.gap_mahal_sweep_cuda(*args)
    ref = _pallas("gap_mahal_sweep_pallas", args, f"gap_sweep_{r}")
    assert len(got) == len(ref) == 11
    _close(got, ref, 1e-4, 1e-5, f"rank {r}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrappers run their twins and count nothing."""
    k4 = expm_cuda.gap_mahal_sweep_cuda
    k5 = expm_cuda.k_system_adjoint_cuda
    before = (k4.launches, k4.launches_tiled, k5.launches,
              k5.launches_sorted)
    with torch.no_grad():
        k4(*_sweep_inputs(2, seed=0, s=3, c=4))
        k5(*_adjoint_inputs(2, seed=0, s=3, c=4))
    assert (k4.launches, k4.launches_tiled, k5.launches,
            k5.launches_sorted) == before


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
@pytest.mark.parametrize("s,c", [(7, 35), (6, 45)])
def test_adjoint_on_card(card, r, s, c):
    """Kernel 5 == its float64 twin on the mixed gaps (rtol 1e-3, atol 1e-4
    of each output's scale; c_dt cancels terms far larger than itself, so
    it is held against the float64 twin, as chip_smoke.py does), the same
    bits on a second run, and one launch of the sorted design each."""
    args = [a.to(card) for a in _adjoint_inputs(r, seed=10 * r + s, s=s, c=c)]
    k5 = expm_cuda.k_system_adjoint_cuda
    with torch.no_grad():
        n, n_sorted = k5.launches, k5.launches_sorted
        got = k5(*args)
        again = k5(*args)
        torch.cuda.synchronize()
        assert (k5.launches - n, k5.launches_sorted - n_sorted) == (2, 2)
        ref = expm_cuda.k_system_adjoint_plain(*[a.double() for a in args])
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    _close(got, [b.cpu() for b in ref], 1e-3, 1e-4, f"rank {r}")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", [(7, 35), (8, 64), (4, 1)])
def test_sweep_on_card(card, r, s, c):
    """Kernel 4 == its twin on the mixed gaps, all 11 outputs (rtol 1e-3,
    atol 1e-4 of each output's scale, chip_smoke.py's bar), with one
    launch of the tiled design."""
    args = [a.to(card) for a in _sweep_inputs(r, seed=10 * r + s, s=s, c=c)]
    k4 = expm_cuda.gap_mahal_sweep_cuda
    with torch.no_grad():
        n, n_tiled = k4.launches, k4.launches_tiled
        got = k4(*args)
        torch.cuda.synchronize()
        assert (k4.launches - n, k4.launches_tiled - n_tiled) == (1, 1)
        ref = expm_cuda.gap_mahal_sweep_plain(*args)
    _close(got, [b.cpu() for b in ref], 1e-3, 1e-4, f"rank {r}")
