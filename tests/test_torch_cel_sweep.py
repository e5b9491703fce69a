"""PyTorch port vs the JAX package: the two likelihood sweeps that run one
warp per chunk lane on csrc/rtcoop.cuh's `Sweep` -- kernel 12, celerite's
fused likelihood sweep (csrc/celerite_sweep.cu, warp per lane at nblocks
5-8 and at d = 16), and kernel 16, the wide likelihood sweep
(csrc/wide_sweep.cu).

On the CPU each wrapper runs its plain twin, held here against the JAX
package's XLA route: kernel 12's twin at nblocks 5 and 8 against the
closed-form K of ``leg._k_gap_parts_xla`` eliminated by
``partitioned._forward_sweep``, and kernel 16's twin at its edge shapes
(s = 3; C = 1 and 9; d = 9 and 15) against ``partitioned._forward_sweep``
on the same blocks in the dense layout.  The kernels against their twins
run only on a card (marked ``cuda``, skipped here).  The JAX package is
imported inside the reference helpers, so the card tests collect without
it: ``python -m pytest --noconftest tests/test_torch_cel_sweep.py -q -m
cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.convert import (NumpyCeleriteParams,
                                          celerite_params_from_jax)
from cyclic_gps_tpu_torch.models import celerite, leg
from cyclic_gps_tpu_torch.ops import celerite_cuda, wide_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import wideblock as wb

torch.set_num_threads(1)

# kernel 12's case: s = 32, n = 200 gives C = 7 chunks, the last holding 8
# rows and 24 padding rows (masked gaps, unobserved rows)
_S, _N = 32, 200
# kernel 16's edge shapes (d, C) at s = 3: a lone lane and a ragged second
# tile of 8 (float32) or 4 (float64) lanes
_EDGES = ((9, 1), (9, 9), (15, 1), (15, 9))


def _params(nb, seed):
    """Celerite parameters (obs 1) with couplings, unequal rates and
    rotations, float32 values."""
    rng = np.random.RandomState(seed)
    arrays = (1.0 + 0.3 * rng.randn(2 * nb), 0.6 * rng.randn(nb),
              1.5 * rng.randn(nb), np.array([0.1]),
              0.5 * rng.randn(1, 2 * nb) + 0.2)
    return NumpyCeleriteParams(*(np.float32(a) for a in arrays))


def _series(n, seed):
    rng = np.random.RandomState(seed)
    return np.float32(np.cumsum(rng.exponential(0.5, n) + 0.05))


def _k12_inputs(nb, seed, device="cpu", dtype=np.float32):
    """Kernel 12's inputs as the precision route builds them in ``dtype``
    from float32 values, with a random right-hand side v [s, r, C]."""
    p = NumpyCeleriteParams(*(a.astype(dtype) for a in _params(nb, seed)))
    ts = _series(_N, seed + 1).astype(dtype)
    v = np.float32(np.random.RandomState(seed + 2).randn(
        _S, 2 * nb, -(-_N // _S))).astype(dtype)
    q = celerite_params_from_jax(p, device=device)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    with torch.no_grad():
        gb = celerite.g_blocks(q).contiguous()
        lam = leg.lambda_lambda_t(q)
        boost = (q.b.T @ torch.linalg.solve(lam, q.b)).contiguous()
        diffs, gv, real = leg._chunk_gap_geometry(
            torch.as_tensor(ts, device=device), _S, _N, v.shape[-1], tdt)
        wrap = celerite._wrap_row(gb, diffs, gv, _S)
    args = (gb, boost, diffs, gv, real, wrap,
            torch.as_tensor(v, device=device))
    return p, ts, v, args


def _jax_k12(p, ts, v, nb, dtype):
    """The JAX oracle of kernel 12: the closed-form K of
    leg._k_gap_parts_xla (row 0, the last coupling, the log|Q1| sum)
    eliminated by partitioned._forward_sweep, in ``dtype``."""
    import jax
    import jax.numpy as jnp
    from cyclic_gps_tpu.models import celerite as jcel
    from cyclic_gps_tpu.models import leg as jleg
    from cyclic_gps_tpu.ops import partitioned as jpt

    def f(jp, jts, v_cm):
        gb = jcel.g_blocks(jp)
        lam = jleg.lambda_lambda_t(jp)
        boost = jp.b.T @ jnp.linalg.solve(lam, jp.b)
        k_cm, off_cm, lq_cm = jleg._k_gap_parts_xla(
            jcel.gap_terms_from_blocks(gb), boost, jts, _S, False, 2 * nb,
            dtype)
        st, _, _ = jpt._forward_sweep(k_cm, off_cm, v_cm, 0.0, None)
        return (st.acc00, st.accy0, st.w0, st.w, st.dj, st.invd, st.mh,
                st.ld, jnp.sum(lq_cm), k_cm[0], off_cm[_S - 1])

    jp = jcel.CeleriteParams(*(jnp.asarray(a, dtype) for a in p))
    return [np.asarray(x, np.float64) for x in jax.jit(f)(
        jp, jnp.asarray(ts, dtype), jnp.asarray(v, dtype))]


def _close(got, ref, rtol, atol_of_scale, label):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got.detach().cpu(), dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_of_scale * np.max(np.abs(ref)),
                               err_msg=label)


@pytest.mark.parametrize("nb", [5, 8])
def test_celerite_sweep_twin_matches_jax(nb):
    """Kernel 12's plain twin at the widths of its warp-per-lane instance
    (nblocks 5, block size 10; nblocks 8, block size 16) against the JAX
    oracle on a ragged grid (n = 200, s = 32, C = 7) whose last chunk's
    padding rows are masked gaps (gv = 0) and unobserved rows (real = 0),
    on the same float32 values.  At float64 the two agree to rtol 1e-9
    and atol 1e-11 of each output's scale (one algorithm, other summation
    orders).  At float32 each output of the twin lies as close to the
    float64 oracle as the JAX package's own float32 run does: within 4x
    its error plus 1e-6 of the output's scale.  (A fixed float32 bar
    between the two does not hold: small gaps make K ill-conditioned, and
    at nblocks 5 the float32 accy0 of the twin and of JAX differ by
    1.5e-4 of its scale while each lies within 7e-5 of the float64
    value.)"""
    p, ts, v, args = _k12_inputs(nb, seed=40 + nb)
    gv, real = args[3], args[4]
    assert bool((gv[:, -1] == 0).any()) and bool((real[:, -1] == 0).any())
    p64, ts64, v64, args64 = _k12_inputs(nb, seed=40 + nb, dtype=np.float64)
    with torch.no_grad():
        got32 = celerite_cuda.celerite_gap_mahal_sweep_plain(*args)
        got64 = celerite_cuda.celerite_gap_mahal_sweep_plain(*args64)
    ref64 = _jax_k12(p64, ts64, v64, nb, np.float64)
    ref32 = _jax_k12(p, ts, v, nb, np.float32)
    for i, (a, b) in enumerate(zip(got64, ref64)):
        _close(a, b, 1e-9, 1e-11, f"kernel 12 out {i}, nblocks {nb}, f64")
    for i, (a, b, j) in enumerate(zip(got32, ref64, ref32)):
        scale = np.max(np.abs(b))
        e_port = np.max(np.abs(a.double().numpy() - b))
        e_jax = np.max(np.abs(j - b))
        assert e_port <= 4.0 * e_jax + 1e-6 * scale, (
            f"kernel 12 out {i}, nblocks {nb}, f32: port {e_port:.3e}, "
            f"JAX {e_jax:.3e}, scale {scale:.3e}")


def _nat_cm(d, c, seed, dtype=torch.float64):
    """tests/test_wideblock.py's well-conditioned system on s = 3, C = c,
    chunk-major (R_cm, O_cm, y_cm)."""
    rng = np.random.RandomState(seed)
    n = 3 * c
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / d
    y = rng.randn(n, d)
    return pt._chunk_layout(*(torch.tensor(a, dtype=dtype)
                              for a in (diag, off, y)), 3)[:3]


@pytest.mark.parametrize("d,c", _EDGES)
def test_wide_sweep_twin_at_edge_shapes_matches_jax(d, c):
    """Kernel 16's plain twin on the wide pairs at s = 3 (the first row
    and one that carries) == JAX partitioned._forward_sweep on the same
    blocks in the dense layout, float64: the final state (acc, accy0, W0,
    w, D, 1/diag D) and the sums of ||w||^2 and log diag D.  rtol 1e-10,
    atol 1e-12 of each output's scale: the twin's blocked Cholesky sums
    in another order."""
    import jax.numpy as jnp
    from cyclic_gps_tpu.ops import partitioned as jpt

    R_cm, O_cm, y_cm = _nat_cm(d, c, seed=50 + d + c)
    wide = (*pt._to_wide_stack(R_cm), *pt._to_wide_stack(O_cm))
    (acc11, accst, accy0, w011, w0st, wl, d11, dst, invd, mh,
     ld) = wide_cuda.forward_sweep_wide_plain(*wide, y_cm)
    got = (wb.from_wide(acc11, accst), accy0, wb.from_wide(w011, w0st), wl,
           wb.from_wide(d11, dst), invd, mh, ld)
    st, _, _ = jpt._forward_sweep(*(jnp.asarray(t.numpy())
                                    for t in (R_cm, O_cm, y_cm)), 0.0, None)
    ref = (st.acc00, st.accy0, st.w0, st.w, st.dj, st.invd, st.mh, st.ld)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, 1e-10, 1e-12, f"kernel 16 out {i}, d {d}, C {c}")


# ---------------------------------------------------------------------------
# On a card: the kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _close_on_card(got, ref, tol):
    for a, b in zip(got, ref):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 15])
def test_wide_sweep_kernel_on_card(card, d):
    """Kernel 16 against its plain twin at s = 3, C = 1 and 9, float32
    and float64, one launch counted per call."""
    w = wide_cuda.forward_sweep_wide_cuda
    for c in (1, 9):
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            R_cm, O_cm, y_cm = (t.to(card) for t in _nat_cm(d, c, 60 + d,
                                                            dtype))
            args = (*pt._to_wide_stack(R_cm), *pt._to_wide_stack(O_cm),
                    y_cm)
            before = w.launches
            got = w(*args)
            torch.cuda.synchronize()
            assert w.launches == before + 1
            _close_on_card(got, wide_cuda.forward_sweep_wide_plain(*args),
                           tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 2, 4, 5, 8])
def test_celerite_sweep_kernel_on_card(card, nb):
    """Kernel 12's two designs against its twin on the ragged grid of
    `test_celerite_sweep_twin_matches_jax` (C = 7, masked gaps and
    unobserved rows in the last chunk): the routed call (one thread per
    lane below nblocks 5, one warp per lane from 5) and the warp design
    forced, each counted on ``launches_warp`` as it ran."""
    w = celerite_cuda.celerite_gap_mahal_sweep_cuda
    _, _, _, args = _k12_inputs(nb, seed=70 + nb, device=card)
    ref = celerite_cuda.celerite_gap_mahal_sweep_plain(*args)
    for warp in (False, True):
        before = w.launches_warp
        got = w(*args, warp=warp)
        torch.cuda.synchronize()
        took_warp = warp or nb >= celerite_cuda.SWEEP_WARP_NBLOCKS
        assert w.launches_warp == before + took_warp
        _close_on_card(got, ref, 1e-4)
