"""PyTorch port vs the JAX package: small-block algebra, cyclic
reduction, the partitioned engine, and the forward-sweep kernel's plain
twin (against the TPU kernel in interpret mode).

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.ops import cyclic_reduction as jcr
from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu.ops import smallblock as jsb
from cyclic_gps_tpu_torch.ops import cyclic_reduction as cr
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import smallblock as sb
from cyclic_gps_tpu_torch.ops import sweep_cuda

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _well_conditioned(n, d, seed):
    """SPD block-tridiagonal system (diagonally dominant), natural order."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / d
    v = rng.randn(n, d)
    return diag, off, v


def _dense(diag, off):
    n, d, _ = diag.shape
    J = np.zeros((n * d, n * d))
    for i in range(n):
        J[i * d:(i + 1) * d, i * d:(i + 1) * d] = diag[i]
    for i in range(n - 1):
        J[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = off[i]
        J[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = off[i].T
    return J


def _smallblock_ops(m, a, spd, y, yv):
    """Every element-major op of a smallblock module (either package's)
    on the same inputs, in a fixed order."""
    out = []
    for t1 in (False, True):
        for t2 in (False, True):
            out.append(m.matmul(a, a, t1, t2))
        out.append(m.matvec(a, yv, t1))
    for jitter in (0.0, 0.1):
        out.extend(m.cholesky(spd, jitter=jitter))
    L, inv = m.cholesky(spd)
    out += [m.solve_lower(L, inv, y), m.solve_lower_t(L, inv, y),
            m.solve_lower_vec(L, inv, yv), m.solve_lower_t_vec(L, inv, yv),
            m.tri_lower_inverse(L, inv), m.chol_log_diag_sum(L),
            m.chol_log_diag_rows(L), m.shift_up(a), m.shift_down(a),
            *m.shift_up_chol(L, inv), m.interleave(a, 2 * a),
            m.from_em(m.to_em(spd)), m.transpose(a), m.identity_like(a)]
    return out


@pytest.mark.parametrize("d", [1, 3, 5])
def test_smallblock_matches_jax(d):
    """Every element-major op == cyclic_gps_tpu.ops.smallblock at float64
    (rtol 1e-12)."""
    rng = np.random.RandomState(d)
    nb = 7
    a = rng.randn(d, d, nb)
    spd = np.einsum("ikb,jkb->ijb", a, a) + d * np.eye(d)[:, :, None]
    y = rng.randn(d, 4, nb)
    yv = rng.randn(d, nb)
    inputs = (a, spd, y, yv)
    got = _smallblock_ops(sb, *map(torch.as_tensor, inputs))
    ref = jax.jit(lambda *x: _smallblock_ops(jsb, *x))(
        *map(jnp.asarray, inputs))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12,
                                   atol=1e-14, err_msg=f"op {i}")


def test_cholesky_float32_pivot_floor():
    """At float32 a pivot that roundoff drives to <= 0 is floored at
    1e-6 a_jj, as in the JAX package (rtol 1e-6); float64 is unfloored."""
    a = np.array([[1.0, 1.0, 0.5], [1.0, 1.0, 0.5], [0.5, 0.5, 2.0]])
    a = np.repeat(a[:, :, None], 3, axis=2)
    a[1, 1, 1] = 1.0 - 1e-9  # negative-definite by roundoff
    a32 = a.astype(np.float32)
    L, inv = sb.cholesky(torch.as_tensor(a32))
    jL, jinv = jax.jit(jsb.cholesky)(jnp.asarray(a32))
    assert torch.isfinite(L).all() and torch.isfinite(inv).all()
    _close(L, jL, 1e-6)
    _close(inv, jinv, 1e-6)
    # the floored pivot: L[1, 1] = sqrt(1e-6 * a[1, 1])
    np.testing.assert_allclose(_np(L)[1, 1], np.sqrt(1e-6 * a32[1, 1]),
                               rtol=1e-6)


_CR_SIZES = (30, 31, 32, 33)


@pytest.fixture(scope="module")
def jax_cr_reference():
    """JAX cyclic_reduction.mahal_and_logdet at every size of the CR test,
    in one compiled program."""
    systems = [_well_conditioned(n, 3, seed=n) for n in _CR_SIZES]
    outs = jax.jit(lambda xs: [jcr.mahal_and_logdet(*x) for x in xs])(
        [tuple(map(jnp.asarray, x)) for x in systems])
    return {n: tuple(map(float, o)) for n, o in zip(_CR_SIZES, outs)}


@pytest.mark.parametrize("n", _CR_SIZES)
def test_cyclic_reduction_matches_jax_and_dense(n, jax_cr_reference):
    """CR (mahal, logdet) == JAX cyclic_reduction.mahal_and_logdet and the
    dense oracle; solve / logdet / inverse blocks == dense (rtol 1e-10)."""
    d = 3
    diag, off, v = _well_conditioned(n, d, seed=n)
    td, to, tv = map(torch.as_tensor, (diag, off, v))
    mh, ld = cr.mahal_and_logdet(td, to, tv)
    jmh, jld = jax_cr_reference[n]
    _close(mh, jmh, 1e-10)
    _close(ld, jld, 1e-10)

    J = _dense(diag, off)
    Jinv = np.linalg.inv(J)
    x_ref = np.linalg.solve(J, v.reshape(-1))
    _close(mh, v.reshape(-1) @ x_ref, 1e-10)
    _close(ld, np.linalg.slogdet(J)[1], 1e-10)

    dec = cr.decompose(td, to)
    _close(cr.solve(dec, tv).reshape(-1), x_ref, 1e-10, 1e-12)
    _close(cr.logdet(dec), np.linalg.slogdet(J)[1], 1e-10)
    _close(cr.mahal(dec, tv), v.reshape(-1) @ x_ref, 1e-10)
    _close(cr.logdet_direct(td, to), np.linalg.slogdet(J)[1], 1e-10)
    sd, so = cr.inverse_blocks(dec)
    sd_ref = np.stack([Jinv[i * d:(i + 1) * d, i * d:(i + 1) * d]
                       for i in range(n)])
    so_ref = np.stack([Jinv[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d]
                       for i in range(n - 1)])
    _close(sd, sd_ref, 1e-10, 1e-12)
    _close(so, so_ref, 1e-10, 1e-12)


_PT_CASES = [(n, jitter) for n in (250, 256) for jitter in (0.0, 1e-3)]


@pytest.fixture(scope="module")
def jax_pt_reference():
    """JAX partitioned.mahal_and_logdet(s=8, backend="xla") for every
    case of the partitioned test, plus the per-row pivot log-dets of the
    (256, 1e-3) case, in one compiled program."""
    systems = [tuple(map(jnp.asarray, _well_conditioned(n, 3, seed=n + 7)))
               for n, _ in _PT_CASES]

    def all_cases(systems):
        outs = [jpt.mahal_and_logdet(*x, s=8, jitter=j, backend="xla")
                for x, (_, j) in zip(systems, _PT_CASES)]
        R, O, y, _ = jpt._chunk_layout(*systems[-1], 8)
        return outs, jpt._forward_sweep(R, O, y, 1e-3, "ldrows")[2]

    outs, rows = jax.jit(all_cases)(systems)
    return dict(zip(_PT_CASES, outs)), np.asarray(rows)


@pytest.mark.parametrize("n,jitter", _PT_CASES)
def test_partitioned_matches_jax(n, jitter, jax_pt_reference):
    """Partitioned (mahal, logdet), natural and chunk-major entries, and
    the per-row pivot log-dets == JAX partitioned at float64, d = 3,
    s = 8 (rtol 1e-10)."""
    d, s = 3, 8
    diag, off, v = _well_conditioned(n, d, seed=n + 7)
    td, to, tv = map(torch.as_tensor, (diag, off, v))
    jmh, jld = jax_pt_reference[0][n, jitter]

    mh, ld = pt.mahal_and_logdet(td, to, tv, s=s, jitter=jitter)
    _close(mh, jmh, 1e-10)
    _close(ld, jld, 1e-10)

    R, O, y, _ = pt._chunk_layout(td, to, tv, s)
    mh_cm, ld_cm = pt.mahal_and_logdet_cm(R, O, y, jitter)
    _close(mh_cm, jmh, 1e-10)
    _close(ld_cm, jld, 1e-10)
    if (n, jitter) == _PT_CASES[-1]:
        _, _, rows = pt._forward_sweep(R, O, y, jitter, collect="ldrows")
        _close(rows, jax_pt_reference[1], 1e-10)


def test_kernel_route_ladder_matches_plain():
    """The kernel route of the partitioned ladder (every sweep through
    the forward-sweep wrapper, whose CPU fallback is the kernel's plain
    twin) == the plain engine, with and without jitter, and == cyclic
    reduction without jitter (the two engines regularise different pivot
    blocks), at float64 on a system deep enough for two sweep levels
    (N = 3000, s = 8 -> 375 -> 12) (rtol 1e-10)."""
    d = 3
    diag, off, v = _well_conditioned(3000, d, seed=5)
    td, to, tv = map(torch.as_tensor, (diag, off, v))
    before = sweep_cuda.forward_sweep_cuda.launches
    for jitter in (0.0, 1e-3):
        mh_k, ld_k = pt._mahal_and_logdet_impl(td, to, tv, 8, jitter, "cuda")
        mh_p, ld_p = pt._mahal_and_logdet_impl(td, to, tv, 8, jitter,
                                               "torch")
        _close(mh_k, mh_p, 1e-10)
        _close(ld_k, ld_p, 1e-10)
    mh_c, ld_c = cr.mahal_and_logdet(td, to, tv)
    mh_p, ld_p = pt._mahal_and_logdet_impl(td, to, tv, 8, 0.0, "torch")
    _close(mh_p, mh_c, 1e-10)
    _close(ld_p, ld_c, 1e-10)
    # CPU tensors never launch the kernel
    assert sweep_cuda.forward_sweep_cuda.launches == before


def test_forward_sweep_plain_matches_pallas():
    """forward_sweep_plain (the CUDA kernel's twin) == the TPU kernel
    pallas_sweep.forward_sweep_pallas in interpret mode, all nine
    outputs, on the fixture of tests/test_chunked.py (d = 3, s = 8,
    n = 256, float32, with pivot jitter 1e-3; that test's
    tolerances)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep

    d, s, n, jitter = 3, 8, 256, 1e-3
    diag, off, v = _well_conditioned(n, d, seed=0)
    diag, off, v = (x.astype(np.float32) for x in (diag, off, v))
    jR, jO, jy, _ = jpt._chunk_layout(jnp.asarray(diag), jnp.asarray(off),
                                      jnp.asarray(v), s)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_sweep.forward_sweep_pallas(jR, jO, jy, jitter=jitter)
    got = sweep_cuda.forward_sweep_cuda(
        *(torch.as_tensor(np.asarray(x)) for x in (jR, jO, jy)), jitter)
    names = ("acc00", "accy0", "w0_last", "w_last", "d_last", "invd_last",
             "mh", "ld", "ld_rows")
    for name, a, b in zip(names, got, ref):
        assert a.dtype == torch.float32, name
        if name in ("mh", "ld"):
            _close(a, b, 1e-5)
        elif name == "ld_rows":
            _close(a, b, 0.0, 1e-5)
        else:
            _close(a, b, 0.0, 1e-4)
