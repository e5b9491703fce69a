"""PyTorch port vs the JAX package: the wide layout (8 < d < 16).

The torch copy of ops/wideblock.py against the JAX helpers; the natural
`partitioned.mahal_and_logdet` on the wide route (the plain twins of
kernels 16, 21 and 22, ops/wide_cuda.py) and its analytic gradient; a
wide level of the reduced ladder; celerite's filter route at nblocks 5, 6
and 7, whose boundary chain takes the wide route; and the wide wrappers'
own size check.

Inputs are made with numpy from fixed seeds, float32-representable, so
one float64 JAX reference (the plain XLA route, which
tests/test_wideblock.py holds equal to the wide Pallas kernels) serves the
float64 and the float32 comparisons; the references are computed once per
test run and shared between the xdist workers
(tests/torch_reference_cache.py).  "cuda" routes resolve every backend but
"torch" to "cuda" on CPU tensors: the wide route's glue then runs with
each kernel's plain twin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.models import celerite as jcel
from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu.ops import wideblock as jwb
from cyclic_gps_tpu_torch.convert import (NumpyCeleriteParams,
                                          celerite_params_from_jax)
from cyclic_gps_tpu_torch.models import celerite
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import wide_cuda
from cyclic_gps_tpu_torch.ops import wideblock as wb
from torch_reference_cache import shared

torch.set_num_threads(1)

_WRAPPERS = (wide_cuda.forward_sweep_wide_cuda,
             wide_cuda.forward_sweep_solveinv_wide_cuda,
             wide_cuda.backward_solve_takahashi_wide_cuda)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _f32(*arrays):
    """float32-representable float64 copies."""
    return tuple(np.float32(a).astype(np.float64) for a in arrays)


def _to_cuda_route(monkeypatch):
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")


def _spy_wide(monkeypatch):
    """Record the chunk count of every wide sweep call (the wrappers are
    looked up on the module at each call)."""
    seen = []
    for name in ("forward_sweep_wide_cuda",
                 "forward_sweep_solveinv_wide_cuda"):
        fn = getattr(wide_cuda, name)
        monkeypatch.setattr(
            wide_cuda, name,
            lambda *a, _f=fn, _n=name, **k: seen.append(
                (_n, a[0].shape[-1])) or _f(*a, **k))
    return seen


# ---------------------------------------------------------------------------
# ops/wideblock.py against the JAX helpers.
# ---------------------------------------------------------------------------


def _batch(d, c, seed, spd=False):
    x = np.random.RandomState(seed).randn(d, d, c)
    if spd:
        x = np.einsum("ijc,kjc->ikc", x, x) / d + 3 * np.eye(d)[:, :, None]
    return x


def _wideblock_outputs(lib, as_array, p, a, b, y):
    """Every wideblock helper on the same inputs, as dense arrays."""
    pw, aw, bw = lib.to_wide(p), lib.to_wide(a), lib.to_wide(b)
    y1, y2 = y[:8], y[8:]
    L11, Lst, i1, i2, ld = lib.wchol(*pw)
    dw = (L11, Lst, i1, i2)
    out = {
        "roundtrip": lib.from_wide(*aw),
        "transpose": lib.from_wide(*lib.wtranspose(*aw)),
        "add": lib.from_wide(*lib.wadd(*aw, *bw)),
        "sub": lib.from_wide(*lib.wsub(*aw, *bw)),
        "scale": lib.from_wide(*lib.wscale(*aw, 0.5)),
        "parts": lib.parts(lib.build(*lib.parts(aw[1]))),
        "mm": lib.from_wide(*lib.wmm(*aw, *bw)),
        "mm_tn": lib.from_wide(*lib.wmm_tn(*aw, *bw)),
        "mm_nt": lib.from_wide(*lib.wmm_nt(*aw, *bw)),
        "mv": lib.wmv(*aw, y1, y2),
        "mv_t": lib.wmv_t(*aw, y1, y2),
        "chol": lib.from_wide(L11, Lst),
        "invd": (i1, i2),
        "logdet": ld,
        "solve_lower": lib.from_wide(*lib.wsolve_lower(*dw, *bw)),
        "solve_lower_t": lib.from_wide(*lib.wsolve_lower_t(*dw, *bw)),
        "solve_lower_vec": lib.wsolve_lower_vec(*dw, y1, y2),
        "solve_lower_t_vec": lib.wsolve_lower_t_vec(*dw, y1, y2),
    }
    return {k: [as_array(t) for t in (v if isinstance(v, tuple) else (v,))]
            for k, v in out.items()}


@pytest.mark.parametrize("d", [9, 12, 15])
def test_wideblock_helpers_match_jax(d):
    """to_wide / from_wide, parts / build, the transpose, sum, difference
    and scaling, the three products, both matrix-vector products, the
    blocked Cholesky and the four triangular solves == the JAX wideblock
    helpers at float64 (atol 1e-10; the
    log-determinant is a per-lane sum here and a batch sum there)."""
    c = 5
    inputs = (_batch(d, c, d, spd=True), _batch(d, c, d + 1),
              _batch(d, c, d + 2), np.random.RandomState(d + 3).randn(
                  d, 1, c))
    ref = shared(f"wideblock_{d}", lambda: jax.jit(
        lambda *a: _wideblock_outputs(jwb, lambda t: t, *a))(
            *map(jnp.asarray, inputs)))
    got = _wideblock_outputs(wb, _np, *map(torch.as_tensor, inputs))
    assert got.keys() == ref.keys()
    got["logdet"] = [np.sum(got["logdet"][0])]
    for key in ref:
        for a, b in zip(got[key], ref[key]):
            _close(a, b, 0.0, 1e-10, err_msg=key)


# ---------------------------------------------------------------------------
# The natural mahal_and_logdet on the wide route.
# ---------------------------------------------------------------------------


def _nat_system(n, d, seed):
    """tests/test_wideblock.py's well-conditioned system (q q^T / d + 4 I,
    off / d), float32-representable."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, d, d)
    return _f32(q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d),
                rng.randn(n - 1, d, d) / d, rng.randn(n, d))


@functools.lru_cache(maxsize=None)
def _jax_mahal(s, jitter, grad):
    """jit of the JAX mahal_and_logdet (backend="xla"), float64; with
    ``grad`` also the gradient of 0.3 mh + 0.7 ld in (diag, off, y)."""
    def f(diag, off, y):
        mh, ld = jpt.mahal_and_logdet(diag, off, y, s=s, jitter=jitter,
                                      backend="xla")
        return 0.3 * mh + 0.7 * ld, (mh, ld)

    if not grad:
        return jax.jit(lambda *a: f(*a)[1])
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))


def _mahal_reference(d, n, s, jitter, grad):
    """((mh, ld), grads | None) of the JAX XLA route, once per run."""
    system = _nat_system(n, d, seed=d)
    out = shared(f"wide_mahal_{d}_{n}_{s}_{jitter}_{grad}",
                 lambda: _jax_mahal(s, jitter, grad)(
                     *map(jnp.asarray, system)))
    if grad:
        (_, vals), grads = out
        return vals, grads
    return out, None


def _port_mahal(system, s, jitter, dtype, grad=False):
    """The port's mahal_and_logdet on the inputs cast to ``dtype``; with
    ``grad`` also the gradient of 0.3 mh + 0.7 ld (diag symmetrised)."""
    ts = [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in system]
    mh, ld = pt.mahal_and_logdet(*ts, s=s, jitter=jitter)
    if not grad:
        return (mh, ld), None
    g = torch.autograd.grad(0.3 * mh + 0.7 * ld, ts)
    return (mh, ld), (0.5 * (g[0] + g[0].transpose(1, 2)), g[1], g[2])


@pytest.mark.parametrize("d,n,jitter", [
    (9, 96, 0.0),     # clean chunking; with the gradient
    (12, 90, 1e-3),   # chunk-pad tail + jitter path
])
def test_mahal_wide_route_matches_jax(d, n, jitter, monkeypatch):
    """The natural mahal_and_logdet on the forced "cuda" route (kernel
    16's plain twin at the top level, s = 8) and the forward-only
    `mahal_and_logdet_wide` on its layout == the JAX XLA route: rtol
    1e-10 at float64, and at float32 the bars of
    tests/test_wideblock.py:test_wide_mahal_matches_xla (mh rtol 2e-4,
    ld rtol 2e-5).  The cases are that test's.  At d = 9 also the
    analytic gradient of 0.3 mh + 0.7 ld (kernels 21 and 22's twins) ==
    jax.grad of the XLA route, the diag-block cotangents symmetrised:
    rtol 1e-8, atol 1e-10 (the bars of test_wide_mahal_gradient).  No
    kernel launches."""
    grad = (d, n) == (9, 96)
    (mh_ref, ld_ref), g_ref = _mahal_reference(d, n, 8, jitter, grad)
    system = _nat_system(n, d, seed=d)
    _to_cuda_route(monkeypatch)
    seen = _spy_wide(monkeypatch)
    before = [w.launches for w in _WRAPPERS]
    (mh, ld), g = _port_mahal(system, 8, jitter, torch.float64, grad)
    _close(mh, mh_ref, 1e-10)
    _close(ld, ld_ref, 1e-10)
    if grad:
        sym = np.asarray(g_ref[0])
        sym = 0.5 * (sym + sym.transpose(0, 2, 1))
        for name, a, b in zip(("diag", "off", "y"), g, (sym, *g_ref[1:])):
            _close(a, b, 1e-8, 1e-10, err_msg=name)
    # the forward-only entry on the wide layout itself
    wide = pt._chunk_layout_wide(*map(torch.as_tensor, system), 8)[:5]
    for a, b in zip(pt.mahal_and_logdet_wide(*wide, jitter=jitter),
                    (mh_ref, ld_ref)):
        _close(a, b, 1e-10)
    (mh, ld), _ = _port_mahal(system, 8, jitter, torch.float32)
    assert mh.dtype == torch.float32
    _close(mh, mh_ref, 2e-4)
    _close(ld, ld_ref, 2e-5)
    c = -(-n // 8)
    assert seen == ([("forward_sweep_wide_cuda", c)]
                    + [("forward_sweep_solveinv_wide_cuda", c)] * grad
                    + [("forward_sweep_wide_cuda", c)] * 2)
    assert [w.launches for w in _WRAPPERS] == before


def test_wide_ladder_level_matches_jax(monkeypatch):
    """d = 12, n = 2,112 with the default chunk length (s = 32): the top
    level (C = 66) and the reduced ladder's first level (66 blocks, C = 3)
    both take the wide route, forward and backward.  Values == the JAX
    XLA route (rtol 1e-10, float64); the gradient == the port's plain
    chunk route (backend="torch"; rtol 1e-8, atol 1e-10)."""
    d, n = 12, 2112
    (mh_ref, ld_ref), _ = _mahal_reference(d, n, None, 0.0, grad=False)
    system = _nat_system(n, d, seed=d)
    (_, _), g_plain = _port_mahal(system, None, 0.0, torch.float64,
                                  grad=True)
    _to_cuda_route(monkeypatch)
    seen = _spy_wide(monkeypatch)
    (mh, ld), g = _port_mahal(system, None, 0.0, torch.float64, grad=True)
    _close(mh, mh_ref, 1e-10)
    _close(ld, ld_ref, 1e-10)
    for name, a, b in zip(("diag", "off", "y"), g, g_plain):
        _close(a, b, 1e-8, 1e-10, err_msg=name)
    assert seen == [("forward_sweep_wide_cuda", 66),
                    ("forward_sweep_wide_cuda", 3),
                    ("forward_sweep_solveinv_wide_cuda", 66),
                    ("forward_sweep_solveinv_wide_cuda", 3)]


# ---------------------------------------------------------------------------
# Celerite's filter route at nblocks 5-7: the boundary chain at d = 10-14.
# ---------------------------------------------------------------------------

# nblocks -> n: the boundary chain has ceil(n / 32) >= 64 blocks, so the
# natural entry takes its chunked (wide) branch, not the CR terminal;
# 2,017 is the smallest such n, 2,500 has a padded last boundary chunk
_CEL_CASES = {5: 2017, 6: 2500, 7: 2017}
_FIELDS = NumpyCeleriteParams._fields


def _cel_inputs(nb):
    """Structured parameters with couplings, unequal rates and rotations,
    and an irregular series, all float32-representable."""
    rng = np.random.RandomState(100 + nb)
    params = NumpyCeleriteParams(*_f32(
        1.0 + 0.3 * rng.randn(2 * nb), 0.6 * rng.randn(nb),
        1.5 * rng.randn(nb), np.array([0.1]), 0.5 * rng.randn(1, 2 * nb)
        + 0.2))
    n = _CEL_CASES[nb]
    ts, xs = _f32(np.cumsum(rng.exponential(0.5, n) + 0.05),
                  rng.randn(n, 1))
    return params, ts, xs


@functools.lru_cache(maxsize=None)
def _jax_filter_value_and_grad():
    return jax.jit(jax.value_and_grad(
        lambda p, t, x: jcel.log_likelihood_filter(p, t, x, backend="xla")))


def _port_filter(params, ts, xs, dtype):
    p = celerite_params_from_jax(NumpyCeleriteParams(*(
        a.astype(np.float32 if dtype == torch.float32 else np.float64)
        for a in params)), device="cpu")
    v = celerite.log_likelihood_filter(p, torch.as_tensor(ts),
                                       torch.as_tensor(xs).to(dtype))
    v.backward()
    return v.detach(), [getattr(p, k).grad for k in _FIELDS]


@pytest.mark.parametrize("nb", sorted(_CEL_CASES))
def test_celerite_filter_route_at_wide_nblocks(nb, monkeypatch):
    """log_likelihood_filter and its structured-parameter gradient at
    nblocks 5, 6 and 7 on the forced "cuda" route == the JAX filter route
    (backend="xla"): float64 (the plain filter, the boundary chain on the
    wide route's twins) at rtol 1e-10 on the value and rtol 1e-7 / atol
    1e-9 of the scale on gradients; float32 (the twins of kernels 13-15,
    then the wide route) at rtol 2e-5 and rtol 5e-3 / atol 5e-4 of the
    scale -- the bars of test_torch_celerite.py's route test."""
    params, ts, xs = _cel_inputs(nb)
    v_ref, g_ref = shared(
        f"wide_celerite_filter_{nb}",
        lambda: _jax_filter_value_and_grad()(
            jcel.CeleriteParams(*map(jnp.asarray, params)),
            jnp.asarray(ts), jnp.asarray(xs)))
    _to_cuda_route(monkeypatch)
    seen = _spy_wide(monkeypatch)
    for dtype, rtol_v, rtol_g, atol_g in ((torch.float64, 1e-10, 1e-7, 1e-9),
                                          (torch.float32, 2e-5, 5e-3, 5e-4)):
        v, g = _port_filter(params, ts, xs, dtype)
        assert v.dtype == dtype
        _close(v, v_ref, rtol_v, err_msg=str(dtype))
        for name, a, b in zip(_FIELDS, g, g_ref):
            _close(a, b, rtol_g, atol_g * np.max(np.abs(b)),
                   err_msg=f"{dtype} {name}")
    chain = -(-_CEL_CASES[nb] // 32)
    assert seen.count(("forward_sweep_wide_cuda", -(-chain // 32))) == 2
    assert seen.count(("forward_sweep_solveinv_wide_cuda",
                       -(-chain // 32))) == 2


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------


def _wrapper_calls(e):
    """Each wide wrapper with zero inputs at strip height 3e (d = 8 + e)."""
    z = torch.zeros
    s, c = 3, 2
    sweep = (z(s, 8, 8, c), z(s, 3 * e, 8, c), z(s, 8, 8, c),
             z(s, 3 * e, 8, c), z(s, 8 + e, c))
    pair = (z(8, 8, c), z(3 * e, 8, c))
    stack = (z(s - 1, 8, 8, c), z(s - 1, 3 * e, 8, c))
    back = (*stack, *stack, z(s - 1, 8 + e, c), *stack, *pair,
            z(8 + e, c), z(8 + e, c), pair, pair, pair, pair)
    return ((wide_cuda.forward_sweep_wide_cuda, sweep),
            (wide_cuda.forward_sweep_solveinv_wide_cuda, sweep),
            (wide_cuda.backward_solve_takahashi_wide_cuda, back))


def test_wide_wrappers_refuse_other_sizes():
    """The wide wrappers refuse d = 8 (e = 0), d = 16 (e = 8) and any
    strip height outside e = 1..7 with a ValueError naming the ROADMAP
    queue, before the CPU/CUDA branch; under grad mode an input that
    requires grad is refused first (`_build.check_no_grad`)."""
    for e in (0, 8, 9):
        for fn, args in _wrapper_calls(e):
            with pytest.raises(ValueError, match="ROADMAP"):
                fn(*args)
    for fn, args in _wrapper_calls(3):
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(args[0].clone().requires_grad_(), *args[1:])
