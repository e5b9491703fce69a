"""PyTorch port vs the JAX package: the solve, the per-row log-dets and the
selected inversion of the partitioned engine (values and analytic
gradients), the plain twins of the four posterior kernels against the TPU
kernels in interpret mode, and the LEG posterior and predictions on the
precision route.

Inputs are made with numpy from fixed seeds and handed to both packages.
"backend='cuda'" cases resolve every backend to "cuda" on CPU tensors, so
the kernel routes' glue runs with each kernel's plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.data.synthetic import generate_data as jgenerate_data
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu_torch.convert import params_from_jax
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import smallblock as sb
from cyclic_gps_tpu_torch.ops import sweep_cuda
from torch_reference_cache import shared

torch.set_num_threads(1)

_POSTERIOR_WRAPPERS = (sweep_cuda.forward_sweep_collect_cuda,
                       sweep_cuda.backward_substitute_cuda,
                       sweep_cuda.forward_sweep_inverse_cuda,
                       sweep_cuda.takahashi_backward_cuda)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _t(x):
    return torch.as_tensor(np.array(x))


def _to_cuda_route(monkeypatch, backend):
    if backend == "cuda":
        monkeypatch.setattr(pt, "resolve_backend", lambda b, t: "cuda")


def _natural(n, d, seed):
    """SPD block-tridiagonal system (diagonally dominant), natural order,
    float64 numpy: diag [n, d, d], off [n-1, d, d], y [n, d]."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / d
    return diag, off, rng.randn(n, d)


def _segments(n, off):
    """Three contiguous segments: their ids and a copy of ``off`` with the
    couplings across segment boundaries zeroed (block-diagonal J)."""
    cuts = (n // 3, 2 * n // 3)
    off = off.copy()
    for cut in cuts:
        off[cut - 1] = 0.0
    ids = np.searchsorted(np.asarray(cuts), np.arange(n), side="right")
    return off, ids.astype(np.int32)


def _chunk_major(diag, off, y, s=8):
    return tuple(np.asarray(a) for a in jpt._chunk_layout(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(y), s)[:3])


# ---------------------------------------------------------------------------
# The four kernels' plain twins against the TPU kernels (interpret mode).
# ---------------------------------------------------------------------------


def _takahashi_seeds(R, O, acc00, w0l, dl, invdl, jitter):
    """The chunk-level inputs of the Takahashi kernel, computed as
    partitioned._inverse_from_cm_pallas computes them (by the port's
    glue, which mirrors it line for line)."""
    mm = sb.matmul
    s, c = R.shape[0], R.shape[-1]
    w1 = sb.solve_lower(dl, invdl, sb.transpose(O[s - 1]))
    red_diag = R[0] - acc00 - sb.shift_down(mm(w1, w1, ta=True))
    red_off = -mm(w1, w0l, ta=True)
    p00, p01, p10, p11 = pt._boundary_blocks(red_diag, red_off, c, jitter,
                                             "torch")
    di = sb.tri_lower_inverse(dl, invdl)
    u0 = sb.solve_lower_t(dl, invdl, w0l)
    u1 = sb.solve_lower_t(dl, invdl, w1)
    return (p00, p01, p10, p11, mm(di, di, ta=True), u0, u1,
            *pt._sigma_bb_ut(p00, p01, p10, p11, u0, u1))


@pytest.mark.parametrize("n", [256, 250])  # 250: a padded last chunk
def test_posterior_kernel_twins_match_pallas(n):
    """The plain twins of kernels 8-11 == forward_sweep_collect_pallas,
    backward_substitute_pallas, forward_sweep_inverse_pallas and
    takahashi_backward_pallas in interpret mode, float64, d = 3, s = 8,
    pivot jitter 1e-3: every output, rtol 1e-10 (atol 1e-12).  Kernel 9
    runs on kernel 8's stacks with random boundary vectors, kernel 11 on
    kernel 10's stacks with the seeds `_inverse_from_cm_pallas` computes.
    The TPU kernels' stacks are sliced to the true chunk count C."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep as ps

    jitter = 1e-3
    R, O, y = _chunk_major(*_natural(n, 3, seed=n + 4))
    d, c = R.shape[1], R.shape[-1]
    jR, jO, jy = map(jnp.asarray, (R, O, y))
    rng = np.random.RandomState(n)
    hw1, xb, xbn = (rng.randn(*shape) for shape in
                    [(d, d, c), (d, c), (d, c)])
    with pltpu.force_tpu_interpret_mode():
        ref8 = ps.forward_sweep_collect_pallas(jR, jO, jy, jitter=jitter)
        ref8 = [np.asarray(b)[..., :c] if np.ndim(b) else np.asarray(b)
                for b in ref8]
        ref9 = ps.backward_substitute_pallas(
            *map(jnp.asarray, ref8[8:11] + [hw1, xb, xbn]))
        ref10 = ps.forward_sweep_inverse_pallas(jR, jO, jitter=jitter)
        stacks = [np.asarray(b)[..., :c] for b in ref10[4:]]
        seeds = [_np(a) for a in _takahashi_seeds(
            _t(R), _t(O), *map(_t, ref10[:4]), jitter)]
        ref11 = ps.takahashi_backward_pallas(*map(jnp.asarray,
                                                  stacks + seeds))
    stacks[1] = stacks[1][:, :, 0, :]  # invds [s-1, d, 1, C] -> [s-1, d, C]

    got8 = sweep_cuda.forward_sweep_collect_cuda(_t(R), _t(O), _t(y), jitter)
    got9 = sweep_cuda.backward_substitute_cuda(
        *map(_t, ref8[8:11] + [hw1, xb, xbn]))
    got10 = sweep_cuda.forward_sweep_inverse_cuda(_t(R), _t(O), jitter)
    got11 = sweep_cuda.takahashi_backward_cuda(*got10[4:],
                                               *(_t(a) for a in seeds))
    ref10 = list(ref10[:4]) + stacks
    for k, got, ref in ((8, got8, ref8), (9, [got9], [ref9]),
                        (10, got10, ref10), (11, got11, ref11)):
        assert len(got) == len(ref), k
        for i, (a, b) in enumerate(zip(got, ref)):
            b = np.asarray(b)[..., :c] if np.ndim(b) else b
            _close(a, b, 1e-10, 1e-12, err_msg=f"kernel {k} output {i}")


# ---------------------------------------------------------------------------
# The engine entries against JAX (backend="xla").
# ---------------------------------------------------------------------------

_ENGINE_NS = (256, 250, 40)  # 40: the cyclic-reduction terminal (n < 64)
_GRAD_N = 250
_S = 32  # one chunk level over C = 8 chunks, then cyclic reduction


def _engine_case(n):
    """The engine fixture: an SPD system that is block-diagonal over three
    segments (coupled inside each), their ids, and a solution cotangent."""
    diag, off, y = _natural(n, 3, seed=n + 9)
    off, ids = _segments(n, off)
    gv = np.random.RandomState(n + 1).randn(-(-n // _S) * _S, 3)
    return diag, off, y, ids, gv


def _engine_reference(n):
    """JAX (backend="xla", s = 32) references of the engine test at one n,
    compiled on first use: the chunk-major entries at n >= 64, with the
    three analytic gradients at n = 250 from the same traces (jax.vjp);
    cyclic reduction's solve, log-det and selected inverse and the
    sequential per-row log-dets at n = 40 (the entries' small-n branch).
    logdet_per_segment is JAX's segment sum of these per-row log-dets.
    Computed once per test run (`torch_reference_cache.shared`)."""
    from cyclic_gps_tpu.ops import cyclic_reduction as jcr

    def one(diag, off, y, gv):
        if n < 64:
            dec = jcr.decompose(diag, off)
            return dict(solve=jcr.solve(dec, y), logdet=jcr.logdet(dec),
                        inverse_blocks=jcr.inverse_blocks(dec),
                        logdet_rows=jpt._ld_rows_seq(diag, off, 0.0))
        R, O, Y, _ = jpt._chunk_layout(diag, off, y, _S)
        out = {"inverse_blocks_cm": jpt.inverse_blocks_cm(R, O)}
        fns = {"solve_cm": jpt.solve_cm,
               "logdet_rows_cm": lambda R, O, Y: jpt.logdet_rows_cm(
                   R, O, backend="xla"),
               "solve_and_ld_rows_cm": lambda R, O, Y:
                   jpt.solve_and_ld_rows_cm(R, O, Y, backend="xla")}
        cots = {"solve_cm": (gv, 0.3), "logdet_rows_cm": 0.7,
                "solve_and_ld_rows_cm": (gv, 0.7)}
        for key, fn in fns.items():
            out[key], vjp = jax.vjp(fn, R, O, Y)
            if n == _GRAD_N:
                ct = jax.tree.map(lambda c, o: jnp.broadcast_to(
                    jnp.asarray(c, o.dtype), o.shape), cots[key], out[key])
                out.setdefault("grads", []).append(vjp(ct))
        return out

    case = tuple(jnp.asarray(a) for i, a in enumerate(_engine_case(n))
                 if i != 3)
    return shared(f"posterior_engine_{n}", lambda: jax.jit(one)(*case))


@pytest.fixture(scope="module")
def jax_engine_reference():
    """n -> the JAX references of `_engine_reference`."""
    return _engine_reference


def _losses(gv):
    """The three scalar losses whose gradients are compared (the
    cotangents of the fixture's vjps): the solve (x and log|J|), the
    per-row log-dets with a constant row cotangent, and the fused solve +
    per-row log-dets."""

    def solve(R, O, Y):
        x, ld = pt.solve_cm(R, O, Y)
        return torch.sum(gv * x) + 0.3 * ld

    def rows(R, O, Y):
        return torch.sum(0.7 * pt.logdet_rows_cm(R, O))

    def fused(R, O, Y):
        x, r = pt.solve_and_ld_rows_cm(R, O, Y)
        return torch.sum(gv * x) + torch.sum(0.7 * r)

    return solve, rows, fused


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n", _ENGINE_NS)
def test_engine_entries_match_jax(n, backend, monkeypatch,
                                  jax_engine_reference):
    """solve_and_logdet (and its natural-layout recursion _solve_impl),
    logdet, inverse_blocks, logdet_rows, logdet_per_segment and (at
    n >= 64) solve_cm, inverse_blocks_cm,
    logdet_rows_cm and solve_and_ld_rows_cm == JAX at float64, d = 3,
    s = 32 (rtol 1e-10, atol 1e-12).  The natural-order entries are held
    against the JAX chunk-major entries they wrap (cyclic reduction at
    n = 40), logdet_per_segment against the segment sums of JAX's per-row
    log-dets, as the JAX function sums them.  The "cuda" route goes
    through the twins of kernels 1 and 8-11 and launches nothing on CPU
    tensors."""
    _to_cuda_route(monkeypatch, backend)
    diag, off, y, ids, _ = map(_t, _engine_case(n))
    ref = dict(jax_engine_reference(n))
    ref.pop("grads", None)
    if n >= 64:
        c = -(-n // _S)
        x_pad, ld = ref["solve_cm"]
        sd_pad, so_pad = ref["inverse_blocks_cm"]
        ref.update(solve=np.asarray(x_pad)[:n], logdet=ld,
                   inverse_blocks=(np.asarray(sd_pad)[:n],
                                   np.asarray(so_pad)[:n - 1]),
                   logdet_rows=np.asarray(ref["logdet_rows_cm"]).T.reshape(
                       c * _S)[:n])
    ref["logdet_per_segment"] = np.bincount(
        _np(ids), weights=np.asarray(ref["logdet_rows"]), minlength=3)
    before = [w.launches for w in _POSTERIOR_WRAPPERS]
    x_impl, ld_impl = pt._solve_impl(diag, off, y, _S, 0.0,
                                     pt.resolve_backend("auto", diag))
    _close(x_impl, ref["solve"], 1e-10, 1e-12)
    _close(ld_impl, ref["logdet"], 1e-10)
    x, ld = pt.solve_and_logdet(diag, off, y, s=_S)
    got = {"solve": x, "logdet": pt.logdet(diag, off, s=_S),
           "inverse_blocks": pt.inverse_blocks(diag, off, s=_S),
           "logdet_rows": pt.logdet_rows(diag, off, s=_S),
           "logdet_per_segment": pt.logdet_per_segment(diag, off, ids, 3,
                                                       s=_S)}
    _close(ld, ref["logdet"], 1e-10)
    if n >= 64:
        R, O, Y = map(_t, _chunk_major(*map(_np, (diag, off, y)), s=_S))
        got.update(solve_cm=pt.solve_cm(R, O, Y),
                   inverse_blocks_cm=pt.inverse_blocks_cm(R, O),
                   logdet_rows_cm=pt.logdet_rows_cm(R, O),
                   solve_and_ld_rows_cm=pt.solve_and_ld_rows_cm(R, O, Y))
    assert set(got) == set(ref)
    for key, value in got.items():
        pairs = zip(value, ref[key]) if isinstance(value, tuple) else [
            (value, ref[key])]
        for i, (a, b) in enumerate(pairs):
            _close(a, b, 1e-10, 1e-12, err_msg=f"{key} {i}")
    # the per-segment sums are each segment's own log-determinant
    for b in range(3):
        rows = np.flatnonzero(_np(ids) == b)
        _close(got["logdet_per_segment"][b],
               pt.logdet(diag[rows[0]:rows[-1] + 1], off[rows[0]:rows[-1]],
                         s=_S), 1e-10)
    assert [w.launches for w in _POSTERIOR_WRAPPERS] == before


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_gradients_match_jax(backend, monkeypatch,
                                    jax_engine_reference):
    """The analytic adjoints of solve_cm, logdet_rows_cm (constant row
    cotangent) and solve_and_ld_rows_cm == jax.grad through the JAX
    custom VJPs at float64, n = 250 (rtol 1e-9, atol 1e-12); a row
    cotangent that varies inside a coupled segment poisons the gradient
    with NaN (the validity guard)."""
    _to_cuda_route(monkeypatch, backend)
    diag, off, y, _, gv = _engine_case(_GRAD_N)
    R, O, Y = _chunk_major(diag, off, y, s=_S)
    for loss, ref in zip(_losses(_t(gv)),
                         jax_engine_reference(_GRAD_N)["grads"]):
        ins = [_t(a).requires_grad_() for a in (R, O, Y)]
        grads = torch.autograd.grad(loss(*ins), ins, allow_unused=True)
        for name, a, b in zip("ROy", grads, ref):
            a = torch.zeros(b.shape, dtype=torch.float64) if a is None else a
            _close(a, b, 1e-9, 1e-12, err_msg=f"{loss.__name__} d{name}")

    ins = [_t(a).requires_grad_() for a in (R, O)]
    rows = pt.logdet_rows_cm(*ins)
    w = torch.as_tensor(np.random.RandomState(3).randn(*rows.shape))
    g_R, g_O = torch.autograd.grad(torch.sum(w * rows), ins)
    assert torch.isnan(g_R).all() and torch.isnan(g_O).all()


# ---------------------------------------------------------------------------
# The model: posterior, intercast and predictions on the precision route.
# ---------------------------------------------------------------------------


def _jax_params(rank, obs, seed):
    """JAX LEGParams with a random full N (the default's normal G hides
    orientation bugs), made with numpy."""
    rng = np.random.RandomState(seed)
    ti, tl = np.tril_indices(rank), np.tril_indices(rank, -1)
    z = rng.randn(rank, rank)
    return jleg.LEGParams(*(jnp.asarray(a) for a in (
        rng.randn(len(ti[0])), ((z - z.T) * 0.2)[tl],
        (0.1 * np.eye(obs))[np.tril_indices(obs)],
        np.full((obs, rank), 0.5 / np.sqrt(rank)))))


def _jax_series(n, obs, spacing, seed):
    jts, jxs = jgenerate_data(n, obs, dtype=jnp.float64, spacing=spacing,
                              seed=seed)
    return jts, jxs, _t(jts), _t(jxs)


@pytest.mark.parametrize("n,spacing", [(72, "irregular"), (72, "regular"),
                                       (300, "irregular"),
                                       (300, "regular")])
def test_posterior_matches_jax(n, spacing, monkeypatch):
    """posterior_mean and insample_posterior(method="precision") == JAX's
    insample_posterior (whose mean is its posterior_mean's solve) at
    float64, rank 3 / obs 2 with a random full N (rtol 1e-9, atol 1e-11:
    entries are O(1), and those near zero carry the O(1) entries'
    rounding from two Pade-13 pipelines and eliminations summed in other
    orders; n = 72 and 300 take the chunk-major route with s = 32), on
    the plain route and then on the kernel route's glue."""
    jp = _jax_params(3, 2, seed=n)
    jts, jxs, ts, xs = _jax_series(n, 2, spacing, seed=n + 1)
    regular = spacing == "regular"
    ref = jleg.insample_posterior(jp, jts, jxs, regular=regular,
                                  method="precision")
    p = params_from_jax(jp)
    for backend in ("torch", "cuda"):
        _to_cuda_route(monkeypatch, backend)
        with torch.no_grad():
            mean = leg.posterior_mean(p, ts, xs, regular=regular,
                                      method="precision")
            got = leg.insample_posterior(p, ts, xs, regular=regular,
                                         method="precision")
        _close(mean, ref[0], 1e-9, 1e-11, err_msg=backend)
        for name, a, b in zip(("mean", "cov_diag", "cov_off"), got, ref):
            _close(a, b, 1e-9, 1e-11, err_msg=f"{backend} {name}")


def _intercast_fixture():
    """tests/test_models.py's element-major intercast fixture (n = 40
    irregular, rank 3, targets in all three regimes, boundary hits and
    gap-coincident targets), with numpy-made parameters."""
    jp = _jax_params(3, 2, seed=9)
    jts, jxs, ts, xs = _jax_series(40, 2, "irregular", seed=77)
    ts_np = np.asarray(jts)
    targets = np.sort(np.concatenate([
        ts_np[0] - np.asarray([3.0, 0.2]), [ts_np[0]],
        0.5 * (ts_np[:-1] + ts_np[1:])[::3], ts_np[7:9], [ts_np[-1]],
        ts_np[-1] + np.asarray([0.1, 5.0])]))
    return jp, jts, jxs, ts, xs, targets


def test_intercast_matches_jax_and_batched():
    """intercast == JAX intercast and == the port's per-target
    _intercast_batched on the fixture of tests/test_models.py, fed the
    same JAX posterior (rtol 1e-9, atol 1e-11)."""
    jp, jts, jxs, ts, xs, targets = _intercast_fixture()
    post = jleg.insample_posterior(jp, jts, jxs, method="precision")
    ref = jleg.intercast(jp, *post, jts, jnp.asarray(targets))
    p = params_from_jax(jp)
    args = [_t(a) for a in post] + [ts, _t(targets)]
    with torch.no_grad():
        got = leg.intercast(p, *args)
        oracle = leg._intercast_batched(p, *args)
    for a, b, c in zip(got, ref, oracle):
        _close(a, b, 1e-9, 1e-11)
        _close(a, c, 1e-9, 1e-11)


def test_intercast_geometry_matches_jax():
    """Every field of _intercast_geometry == JAX's exactly, on the fixture
    of tests/test_models.py (dual branch, P >= 2N: exact ties, repeated
    ties, targets outside the range) and on its sparse subset (the plain
    searchsorted branch)."""
    rng = np.random.RandomState(5)
    n = 37
    ts = np.cumsum(rng.rand(n) + 0.1)
    targets = np.sort(np.concatenate([
        ts[0] - np.asarray([2.0, 0.5]),
        np.sort(rng.rand(2 * n) * (ts[-1] - ts[0]) + ts[0]),
        ts[::5], [ts[3], ts[3]], ts[-1] + np.asarray([0.3, 4.0])]))
    assert targets.shape[0] >= 2 * n
    for tg in (targets, targets[::4]):
        got = leg._intercast_geometry(_t(ts), _t(tg), 1e-10)
        ref = jax.jit(jleg._intercast_geometry, static_argnums=2)(
            jnp.asarray(ts), jnp.asarray(tg), 1e-10)
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(_np(a), np.asarray(b),
                                          err_msg=f"field {i}")


def test_make_predictions_matches_jax(monkeypatch):
    """make_predictions(method="precision") with and without observation
    noise == JAX on the intercast fixture (rtol 1e-9, atol 1e-11), on the
    plain route and then on the kernel route's glue."""
    jp, jts, jxs, ts, xs, targets = _intercast_fixture()
    p = params_from_jax(jp)
    refs = [jleg.make_predictions(jp, jts, jxs, jnp.asarray(targets),
                                  include_obs_noise=noise,
                                  method="precision")
            for noise in (False, True)]
    for backend in ("torch", "cuda"):
        _to_cuda_route(monkeypatch, backend)
        for noise, ref in zip((False, True), refs):
            with torch.no_grad():
                got = leg.make_predictions(p, ts, xs, _t(targets),
                                           include_obs_noise=noise,
                                           method="precision")
            for a, b in zip(got, ref):
                _close(a, b, 1e-9, 1e-11,
                       err_msg=f"{backend} noise={noise}")


def test_posterior_method_routing(no_persistent_cache_writes):
    """"auto" resolves by dtype as in JAX; an unknown method raises
    ValueError; the smoother route, and float32 "auto" which resolves to
    it, == JAX's smoother posterior (tests/test_torch_smoother.py's
    reference: JAX insample_posterior(method="smoother") at float64;
    1e-10 of each output's scale at float64, 1e-4 at float32), and the
    precision route still runs."""
    from test_torch_smoother import _inputs, _port, smoother_reference

    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        assert (leg._resolve_posterior_method("auto", dtype)
                == jleg._resolve_posterior_method("auto", jdtype))
    with pytest.raises(ValueError):
        leg._resolve_posterior_method("nope", torch.float64)
    ref = smoother_reference()
    arrays, ts, xs = _inputs()
    for dtype, method, bar in (("float64", "smoother", 1e-10),
                               ("float32", "smoother", 1e-4),
                               ("float32", "auto", 1e-4)):
        p = _port(arrays, dtype)
        x = _t(xs).to(p.b.dtype)
        with torch.no_grad():
            got = leg.insample_posterior(p, _t(ts), x, method=method)
            mean = leg.posterior_mean(p, _t(ts), x, method=method)
        for name, a, b in zip(("mean", "cov_diag", "cov_off", "mean"),
                              got + (mean,), tuple(ref) + (ref[0],)):
            scale = np.max(np.abs(b))
            err = np.max(np.abs(_np(a).astype(np.float64) - b)) / scale
            assert err <= bar, (dtype, method, name, err)
    with torch.no_grad():
        mean = leg.posterior_mean(_port(arrays, "float32"), _t(ts),
                                  _t(xs).float(), method="precision")
    assert mean.shape == (ts.shape[0], 3) and torch.isfinite(mean).all()


def test_sample_from_prior():
    """Shapes, and the stationary marginal covariance of z is I (pooled
    second moment, atol 0.05), as tests/test_models.py checks."""
    p = leg.init_params(2, 1, generator=torch.Generator().manual_seed(6),
                        dtype=torch.float64, device="cpu")
    ts = torch.cumsum(torch.ones(200, dtype=torch.float64), 0)
    with torch.no_grad():
        zs, xs = leg.sample_from_prior(p, torch.Generator().manual_seed(7),
                                       ts, num=300)
    assert zs.shape == (300, 200, 2) and xs.shape == (300, 200, 1)
    z = _np(zs).reshape(-1, 2)
    np.testing.assert_allclose(z.T @ z / z.shape[0], np.eye(2), atol=0.05)
