"""PyTorch port vs the JAX package: the celerite family.

The closed-form oscillator gap terms, the plain conditional filter with
its collect pass and analytic adjoint (ops/chunked_filter.py), both
likelihood routes and their gradients in the structured parameters, the
plain twins of the four celerite kernels (ops/celerite_cuda.py) against
the JAX XLA oracles, three Adam steps against optax, and the guards.

Inputs are made with numpy from fixed seeds and handed to both packages;
float32 cases use float32-representable inputs, so one float64 JAX
reference serves the float64 and the float32 comparisons.  The JAX
references are computed once per test run and shared between the xdist
workers (tests/torch_reference_cache.py).  "cuda" routes resolve every
backend but "torch" to "cuda" on CPU tensors: the kernel routes' glue
then runs with each kernel's plain twin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclic_gps_tpu.models import celerite as jcel
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu.ops import chunked_filter as jcf
from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu_torch.baselines import dense
from cyclic_gps_tpu_torch.convert import (NumpyCeleriteParams,
                                          celerite_params_from_jax,
                                          celerite_params_to_numpy)
from cyclic_gps_tpu_torch.models import celerite, leg
from cyclic_gps_tpu_torch.ops import _build, celerite_cuda
from cyclic_gps_tpu_torch.ops import chunked_filter as cf
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.train import loop
from torch_reference_cache import shared

torch.set_num_threads(1)

_FIELDS = NumpyCeleriteParams._fields
_WRAPPERS = (celerite_cuda.celerite_gap_mahal_sweep_cuda,
             celerite_cuda.celerite_filter_cuda,
             celerite_cuda.celerite_filter_collect_cuda,
             celerite_cuda.celerite_filter_adjoint_cuda)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _params(nb, obs, seed):
    """Structured parameters with couplings, unequal rates and rotations
    (oscillating and overdamped blocks), rounded to float32 values."""
    rng = np.random.RandomState(seed)
    ti = np.tril_indices(obs)
    arrays = (1.0 + 0.3 * rng.randn(2 * nb), 0.6 * rng.randn(nb),
              1.5 * rng.randn(nb), (0.1 * np.eye(obs))[ti],
              0.5 * rng.randn(obs, 2 * nb) + 0.2)
    return NumpyCeleriteParams(*(np.float32(a).astype(np.float64)
                                 for a in arrays))


def _series(n, obs, seed):
    """Irregular float32-representable timestamps and observations."""
    rng = np.random.RandomState(seed)
    ts = np.cumsum(rng.exponential(0.5, n) + 0.05)
    xs = rng.randn(n, obs)
    return (np.float32(ts).astype(np.float64),
            np.float32(xs).astype(np.float64))


def _jparams(p):
    return jcel.CeleriteParams(*map(jnp.asarray, p))


def _port(p, dtype=torch.float64):
    return celerite_params_from_jax(NumpyCeleriteParams(*(
        a.astype(np.float32 if dtype == torch.float32 else np.float64)
        for a in p)), device="cpu")


def _grads(p):
    return [getattr(p, k).grad.detach().numpy() for k in _FIELDS]


def _value_and_grads(fn, p, ts, xs, **kw):
    for t in p.parameters():
        t.grad = None
    v = fn(p, ts, xs, **kw)
    v.backward()
    return float(v.detach()), _grads(p)


def _to_cuda_route(monkeypatch):
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")


def _launches():
    return [w.launches for w in _WRAPPERS]


# ---------------------------------------------------------------------------
# Structure, the expansion and its gradient.
# ---------------------------------------------------------------------------


def test_structure_expansion_and_gradient_flow():
    """parameter_count and the celerite masks of `expand` (G block-diagonal
    with 2x2 blocks, N on its structured positions only); the small-N
    route (expand + the LEG likelihood) == the dense float64 GP oracle
    (rtol 1e-10), and its gradient reaches every structured leaf, n_sub
    and r_sub included, through the expansion (a LEGView, not detached
    nn.Parameters)."""
    nb, obs = 3, 2
    p = celerite.init_params(nb, obs, generator=torch.Generator()
                             .manual_seed(0), dtype=torch.float64,
                             device="cpu")
    assert p.rank == 2 * nb and p.nblocks == nb and p.obs_dim == obs
    assert (sum(t.numel() for t in p.parameters())
            == celerite.parameter_count(nb, obs))
    q = _port(_params(nb, obs, 4))
    full = celerite.expand(q)
    mask = np.kron(np.eye(nb), np.ones((2, 2)))
    with torch.no_grad():
        g = _np(leg.g_matrix(full))
        n_mat = _np(leg.n_matrix(full))
        _close(celerite.g_blocks(q)[1], g[2:4, 2:4], 1e-14)
    assert np.allclose((g - np.diag(np.diag(g))) * (1 - mask), 0.0)
    allowed = np.eye(2 * nb) + np.diag(np.tile([1.0, 0.0], nb)[:-1], -1)
    assert np.allclose(n_mat * (1 - allowed), 0.0)

    ts, xs = map(_t, _series(40, obs, 5))
    ll, grads = _value_and_grads(celerite.log_likelihood, q, ts, xs)
    with torch.no_grad():
        ref = dense.log_marginal_likelihood_from_params(full, ts, xs)
    _close(ll, ref, 1e-10)
    for name, g_ in zip(_FIELDS, grads):
        assert np.all(np.isfinite(g_)) and np.any(g_ != 0.0), name


# ---------------------------------------------------------------------------
# The closed forms.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [2, 8])
def test_closed_forms_match_jax(nb):
    """_block_e_terms, _block_eq_terms and _block_gap_terms == JAX at
    float64 on gaps from 1e-4 to 1e2 that reach all three branches
    (series, hyperbolic, trigonometric): rtol 1e-12, atol 1e-13 of each
    output's scale (one formula, evaluated in another order)."""
    p = _params(nb, 1, nb)
    gb = celerite.g_blocks(_port(p)).detach()
    diffs = np.logspace(-4, 2, 97)
    _, _, al, be, ga = celerite._block_e_terms(gb, _t(diffs))
    q2 = _np(al * al + be * ga)
    cut2 = celerite._SERIES_CUT**2
    assert (q2 >= cut2).any() and (q2 <= -cut2).any()
    assert (np.abs(q2) < cut2).any()
    jgb = jcel.g_blocks(_jparams(p))
    _close(gb, jgb, 1e-14)
    for fn in ("_block_e_terms", "_block_eq_terms", "_block_gap_terms"):
        got = jax.tree.leaves(getattr(celerite, fn)(gb, _t(diffs)))
        ref = jax.tree.leaves(getattr(jcel, fn)(jgb, jnp.asarray(diffs)))
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(got, ref)):
            b = np.asarray(b)
            _close(a, b, 1e-12, 1e-13 * np.max(np.abs(b)),
                   err_msg=f"{fn} {i}")


# ---------------------------------------------------------------------------
# The plain conditional filter.
# ---------------------------------------------------------------------------


def _filter_fixture(s=6, c=5, r=4, qd=2, seed=0):
    """tests/test_chunked.py's conditional-filter fixture (numpy): random
    SPD noise, a valid mask with zeros, and invalid gaps carrying the
    exact no-op (e = I, q = 0)."""
    rng = np.random.RandomState(seed)
    e = rng.randn(s, c, r, r) * 0.3 + np.eye(r)
    q = rng.randn(s, c, r, r) * 0.2
    q = q @ q.transpose(0, 1, 3, 2) + 0.1 * np.eye(r)
    b = rng.randn(qd, r)
    lam = rng.randn(qd, qd) * 0.3
    lam = lam @ lam.T + 0.5 * np.eye(qd)
    y = rng.randn(s, c, qd)
    valid = (rng.rand(s, c) > 0.2).astype(float)
    gv = (rng.rand(s, c) > 0.15).astype(float)[:, :, None, None]
    e = e * gv + np.eye(r) * (1.0 - gv)
    q = q * gv
    return e, q, b, lam, y, valid


def test_plain_filter_matches_jax():
    """conditional_filter_plain, _collect_plain and _adjoint_plain == the
    JAX XLA twins on test_chunked.py's fixture (rtol = atol = 5e-12, the
    JAX adjoint-vs-autodiff bar), the differentiable conditional_filter's
    gradient == the JAX analytic adjoint, and boundary_loglik /
    boundary_loglik_em == JAX (rtol 1e-11)."""
    ins = _filter_fixture()
    rng = np.random.RandomState(99)
    em = lambda x: np.moveaxis(x, 0, -1)  # noqa: E731  [C, ...] -> [..., C]

    def jax_side(e, q, b, lam, y, valid, cots):
        out, hist = jcf.conditional_filter_collect_xla(e, q, b, lam, y,
                                                       valid)
        adj = jcf.conditional_filter_adjoint_xla(e, q, b, lam, y, valid,
                                                 hist, cots)
        stats_em = tuple(jnp.moveaxis(x, 0, -1) for x in out)
        return (jcf.conditional_filter_xla(e, q, b, lam, y, valid), out,
                hist, adj, jcf.boundary_loglik(out, 60.0),
                jcf.boundary_loglik_em(stats_em, 60.0))

    shapes = [o.shape for o in jcf.conditional_filter_xla(
        *map(jnp.asarray, ins))]
    cots = tuple(rng.randn(*sh) for sh in shapes)
    ref_out, ref_col, ref_hist, ref_adj, ref_bl, ref_ble = jax.jit(
        jax_side)(*map(jnp.asarray, ins), cots)

    t_ins = list(map(_t, ins))
    for a, b in zip(cf.conditional_filter_plain(*t_ins), ref_out):
        _close(a, b, 5e-12, 5e-12)
    out, hist = cf._collect_plain(*t_ins)
    for a, b in zip(tuple(out) + hist, tuple(ref_col) + tuple(ref_hist)):
        _close(a, b, 5e-12, 5e-12)
    got = cf._adjoint_plain(*t_ins, hist, tuple(map(_t, cots)))
    for name, a, b in zip(("e", "q", "B", "lam", "y"), got, ref_adj):
        _close(a, b, 5e-12, 5e-12, err_msg=name)

    leaves = [t.requires_grad_() for t in t_ins[:5]]
    res = cf.conditional_filter(*leaves, t_ins[5])
    loss = sum(torch.sum(_t(c) * o) for c, o in zip(cots, res))
    for name, a, b in zip(("e", "q", "B", "lam", "y"),
                          torch.autograd.grad(loss, leaves), ref_adj):
        _close(a, b, 5e-12, 5e-12, err_msg=name)

    with torch.no_grad():
        bl = cf.boundary_loglik(out, 60.0)
        ble = cf.boundary_loglik_em(tuple(_t(em(_np(x))) for x in out),
                                    60.0)
    _close(bl, ref_bl, 1e-11)
    _close(ble, ref_ble, 1e-11)


# ---------------------------------------------------------------------------
# The likelihood routes and their gradients.
# ---------------------------------------------------------------------------

_ROUTE_CASES = {  # name -> (nblocks, obs_dim, n)
    "nb2": (2, 2, 640),
    "nb8": (8, 1, 64),
    "adam": (2, 2, 64),
}


def _route_inputs(case):
    nb, obs, n = _ROUTE_CASES[case]
    seed = 10 * nb + obs
    return (_params(nb, obs, seed), *_series(n, obs, seed + 1))


@functools.lru_cache(maxsize=None)
def _jax_filter_value_and_grad():
    """jit(value_and_grad) of the JAX log_likelihood_filter
    (backend="xla"), float64; compiled once per input shape."""
    return jax.jit(jax.value_and_grad(
        lambda p, t, x: jcel.log_likelihood_filter(p, t, x, backend="xla")))


def _route_reference(case):
    """The JAX filter route's value and gradient on one case, computed
    once per test run (`torch_reference_cache.shared`)."""
    p, ts, xs = _route_inputs(case)
    v, g = shared(f"celerite_route_{case}",
                  lambda: _jax_filter_value_and_grad()(
                      _jparams(p), jnp.asarray(ts), jnp.asarray(xs)))
    return float(v), list(g)


def _check(label, value, grads, ref, rtol_v, rtol_g, atol_g):
    ref_v, ref_g = ref
    _close(value, ref_v, rtol_v, err_msg=label)
    for name, a, b in zip(_FIELDS, grads, ref_g):
        _close(a, b, rtol_g, atol_g * np.max(np.abs(b)),
               err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", ["nb2", "nb8"])
def test_likelihood_routes_match_jax(case, monkeypatch):
    """Both routes' values and structured-parameter gradients == the JAX
    log_likelihood_filter (backend="xla") at float64: the plain filter
    with its analytic adjoint and log_likelihood (closed-form K into the
    engine) at rtol 1e-10 on values and rtol 1e-7 / atol 1e-9 of the
    scale on gradients (the JAX package's bars, under which its two
    routes agree: tests/test_celerite.py:195-206).  nblocks 2 (obs 2,
    n = 640) and nblocks 8 (obs 1, n = 64: the boundary chain and the
    reduced system at block size 16).

    The same float32-representable inputs at float32 through the kernel
    routes on CPU tensors -- `_CelFilter` (the twins of kernels 13-15)
    and `_CelGapMahalFused` (kernel 12's twin), then the boundary ladder
    -- against the same reference at the JAX package's float32 bars:
    rtol 2e-5 on values, rtol 5e-3 / atol 5e-4 of the scale on gradients
    (tests/test_celerite.py:163-175, 228-240).  No kernel launches."""
    p, ts, xs = _route_inputs(case)
    ref = _route_reference(case)
    fns = (celerite.log_likelihood_filter, celerite.log_likelihood)
    q64 = _port(p)
    for fn in fns:
        v, g = _value_and_grads(fn, q64, _t(ts), _t(xs), backend="torch")
        _check(f"{fn.__name__} float64", v, g, ref, 1e-10, 1e-7, 1e-9)

    _to_cuda_route(monkeypatch)
    calls = []
    for fn_cls in (celerite._CelFilter, celerite._CelGapMahalFused):
        apply = fn_cls.apply
        monkeypatch.setattr(fn_cls, "apply", lambda *a, _f=apply, _c=fn_cls:
                            calls.append(_c) or _f(*a))
    before = _launches()
    q32 = _port(p, torch.float32)
    for fn in fns:
        v, g = _value_and_grads(fn, q32, _t(ts), _t(xs).float())
        assert all(x.dtype == np.float32 for x in g)
        _check(f"{fn.__name__} float32 kernel route", v, g, ref, 2e-5,
               5e-3, 5e-4)
    assert calls == [celerite._CelFilter, celerite._CelGapMahalFused]
    assert _launches() == before


def test_adam_steps_match_optax():
    """Three Adam steps (lr 1e-3, the port's train.loop.Optimizer without
    the plateau scale) on celerite.nll_loss, the filter route (nblocks 2,
    obs 2, n = 64), == optax.adam on the JAX nll_loss gradient at
    float64 (rtol 1e-9 on the losses and every parameter after each
    step)."""
    p, ts, xs = _route_inputs("adam")
    vg = _jax_filter_value_and_grad()
    nobs = xs.size
    jp = _jparams(p)
    opt = optax.adam(1e-3)
    state = opt.init(jp)
    q = _port(p)
    tts, txs = _t(ts), _t(xs)
    port_opt = loop.make_optimizer("adam", 1e-3, reduce_on_plateau=False)
    for step in range(3):
        ll, g = vg(jp, jnp.asarray(ts), jnp.asarray(xs))
        g = jax.tree.map(lambda x: -x / nobs, g)
        updates, state = opt.update(g, state)
        jp = optax.apply_updates(jp, updates)

        loss = celerite.nll_loss(q, tts, txs)
        for t in q.parameters():
            t.grad = None
        loss.backward()
        port_opt.step(q, loss.item())
        _close(loss.item(), -float(ll) / nobs, 1e-9, err_msg=str(step))
        for name, a, b in zip(_FIELDS, celerite_params_to_numpy(q), jp):
            _close(a, b, 1e-9, 1e-13, err_msg=f"step {step} {name}")


# ---------------------------------------------------------------------------
# The kernels' plain twins against the JAX XLA oracles, float32.
# ---------------------------------------------------------------------------


def test_kernel_twins_match_jax_oracles():
    """At float32, nblocks 2, obs_dim 1, n = 200 (s = 32, C = 7, the last
    chunk padded): the twins of kernels 13 and 14 == JAX
    conditional_filter_collect_xla on celerite._filter_inputs (statistics
    element-major, histories in the kernels' layout); kernel 15's twin ==
    the 2x2 diagonal blocks of conditional_filter_adjoint_xla's (e, Q)
    cotangents and its y, B, Lambda cotangents; kernel 12's twin == the
    closed-form K of leg._k_gap_parts_xla (row 0, the last coupling, the
    log|Q1| sum) eliminated by partitioned._forward_sweep.  rtol 1e-4 and
    atol 1e-5 of each output's scale: float32, other summation orders,
    and the JAX sweep floors its pivots while the twin takes them as
    they come (pivots here are far from the floor)."""
    nb, obs, n = 2, 1, 200
    s = 32
    c = -(-n // s)
    p, ts, xs = _params(nb, obs, 3), *_series(n, obs, 4)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), _jparams(p))
    jts = jnp.asarray(ts, jnp.float32)
    jxs = jnp.asarray(xs, jnp.float32)
    rng = np.random.RandomState(7)
    r = 2 * nb

    def jax_side(jp, cots_bm, v_cm):
        gb = jcel.g_blocks(jp)
        lam = jleg.lambda_lambda_t(jp)
        e, q, y, valid = jcel._filter_inputs(jp, jts, jxs, s)
        out, hist = jcf.conditional_filter_collect_xla(e, q, jp.b, lam, y,
                                                       valid)
        adj = jcf.conditional_filter_adjoint_xla(e, q, jp.b, lam, y, valid,
                                                 hist, cots_bm)
        boost = jp.b.T @ jnp.linalg.solve(lam, jp.b)
        k_cm, off_cm, lq_cm = jleg._k_gap_parts_xla(
            jcel.gap_terms_from_blocks(gb), boost, jts, s, False, r,
            jnp.float32)
        state, _, _ = jpt._forward_sweep(k_cm, off_cm, v_cm, 0.0, None)
        return out, hist, adj, (k_cm[0], off_cm[s - 1], jnp.sum(lq_cm)), \
            state

    shapes = [(c, r, r), (c, r), (c,), (c,), (c, r, r), (c, r), (c, r, r)]
    cots_bm = tuple(np.float32(rng.randn(*sh)) for sh in shapes)
    v_cm = np.float32(rng.randn(s, r, c))
    out, hist, adj, k_parts, state = jax.jit(jax_side)(jp, cots_bm, v_cm)

    q = _port(p, torch.float32)
    with torch.no_grad():
        gb = celerite.g_blocks(q)
        lam = leg.lambda_lambda_t(q)
        boost = q.b.T @ torch.linalg.solve(lam, q.b)
        diffs, gv, real = leg._chunk_gap_geometry(_t(ts).float(), s, n, c,
                                                  torch.float32)
        y_cm = celerite._y_chunk_major(_t(xs).float(), s, c)
        args = (gb, q.b.detach(), lam, diffs, gv, real, y_cm)
        stats = celerite_cuda.celerite_filter_plain(*args)
        stats14, hists = celerite_cuda.celerite_filter_collect_plain(*args)
        cots = tuple(_t(np.moveaxis(x, 0, -1)) for x in cots_bm)
        adj_t = celerite_cuda.celerite_filter_adjoint_plain(*args, hists,
                                                            cots)
        wrap = celerite._wrap_row(gb, diffs, gv, s)
        sweep = celerite_cuda.celerite_gap_mahal_sweep_plain(
            gb, boost, diffs, gv, real, wrap, _t(v_cm))

    def close(a, b, label):
        b = np.asarray(b)
        _close(a, b, 1e-4, 1e-5 * np.max(np.abs(b)), err_msg=label)

    out_em = [np.moveaxis(np.asarray(x), 0, -1) for x in out]
    for i, (a, a14, b) in enumerate(zip(stats, stats14, out_em)):
        close(a, b, f"kernel 13 out {i}")
        close(a14, b, f"kernel 14 out {i}")
    for i, (a, b) in enumerate(zip(hists, hist)):
        close(a, np.moveaxis(np.asarray(b), 1, -1), f"kernel 14 hist {i}")
    ebar, qbar, ybar, bbar, lambar = adj_t
    ref_e, ref_q, ref_b, ref_l, ref_y = map(np.asarray, adj)
    for k in range(nb):
        blk = np.s_[:, :, 2 * k:2 * k + 2, 2 * k:2 * k + 2]
        for got, ref in ((ebar, ref_e), (qbar, ref_q)):
            close(got[:, k], np.moveaxis(ref[blk].reshape(s, c, 4), 1, -1),
                  f"kernel 15 block {k}")
    close(ybar, np.moveaxis(ref_y, 1, -1), "kernel 15 ybar")
    close(bbar, ref_b, "kernel 15 bbar")
    close(lambar, ref_l, "kernel 15 lambar")

    k0, olast, lq_sum = k_parts
    for i, (a, b) in enumerate(zip(
            sweep, (state.acc00, state.accy0, state.w0, state.w, state.dj,
                    state.invd, state.mh, state.ld, lq_sum, k0, olast))):
        close(a, b, f"kernel 12 out {i}")


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------


def test_guards():
    """nll_loss refuses an unknown method (the JAX package silently takes
    the precision route); the engine's sweep kernels 1, 6 and 7 take block
    size 16 and refuse 9-15 and 17, naming the ROADMAP queue, while the
    other kernels refuse 16; a celerite wrapper refuses an nblocks it was
    not instantiated for."""
    p = celerite.init_params(1, 1, device="cpu")
    ts, xs = torch.arange(8.0), torch.zeros(8, 1)
    with pytest.raises(ValueError, match="method"):
        celerite.nll_loss(p, ts, xs, method="kalman")
    for r in (1, 8, 16):
        _build.check_rank(r, "forward_sweep_cuda", _build.SWEEP_RANKS)
    for r in list(range(9, 16)) + [17]:
        with pytest.raises(ValueError, match="ROADMAP"):
            _build.check_rank(r, "forward_sweep_cuda", _build.SWEEP_RANKS)
    with pytest.raises(ValueError, match="ROADMAP"):
        _build.check_rank(16, "k_system_cuda")
    with pytest.raises(ValueError, match="nblocks"):
        celerite_cuda._check_oscillators("celerite_filter_cuda",
                                         torch.zeros(9, 2, 2))


def _celerite_wrapper_calls():
    """Each raw celerite wrapper with dummy arguments (never computed: the
    guard comes first)."""
    z = torch.zeros
    gb, b, lam, geo = z(1, 2, 2), z(1, 2), z(1, 1), z(2, 3)
    filt = (gb, b, lam, geo, geo, geo, z(2, 1, 3))
    return {
        "celerite_gap_mahal_sweep": (
            celerite_cuda.celerite_gap_mahal_sweep_cuda,
            (gb, z(2, 2), geo, geo, geo, z(2, 2, 3), z(2, 2, 3))),
        "celerite_filter": (celerite_cuda.celerite_filter_cuda, filt),
        "celerite_filter_collect": (
            celerite_cuda.celerite_filter_collect_cuda, filt),
        "celerite_filter_adjoint": (
            celerite_cuda.celerite_filter_adjoint_cuda,
            filt + ((z(2, 2, 3),) * 3, (z(2, 2, 3),) * 7)),
    }


@pytest.mark.parametrize("kernel", list(_celerite_wrapper_calls()))
def test_raw_celerite_wrappers_refuse_autograd(kernel):
    """A raw celerite kernel wrapper under grad mode on an input that
    requires grad raises before it computes anything: its outputs carry
    no grad_fn (`_build.check_no_grad`)."""
    fn, args = _celerite_wrapper_calls()[kernel]
    args = (args[0].requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
