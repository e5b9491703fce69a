"""PyTorch port vs the JAX package: gradients.

The custom backwards of the port (torch.autograd.Functions mirroring the
JAX custom VJPs) against JAX on the same numpy-made inputs: the expm
Frechet VJP, the partitioned engine's analytic adjoint, the plain twins
of the three backward kernels against the TPU kernels in interpret mode,
the structured Pade-7 replay, and the log-likelihood gradient on every
route.  Also the two contracts of the port's entry points: a raw kernel
wrapper refuses to run under autograd, and nothing defaults to the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.data.synthetic import generate_data as jgenerate_data
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu.ops import expm_em as jexpm
from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu_torch.convert import (NumpyLEGParams, grads_to_numpy,
                                          params_from_jax)
from cyclic_gps_tpu_torch.data.synthetic import generate_data
from cyclic_gps_tpu_torch.entry import entry
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda, sweep_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops.expm_em import expm_em
from torch_reference_cache import shared

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_expm_em_vjp_matches_jax():
    """The Frechet-identity backward of expm_em == jax.vjp of the JAX
    expm_em at float64, over norms from 0.05 to 40 (0 to 4 squarings):
    rtol 1e-10, atol 1e-12 of the largest entry (the same Pade-13
    arithmetic in a different summation order)."""
    rng = np.random.RandomState(0)
    scales = np.array([0.05, 0.5, 2.0, 8.0, 40.0, 1.0])
    a = rng.randn(3, 3, scales.size) * scales
    ybar = rng.randn(3, 3, scales.size)
    val, vjp = jax.vjp(jexpm.expm_em, jnp.asarray(a))
    (ref,) = vjp(jnp.asarray(ybar))
    at = _t(a).requires_grad_()
    out = expm_em(at)
    (got,) = torch.autograd.grad(out, at, _t(ybar))
    _close(out, val, 1e-10)
    scale = float(np.max(np.abs(np.asarray(ref))))
    _close(got, ref, 1e-10, 1e-12 * scale)


def _system(n, d, s, seed):
    """SPD chunk-major system of tests/test_chunked.py's fixture, at
    float64, as numpy (R_cm, O_cm, y_cm)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / d
    y = rng.randn(n, d)
    return tuple(np.asarray(a) for a in jpt._chunk_layout(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(y), s)[:3])


_ENGINE_NS = (256, 250)  # 250: a padded last chunk


def _engine_one(R, O, y):
    def f(R_, O_, y_):
        mh, ld = jpt.mahal_and_logdet_cm(R_, O_, y_, backend="xla")
        return mh + 0.3 * ld, (mh, ld)

    grads, (mh, ld) = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(R, O, y)
    return (mh, ld), grads, jpt.solve_and_inverse_cm(R, O, y, backend="xla")


def _engine_reference(n):
    """The system at n and its JAX mahal_and_logdet_cm values and gradients
    (of mh + 0.3 ld) and solve_and_inverse_cm, backend="xla", computed
    once per test run (`torch_reference_cache.shared`)."""
    system = _system(n, 3, 8, seed=n + 2)
    return system, shared(f"grad_engine_{n}",
                          lambda: jax.jit(_engine_one)(*system))


@pytest.fixture(scope="module")
def jax_engine_reference():
    """n -> (system, JAX references) of `_engine_reference`."""
    return _engine_reference


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n", _ENGINE_NS)
def test_mahal_and_solve_inverse_match_jax(n, backend, monkeypatch,
                                           jax_engine_reference):
    """mahal_and_logdet_cm's values and analytic-adjoint gradients, and
    solve_and_inverse_cm, == JAX (backend="xla") at float64, d = 3,
    s = 8 (rtol 1e-10).  backend="cuda" runs the kernel glue on CPU
    tensors, i.e. through the plain twins of kernels 1, 6 and 7."""
    (R, O, y), ((mh_j, ld_j), grads_j, sol_j) = jax_engine_reference(n)
    if backend == "cuda":
        monkeypatch.setattr(pt, "resolve_backend", lambda b, t: "cuda")
    before = sweep_cuda.backward_solve_takahashi_cuda.launches
    ins = [_t(a).requires_grad_() for a in (R, O, y)]
    mh, ld = pt.mahal_and_logdet_cm(*ins)
    grads = torch.autograd.grad(mh + 0.3 * ld, ins)
    _close(mh, mh_j, 1e-10)
    _close(ld, ld_j, 1e-10)
    for name, a, b in zip(("R", "O", "y"), grads, grads_j):
        _close(a, b, 1e-10, 1e-12, err_msg=name)
    for a, b in zip(pt.solve_and_inverse_cm(*(_t(a) for a in (R, O, y))),
                    sol_j):
        _close(a, b, 1e-10, 1e-12)
    assert sweep_cuda.backward_solve_takahashi_cuda.launches == before


@pytest.mark.parametrize("n", _ENGINE_NS)
def test_backward_sweep_twins_match_pallas(n):
    """The plain twins of kernels 6 and 7 == forward_sweep_solveinv_pallas
    and backward_solve_takahashi_pallas in interpret mode, float64, on
    the engine fixture with pivot jitter 1e-3 (kernel 6) and random
    boundary inputs (kernel 7): rtol 1e-10, atol 1e-12 -- one algorithm,
    reassociated.  The TPU kernel's stacks are sliced to the true chunk
    count (it pads C to its lane tile)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep

    R, O, y = _system(n, 3, 8, seed=n + 3)
    d, c = R.shape[1], R.shape[-1]
    with pltpu.force_tpu_interpret_mode():
        ref6 = pallas_sweep.forward_sweep_solveinv_pallas(
            jnp.asarray(R), jnp.asarray(O), jnp.asarray(y), jitter=1e-3)
    got6 = sweep_cuda.forward_sweep_solveinv_cuda(_t(R), _t(O), _t(y),
                                                  1e-3)
    assert len(got6) == len(ref6) == 13
    ref6 = [np.asarray(b)[..., :c] if np.ndim(b) else b for b in ref6]
    for i, (a, b) in enumerate(zip(got6, ref6)):
        _close(a, b, 1e-10, 1e-12, err_msg=str(i))

    rng = np.random.RandomState(n)
    chunk = [rng.randn(*shape) * 0.3 for shape in
             [(d, d, c), (d, c), (d, c), (d, d, c), (d, d, c), (d, d, c),
              (d, d, c)]]
    stacks = ref6[8:12]
    with pltpu.force_tpu_interpret_mode():
        ref7 = pallas_sweep.backward_solve_takahashi_pallas(
            *(jnp.asarray(a) for a in stacks + chunk))
    got7 = sweep_cuda.backward_solve_takahashi_cuda(
        *(_t(a) for a in stacks + chunk))
    assert len(got7) == len(ref7) == 5
    for i, (a, b) in enumerate(zip(got7, ref7)):
        _close(a, b, 1e-10, 1e-12, err_msg=str(i))


def test_k_system_adjoint_twin_matches_pallas():
    """k_system_adjoint_plain (kernel 5's twin) == k_system_adjoint_pallas
    in interpret mode on the tests/test_expm.py fixture sizes (rank 3,
    n = 37, s = 4, float32; the last chunk padded), with random per-gap
    cotangents: rtol 1e-3, atol 1e-4 of each output's scale (the adjoint
    solves against chol(Q1), which amplifies float32 rounding by cond(Q1)
    for small gaps)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops.expm_pallas import k_system_adjoint_pallas

    rank, n, s = 3, 37, 4
    p = leg.init_params(rank, 2, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    with torch.no_grad():
        g = leg.g_matrix(p)
    rng = np.random.RandomState(1)
    ts = np.cumsum(rng.exponential(1.0, n) * 0.3 + 0.01).astype(np.float32)
    c = -(-n // s)
    diffs, gv, _ = leg._chunk_gap_geometry(torch.as_tensor(ts), s, n, c,
                                           torch.float32)
    cots = [torch.as_tensor(rng.randn(*shape).astype(np.float32)) for shape
            in [(s, rank, rank, c)] * 3 + [(s, c)]]
    args = (g, diffs, gv, *cots)
    got = expm_cuda.k_system_adjoint_cuda(*args)
    with pltpu.force_tpu_interpret_mode():
        ref = k_system_adjoint_pallas(*(jnp.asarray(_np(a)) for a in args))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        _close(a, b, 1e-3, 1e-4 * np.max(np.abs(b)))


def test_tn_replay_structured_matches_jax():
    """tn_replay_structured (the (e, Q) kernel's differentiable twin) ==
    the JAX expm_pallas.tn_replay_structured at float64, values and VJP,
    on gaps spanning both branches (rtol 1e-10, atol 1e-12 of the
    scale)."""
    from cyclic_gps_tpu.ops import expm_pallas

    rng = np.random.RandomState(3)
    a = rng.randn(3, 3)
    g = a @ a.T + (a - a.T) * 0.5 + np.eye(3)
    diffs = np.concatenate([rng.exponential(0.1, 12) + 1e-3,
                            rng.exponential(5.0, 12) + 1.0])
    ce, cq = rng.randn(3, 3, 24), rng.randn(3, 3, 24)
    def values_and_vjp(g_, d_, ce_, cq_):
        out, vjp = jax.vjp(expm_pallas.tn_replay_structured, g_, d_)
        return out + vjp((ce_, cq_))

    je, jq, jg, jd = jax.jit(values_and_vjp)(
        *(jnp.asarray(a_) for a_ in (g, diffs, ce, cq)))
    gt, dt = _t(g).requires_grad_(), _t(diffs).requires_grad_()
    e, q = expm_cuda.tn_replay_structured(gt, dt)
    gg, gd = torch.autograd.grad((e, q), (gt, dt), (_t(ce), _t(cq)))
    for a_, b_ in ((e, je), (q, jq), (gg, jg), (gd, jd)):
        b_ = np.asarray(b_)
        _close(a_, b_, 1e-10, 1e-12 * np.max(np.abs(b_)))


# ---------------------------------------------------------------------------
# The log-likelihood gradient on every route.
# ---------------------------------------------------------------------------

_LL_CASES = [(n, spacing) for n in (48, 300)
             for spacing in ("irregular", "regular")]


def _ll_case(n, spacing):
    """Rank 3 / obs 2 fixture with a full random N = I + 0.3 Z (a full N
    exposes orientation faults; near I it keeps float32 well-conditioned):
    numpy-made packed parameters and series, rounded to float32 so that
    the float32 kernel-route test and the float64 reference see the same
    numbers."""
    rng = np.random.RandomState(n)
    ti, tl = np.tril_indices(3), np.tril_indices(3, -1)
    z = rng.randn(3, 3)
    packed = (np.eye(3)[ti] + 0.3 * rng.randn(ti[0].size),
              ((z - z.T) * 0.2)[tl],
              (0.1 * np.eye(2))[np.tril_indices(2)], np.full((2, 3), 0.5))
    packed = [np.float32(a).astype(np.float64) for a in packed]
    ts, xs = generate_data(n, 2, dtype=torch.float32, spacing=spacing,
                           seed=n + 1, device="cpu")
    jts, jxs = jgenerate_data(n, 2, dtype=jnp.float32, spacing=spacing,
                              seed=n + 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    return packed, ts.double(), xs.double()


def _ll_grad_reference(n, spacing):
    """The case and jax.grad of JAX leg.log_likelihood(backend="xla") at
    float64, computed once per test run (`torch_reference_cache.shared`)."""
    case = packed, ts, xs = _ll_case(n, spacing)

    def grad(p, t, x):
        return jax.grad(lambda q: jleg.log_likelihood(
            q, t, x, regular=spacing == "regular", backend="xla"))(p)

    return case, shared(f"grad_ll_{n}_{spacing}", lambda: jax.jit(grad)(
        jleg.LEGParams(*map(jnp.asarray, packed)), jnp.asarray(ts.numpy()),
        jnp.asarray(xs.numpy())))


@pytest.fixture(scope="module")
def jax_ll_grads():
    """(n, spacing) -> (case, JAX gradient) of `_ll_grad_reference`."""
    return lambda key: _ll_grad_reference(*key)


def _port_grads(packed, ts, xs, dtype, **kw):
    p = params_from_jax(NumpyLEGParams(*(a.astype(dtype) for a in packed)),
                        device="cpu")
    ll = leg.log_likelihood(p, ts, xs.to(p.b.dtype), **kw)
    for t in p.parameters():
        t.grad = None
    ll.backward()
    return grads_to_numpy(p)


@pytest.mark.parametrize("n,spacing", _LL_CASES)
def test_log_likelihood_grad_matches_jax(n, spacing, jax_ll_grads):
    """torch.autograd gradient of log_likelihood == jax.grad of the JAX
    log_likelihood(backend="xla") at float64 for all four parameter
    leaves (rtol 1e-8, atol 1e-10 of each leaf's scale).  n = 48 takes
    the small-N route (natural-order precision, cyclic reduction), n =
    300 the chunk-major partitioned route with the analytic adjoint."""
    (packed, ts, xs), ref = jax_ll_grads((n, spacing))
    got = _port_grads(packed, ts, xs, np.float64,
                      regular=spacing == "regular")
    for name, a, b in zip(("n", "r", "lambda", "b"), got, ref):
        b = np.asarray(b)
        _close(a, b, 1e-8, 1e-10 * np.max(np.abs(b)), err_msg=name)


def test_streamed_emission_grad_matches_jax(monkeypatch, jax_ll_grads):
    """The slab-streamed plain emission (`_gap_terms_dense_streamed`,
    torch.utils.checkpoint per slab) gives the same float64 gradient as
    jax.grad (rtol 1e-8) with slabs far smaller than the gap count, so
    the slab joins and the checkpoint recompute are exercised."""
    monkeypatch.setattr(leg, "_ADJ_SLAB", 64)
    (packed, ts, xs), ref = jax_ll_grads((300, "irregular"))
    got = _port_grads(packed, ts, xs, np.float64)
    for name, a, b in zip(("n", "r", "lambda", "b"), got, ref):
        b = np.asarray(b)
        _close(a, b, 1e-8, 1e-10 * np.max(np.abs(b)), err_msg=name)


_ROUTES = {  # route -> (case, log_likelihood keywords)
    "fused": ((300, "irregular"), {}),
    "two_kernel": ((300, "irregular"), {"fused": False}),
    "regular": ((300, "regular"), {"regular": True}),
    "small": ((48, "irregular"), {}),
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_kernel_route_grads_match_jax_float32(route, monkeypatch,
                                              jax_ll_grads):
    """Every kernel route's autograd.Functions, run on CPU tensors (each
    kernel wrapper then runs its plain twin) by resolving every backend
    to "cuda", at float32, rank 3: the gradient == the JAX xla gradient
    of the same float32-rounded inputs (computed at float64) at the JAX
    package's fused-vs-plain float32 bar, rtol 5e-3 and atol 5e-4 of
    each leaf's scale (tests/test_chunked.py:172-174).  The fused route
    runs the fused kernel forward and replays the two-kernel route
    backward; CPU tensors launch nothing."""
    (n, spacing), kw = _ROUTES[route]
    (packed, ts, xs), ref = jax_ll_grads((n, spacing))
    monkeypatch.setattr(pt, "resolve_backend", lambda backend, t: "cuda")
    calls = []
    fused = leg._GapMahalFused.apply
    monkeypatch.setattr(leg._GapMahalFused, "apply",
                        lambda *a: calls.append(1) or fused(*a))
    wrappers = (sweep_cuda.forward_sweep_solveinv_cuda,
                sweep_cuda.backward_solve_takahashi_cuda,
                expm_cuda.k_system_adjoint_cuda)
    before = [w.launches for w in wrappers]
    got = _port_grads(packed, ts.float(), xs, np.float32, **kw)
    assert len(calls) == (route == "fused")
    assert [w.launches for w in wrappers] == before
    for name, a, b in zip(("n", "r", "lambda", "b"), got, ref):
        b = np.asarray(b)
        assert a.dtype == np.float32
        _close(a, b, 5e-3, 5e-4 * np.max(np.abs(b)), err_msg=name)


# ---------------------------------------------------------------------------
# The entry-point contracts.
# ---------------------------------------------------------------------------


def _wrapper_calls():
    """Each raw kernel wrapper with dummy arguments (never computed: the
    guard comes first)."""
    z = torch.zeros
    m, v, r = z(2, 1, 1, 1), z(2, 1, 1), z(2, 1)
    g, e, c = z(1, 1), z(1, 1, 1), z(1, 1)
    return {
        "forward_sweep": (sweep_cuda.forward_sweep_cuda, (m, m, v)),
        "forward_sweep_solveinv": (sweep_cuda.forward_sweep_solveinv_cuda,
                                   (m, m, v)),
        "backward_solve_takahashi": (
            sweep_cuda.backward_solve_takahashi_cuda,
            (z(1, 1, 1, 1),) * 2 + (z(1, 1, 1),) + (z(1, 1, 1, 1), e)
            + (c, c) + (e,) * 4),
        "transition_and_noise": (expm_cuda.transition_and_noise_cuda,
                                 (g, z(3))),
        "k_system": (expm_cuda.k_system_cuda, (g, g, r, r, r, e)),
        "gap_mahal_sweep": (expm_cuda.gap_mahal_sweep_cuda,
                            (g, g, r, r, r, e, v)),
        "k_system_adjoint": (expm_cuda.k_system_adjoint_cuda,
                             (g, r, r, m, m, m, r)),
    }


@pytest.mark.parametrize("kernel", list(_wrapper_calls()))
def test_raw_kernel_wrapper_refuses_autograd(kernel):
    """A raw kernel wrapper called under grad mode on an input that
    requires grad raises: its outputs carry no grad_fn, so a gradient
    would silently skip it.  The check comes before the CPU/CUDA branch,
    so it holds for the plain twins too."""
    fn, args = _wrapper_calls()[kernel]
    args = (args[0].requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)


_ENTRY_POINTS = {
    "entry": lambda: entry()[1][0].b,
    "init_params": lambda: leg.init_params(2, 1).b,
    "generate_data": lambda: generate_data(8, 1)[0],
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """entry(), init_params() and generate_data() without ``device`` put
    their tensors on the card: on a machine with one they land there, and
    on one without (as here) the call fails with torch's own error
    instead of falling back to the CPU."""
    make = _ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
