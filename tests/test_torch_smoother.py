"""PyTorch port vs the JAX package: the Kalman smoother behind float32
``method="auto"`` posteriors and the steady-state filter behind the loss
"kalman_ss" (cyclic_gps_tpu_torch/baselines/kalman.py, models/leg.py,
train/loop.py).

On the CPU the port's smoothers (flat, with cross-covariances, blocked
with a ragged tail, sequential) and the posterior routes are held against
one JAX reference, ``insample_posterior(method="smoother")`` at float64
(which is ``smooth_parallel_full`` of the JAX SSM), and against the
port's sequential smoother; the reverse scan against
``jax.lax.associative_scan(reverse=True)``; the steady-state likelihood's
value and gradient against the JAX function; the sample path against JAX's
on the same draws.  JAX is imported inside the CPU references only, so
the card tests (marked ``cuda``: the smoother and the steady-state loss
with their kernel, (A, Q) by kernel 2, against backend="torch") collect
without it: ``python -m pytest --noconftest tests/test_torch_smoother.py
-m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.baselines import kalman
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.train import loop

torch.set_num_threads(1)

_DT = {"float64": torch.float64, "float32": torch.float32}
_T = 150  # two blocks of 64 and a ragged tail of 22
_BLOCK = 64


def _arrays(rank, obs, seed):
    """Packed LEG parameters made with numpy: N = I + 0.3 Z, R = (Z -
    Z^T) / 5, raw Lambda 0.1 I, B = 0.5 / sqrt(rank)."""
    rng = np.random.RandomState(seed)
    ti = np.tril_indices(rank)
    z = rng.randn(rank, rank)
    return (np.eye(rank)[ti] + 0.3 * rng.randn(ti[0].size),
            ((z - z.T) * 0.2)[np.tril_indices(rank, -1)],
            (0.1 * np.eye(obs))[np.tril_indices(obs)],
            np.full((obs, rank), 0.5 / math.sqrt(rank)))


def _grid(n, seed, obs=2, regular=False):
    """(ts, xs) made with numpy: gaps 0.125-0.5 (0.25 on a uniform grid),
    seeded standard normal observations."""
    rng = np.random.RandomState(seed)
    gaps = (np.full(n, 0.25) if regular
            else rng.randint(1, 5, n) * 0.125)
    return np.cumsum(gaps), rng.randn(n, obs)


def _port(arrays, dtype="float64"):
    return leg.LEGParams(*(torch.tensor(a, dtype=_DT[dtype])
                           for a in arrays))


def _jax(arrays, dtype="float64"):
    import jax.numpy as jnp

    from cyclic_gps_tpu.models import leg as jleg

    return jleg.LEGParams(*(jnp.asarray(a, dtype) for a in arrays))


def _close(got, ref, rtol, label=""):
    """Every output within rtol of its reference's scale (max |ref|)."""
    for i, (a, b) in enumerate(zip(got, ref)):
        a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                       dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        assert a.shape == b.shape, f"{label} out {i}: {a.shape} {b.shape}"
        scale = max(np.max(np.abs(b)), 1e-300)
        err = np.max(np.abs(a - b)) / scale
        assert err <= rtol, f"{label} out {i}: {err:.3e} > {rtol:g}"


def _inputs():
    return _arrays(3, 2, seed=21), *_grid(_T, seed=22)


def smoother_reference():
    """JAX's ``insample_posterior(method="smoother")`` at float64 on
    `_inputs` ((means, covs, cross): ``smooth_parallel_full`` of its
    SSM), computed once per run and shared by the test workers
    (tests/test_torch_posterior.py holds its routing test against it
    too)."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        from cyclic_gps_tpu.models import leg as jleg

        arrays, ts, xs = _inputs()
        return jax.jit(lambda p, t, x: jleg.insample_posterior(
            p, t, x, method="smoother"))(
                _jax(arrays), jnp.asarray(ts), jnp.asarray(xs))

    return shared("smoother_full", compute)


def _port_ssm(dtype="float64", backend="auto"):
    arrays, ts, xs = _inputs()
    p = _port(arrays, dtype)
    ssm = kalman.leg_to_ssm(p, torch.tensor(ts, dtype=_DT[dtype]),
                            backend=backend)
    return ssm, torch.tensor(xs, dtype=_DT[dtype])


_SMOOTHERS = {
    "smooth_parallel": kalman.smooth_parallel,
    "smooth_parallel_full": kalman.smooth_parallel_full,
    "blocked": lambda ssm, x: kalman.smooth_parallel_full_blocked(
        ssm, x, _BLOCK),
    "smooth_sequential": kalman.smooth_sequential,
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(_SMOOTHERS))
def test_smoothers_match_jax(name, dtype, no_persistent_cache_writes):
    """Each smoother's means, covariances (and cross-covariances) == JAX's
    float64 smoother on the same SSM (T = 150; the blocked one in blocks
    of 64 with a ragged tail of 22 padded steps): 1e-10 of each output's
    scale at float64 (the same algorithm, the same combination trees),
    1e-4 at float32 (float32 roundoff through the filter's and the
    smoother's log-depth trees; one JAX reference, float64, for both
    dtypes); at float64 each also == the port's sequential smoother to
    1e-10."""
    ref = smoother_reference()
    ssm, xs = _port_ssm(dtype)
    with torch.no_grad():
        got = _SMOOTHERS[name](ssm, xs)
        _close(got, ref[:len(got)], 1e-10 if dtype == "float64" else 1e-4,
               name)
        if dtype == "float64" and name != "smooth_sequential":
            seq = kalman.smooth_sequential(ssm, xs)
            _close(got[:2], seq, 1e-10, f"{name} vs sequential")


def test_blocked_padded_tail_float32(no_persistent_cache_writes):
    """The blocked smoother at float32 in one block of 16,384 steps, of
    which 16,234 are padding: the links through the padded tail are exact
    identities, so it == JAX's float64 smoother to 1e-4 of scale like the
    flat one (links solved in float32 sum their roundoff over the tail:
    ~3e-4 of scale here)."""
    ref = smoother_reference()
    ssm, xs = _port_ssm("float32")
    with torch.no_grad():
        got = kalman.smooth_parallel_full_blocked(ssm, xs, 1 << 14)
    _close(got, ref, 1e-4, "blocked, long padded tail")


def _scan_leaves(n):
    """Two integer leaves [2, 1, n] and [1, 3, n], seeded."""
    rng = np.random.RandomState(n)
    return (rng.randint(-3, 4, (2, 1, n)).astype(np.int64),
            rng.randint(-3, 4, (1, 3, n)).astype(np.int64))


def _not_associative(a, b):
    """fn(a, b) = (2 a + b, a - 3 b) leafwise: not associative and not
    commutative, so a scan with it depends on the tree and on the order
    of its arguments, and integer arithmetic makes every entry exact."""
    return tuple(2 * x + y if i == 0 else x - 3 * y
                 for i, (x, y) in enumerate(zip(a, b)))


_SCAN_NS = (1, 2, 5, 8, 13, 32, 37)


def _reverse_scan_references():
    """jax.lax.associative_scan(reverse=True) over the last axis at every
    length of `_SCAN_NS`, in one jitted computation."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        def scans(all_leaves):
            return [jax.lax.associative_scan(_not_associative, ls,
                                             reverse=True, axis=2)
                    for ls in all_leaves]

        return dict(zip(map(str, _SCAN_NS), jax.jit(scans)(
            [tuple(jnp.asarray(a) for a in _scan_leaves(n))
             for n in _SCAN_NS])))

    return shared("reverse_scans", compute)


@pytest.mark.parametrize("n", _SCAN_NS)
def test_reverse_scan_is_jax_tree(n, no_persistent_cache_writes):
    """associative_scan(reverse=True) == jax.lax.associative_scan(reverse=
    True) exactly on a non-associative, non-commutative integer combine:
    the inputs flipped, the same tree, ``fn``'s arguments in JAX's order,
    the outputs flipped back."""
    ref = _reverse_scan_references()[str(n)]
    got = kalman.associative_scan(
        _not_associative, tuple(torch.tensor(a) for a in _scan_leaves(n)),
        reverse=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _to_cuda_route(monkeypatch):
    """Resolve every backend but "torch" to "cuda": the kernel routes run
    on CPU tensors through the wrappers' plain twins."""
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")


@pytest.mark.parametrize("route", ["torch", "cuda", "blocked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_posterior_routes_match_jax(dtype, route, monkeypatch,
                                    no_persistent_cache_writes):
    """posterior_mean and insample_posterior take the smoother where JAX
    does: method="smoother" at float64 and float32 "auto" (resolved by the
    model's dtype) == JAX's smoother posterior (1e-10 / 1e-4 of scale), on
    the plain route, on the kernel route's glue (at float32 (A, Q) from
    kernel 2's plain twin, the structured Pade-7: within the float32
    bar), and on the blocked route (`kalman.SMOOTHER_BLOCK` lowered to 64,
    so that T = 150 takes `smooth_parallel_full_blocked` in three
    blocks)."""
    ref = smoother_reference()
    arrays, ts, xs = _inputs()
    p = _port(arrays, dtype)
    ts = torch.tensor(ts, dtype=torch.float64)  # float64 time axis
    xs = torch.tensor(xs, dtype=_DT[dtype])
    method = "smoother" if dtype == "float64" else "auto"
    if route == "cuda":
        _to_cuda_route(monkeypatch)
    calls = []
    if route == "blocked":
        monkeypatch.setattr(kalman, "SMOOTHER_BLOCK", _BLOCK)
        orig = kalman.smooth_parallel_full_blocked
        monkeypatch.setattr(kalman, "smooth_parallel_full_blocked",
                            lambda *a: calls.append(a[2]) or orig(*a))
    with torch.no_grad():
        mean = leg.posterior_mean(p, ts, xs, method=method)
        post = leg.insample_posterior(p, ts, xs, method=method)
    assert calls == ([_BLOCK] * 2 if route == "blocked" else [])
    bar = 1e-10 if dtype == "float64" else 1e-4
    _close([mean], ref[:1], bar, "posterior_mean")
    _close(post, ref, bar, "insample_posterior")


def test_predictions_take_the_smoother(no_persistent_cache_writes):
    """float32 make_predictions(method="auto") runs through the smoother
    (no NotImplementedError) and == the float64 precision-route
    predictions to 1e-4 of scale (two exact posteriors at float32 and
    float64); celerite.make_predictions' default too."""
    from cyclic_gps_tpu_torch.models import celerite

    arrays, ts, xs = _inputs()
    ts = torch.tensor(ts)
    targets = torch.sort(ts[0] - 1.0 + (ts[-1] - ts[0] + 2.0) * torch.rand(
        40, dtype=torch.float64, generator=torch.Generator().manual_seed(3)
    )).values
    with torch.no_grad():
        got = leg.make_predictions(_port(arrays, "float32"), ts,
                                   torch.tensor(xs, dtype=torch.float32),
                                   targets)
        ref = leg.make_predictions(_port(arrays), ts, torch.tensor(xs),
                                   targets, method="precision")
        _close(got, ref, 1e-4, "make_predictions")
        cp = celerite.init_params(2, 2, generator=torch.Generator()
                                  .manual_seed(4), device="cpu")
        got = celerite.make_predictions(cp, ts, torch.tensor(
            xs, dtype=torch.float32), targets)
        cp64 = celerite.CeleriteParams(*(t.detach().double()
                                         for t in cp.parameters()))
        ref = celerite.make_predictions(cp64, ts, torch.tensor(xs), targets,
                                        method="precision")
        _close(got, ref, 1e-4, "celerite make_predictions")


def test_rows_blocked_sum_to_the_filter():
    """log_likelihood_rows_blocked: the per-step terms sum to
    filter_parallel's log-likelihood (1e-10), in blocks of 64 (ragged
    tail) and flat alike (1e-12 per row), on a boundary-masked SSM
    (a restart every 40 points), so the rows' segment sums are each
    segment's own filter log-likelihood (1e-10)."""
    arrays, ts, xs = _inputs()
    mask = torch.tensor(np.arange(_T) % 40 != 39)
    ssm = kalman.leg_to_ssm(_port(arrays), torch.tensor(ts), gap_mask=mask)
    xs = torch.tensor(xs)
    with torch.no_grad():
        rows = kalman.log_likelihood_rows_blocked(ssm, xs, _BLOCK)
        flat = kalman.log_likelihood_rows_blocked(ssm, xs)
        total = kalman.filter_parallel(ssm, xs)[2]
        _close([rows], [flat], 1e-12, "rows")
        _close([rows.sum()], [total], 1e-10, "sum")
        p = _port(arrays)
        for start in range(0, _T, 40):
            sl = slice(start, min(start + 40, _T))
            own = kalman.filter_parallel(
                kalman.leg_to_ssm(p, torch.tensor(ts[sl])), xs[sl])[2]
            _close([rows[sl].sum()], [own], 1e-10, f"segment {start}")


def _sample_reference():
    """JAX's sample_states at float64 (key 5) on the port's SSM of
    `_inputs` (the two packages' leg_to_ssm agree to 1e-12,
    tests/test_torch_kalman.py), and the standard-normal draws it made."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        from cyclic_gps_tpu.baselines import kalman as jk

        ssm = jk.SSM(*(jnp.asarray(x.detach().numpy())
                       for x in _port_ssm()[0]))
        key = jax.random.key(5)
        return (jk.sample_states(ssm, key),
                jax.random.normal(key, (_T, 3), dtype=jnp.float64))

    return shared("sample_states", compute)


def test_sample_states_matches_jax(no_persistent_cache_writes):
    """The sample path on the same standard-normal draws as JAX's
    sample_states (its key's draws handed to the port) == JAX's path to
    1e-12 of scale; `sample_states` with a generator gives a finite
    [T, r] path (its draws differ from JAX's, a kept deviation)."""
    ref, ws = _sample_reference()
    ssm, _ = _port_ssm()
    _close([kalman._sample_path(ssm, torch.tensor(ws))], [ref], 1e-12,
           "path")
    z = kalman.sample_states(ssm, torch.Generator().manual_seed(5))
    assert z.shape == (_T, 3) and bool(torch.isfinite(z).all())


# The steady-state likelihood: rank 5, obs 2, a uniform grid of 700 points,
# the switch point t0 = 256 (where the Riccati residual of these parameters
# is ~5e-14) and blocks of 16 (a tail of 444 = 27 blocks and a ragged one;
# one super-chunk of 128 holds the 28 chunks).
_SS = {"t0": 256, "block": 16}


def _steady_inputs():
    return _arrays(5, 2, seed=31), *_grid(700, seed=32, regular=True)


def _steady_args(dtype="float64", backend="auto"):
    """(a, q, h, r_obs, xs) of `_steady_inputs` from the port's
    leg_to_ssm(regular=True), detached."""
    arrays, ts, xs = _steady_inputs()
    ssm = kalman.leg_to_ssm(_port(arrays, dtype),
                            torch.tensor(ts, dtype=torch.float64),
                            regular=True, backend=backend)
    return (ssm.a[0].detach(), ssm.q[0].detach(), ssm.h.detach(),
            ssm.r.detach(), torch.tensor(xs, dtype=_DT[dtype]))


def _steady_reference():
    """(value, gradient with respect to a, q, h, r_obs) of JAX's
    log_likelihood_steady at float64 on the port's SSM of
    `_steady_inputs` (leg_to_ssm(regular=True); the two packages' agree
    to 1e-12, tests/test_torch_kalman.py)."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        from cyclic_gps_tpu.baselines import kalman as jk

        *args, xs = (jnp.asarray(x.numpy()) for x in _steady_args())
        v, g = jax.value_and_grad(
            lambda *a: jk.log_likelihood_steady(*a, xs, **_SS),
            argnums=(0, 1, 2, 3))(*args)
        return v, list(g)

    return shared("steady", compute)


def test_steady_matches_jax(no_persistent_cache_writes):
    """log_likelihood_steady == JAX's at float64 on the same (A, Q, H, R):
    the value to 1e-10 relative, the gradient with respect to each of the
    four to 1e-8 of its scale (the port's transient is the log-depth
    filter where JAX runs sequential Riccati steps: the same moments,
    rounded in another order; Q and R are symmetric, so their gradients
    are compared on symmetric matrices: each implementation reads its own
    triangles of them); and == the exact filter (filter_parallel) on the
    whole grid to 1e-9, the Riccati recursion having converged by t0."""
    v_ref, g_ref = _steady_reference()
    *args, xs = _steady_args()
    args = [a.requires_grad_() for a in args]
    v = kalman.log_likelihood_steady(*args, xs, **_SS)
    g = torch.autograd.grad(v, args)
    v = float(v)
    assert abs(v - float(v_ref)) <= 1e-10 * abs(float(v_ref))

    def sym(x, i):
        x = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
        return 0.5 * (x + x.T) if i in (1, 3) else x

    _close([sym(x, i) for i, x in enumerate(g)],
           [sym(x, i) for i, x in enumerate(g_ref)], 1e-8, "gradient")
    with torch.no_grad():
        arrays, ts, _ = _steady_inputs()
        ssm = kalman.leg_to_ssm(_port(arrays), torch.tensor(ts),
                                regular=True)
        exact = float(kalman.filter_parallel(ssm, xs)[2])
    assert abs(v - exact) <= 1e-9 * abs(exact)


def test_steady_rejects_short_grids():
    """T <= t0 has no steady-state tail: ValueError (the JAX function
    fails on the scan lengths)."""
    a = torch.eye(2) * 0.5
    with pytest.raises(ValueError, match="t0"):
        kalman.log_likelihood_steady(a, torch.eye(2) * 0.75, torch.ones(1, 2),
                                     torch.eye(1), torch.zeros(64, 1), t0=64)


def _steady_loss(dtype, backend="auto"):
    """nll_loss_kalman_steady's value and parameter gradient on
    `_steady_inputs` at t0 = SS_T0 = 2048 (on a grid of SS_T0 + 300
    points of the same spacing)."""
    arrays, _, _ = _steady_inputs()
    ts, xs = _grid(loop.SS_T0 + 300, seed=33, regular=True)
    p = _port(arrays, dtype)
    v = loop.nll_loss_kalman_steady(
        p, torch.tensor(ts), torch.tensor(xs, dtype=_DT[dtype]),
        backend=backend)
    return v.detach(), torch.autograd.grad(v, list(p.parameters()))


def test_steady_kernel_route(monkeypatch):
    """At float32 the kernel route of the steady-state loss (its one
    (A, Q) from kernel 2's plain twin, the structured Pade-7) == the
    torch route (Pade-13): value to 1e-5, gradient to 1e-3 of each
    leaf's scale; and the float32 value == the float64 one, and the
    float64 loss == nll_loss_kalman_regular (the exact filter), to 1e-5
    and 1e-9 relative."""
    v_t, g_t = _steady_loss("float32", "torch")
    v_64, _ = _steady_loss("float64")
    _to_cuda_route(monkeypatch)
    v_k, g_k = _steady_loss("float32")
    assert abs(float(v_k) - float(v_t)) <= 1e-5 * abs(float(v_t))
    _close(g_k, [x.numpy() for x in g_t], 1e-3, "gradient")
    assert abs(float(v_k) - float(v_64)) <= 1e-5 * abs(float(v_64))
    arrays, _, _ = _steady_inputs()
    ts, xs = _grid(loop.SS_T0 + 300, seed=33, regular=True)
    with torch.no_grad():
        exact = float(loop.nll_loss_kalman_regular(
            _port(arrays), torch.tensor(ts), torch.tensor(xs)))
    assert abs(float(v_64) - exact) <= 1e-9 * abs(exact)


# ---------------------------------------------------------------------------
# On the card: the smoother posterior and the steady-state loss with their
# kernel against backend="torch".
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [150, 4097])
def test_smoother_on_card(card, n):
    """float32 insample_posterior(method="auto") on the card (the
    smoother; (A, Q) of every gap by kernel 2, which launches once) ==
    backend="torch" on the card to 1e-3 of each output's scale (PERF.md
    section 2's float32 posterior bar)."""
    p = leg.init_params(5, 2, generator=torch.Generator().manual_seed(n),
                        device=card)
    ts, xs = _grid(n, seed=n)
    ts = torch.tensor(ts, dtype=torch.float64, device=card)
    xs = torch.tensor(xs, dtype=torch.float32, device=card)
    k2 = expm_cuda.transition_and_noise_cuda
    before = k2.launches
    with torch.no_grad():
        got = leg.insample_posterior(p, ts, xs)
        torch.cuda.synchronize()
        launched = k2.launches - before
        ref = leg.insample_posterior(p, ts, xs, backend="torch")
    assert launched == 1
    _close([x.cpu() for x in got], [x.cpu().numpy() for x in ref], 1e-3,
           "smoother")


@pytest.mark.cuda
def test_steady_loss_on_card(card):
    """nll_loss_kalman_steady at float32 on the card (one (A, Q) by kernel
    2) == backend="torch": value to 1e-4 relative, gradient leaves to
    1e-3 of their scale, on a uniform grid of SS_T0 + 5,000 points."""
    p = leg.init_params(5, 2, generator=torch.Generator().manual_seed(7),
                        device=card)
    ts, xs = _grid(loop.SS_T0 + 5000, seed=8, regular=True)
    ts = torch.tensor(ts, dtype=torch.float64, device=card)
    xs = torch.tensor(xs, dtype=torch.float32, device=card)
    out = {}
    for backend in ("auto", "torch"):
        v = loop.nll_loss_kalman_steady(p, ts, xs, backend=backend)
        out[backend] = (v.detach().cpu(), [g.cpu() for g in torch.autograd
                                           .grad(v, list(p.parameters()))])
    (v_a, g_a), (v_t, g_t) = out["auto"], out["torch"]
    assert abs(float(v_a) - float(v_t)) <= 1e-4 * abs(float(v_t))
    _close(g_a, [g.numpy() for g in g_t], 1e-3, "gradient")
