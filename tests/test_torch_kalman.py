"""PyTorch port vs the JAX package: the Kalman filter losses
(cyclic_gps_tpu_torch/baselines/kalman.py, train/loop.py) and kernel 2,
the per-gap (e, Q) emission (csrc/gap_emission.cu), which they run on
every gap.

On the CPU the port's functions are held against their JAX twins on the
same seeded numpy inputs: the SSM bridge, the sequential and parallel
filters, the log-depth scan (against ``jax.lax.associative_scan``), the
blocked filter against the flat one, the two losses with their gradients
(and the kernel route, whose wrapper runs its plain twin on CPU tensors,
against the torch route), the Kalman loss against the "cr" loss, the
residual loss against the Kalman loss in the seven regimes of
tests/test_residual_loss.py, and fit's default-loss choice.  JAX is
imported inside the CPU references only, so the card tests (marked
``cuda``: kernel 2's two designs against its twin, and its launch
counters on every path that launches it) collect without it:
``python -m pytest --noconftest tests/test_torch_kalman.py -m cuda``.
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


def _arrays(rank, obs, seed, nscale=0.5, lam=None):
    """Packed LEG parameters made with numpy: a random full N (scaled),
    R = (Z - Z^T) / 5, raw Lambda 0.1 I (or ``lam`` everywhere), B = 0.5
    (row-normalised ones, the reference's init)."""
    rng = np.random.RandomState(seed)
    z = rng.randn(rank, rank)
    lam_raw = (0.1 * np.eye(obs))[np.tril_indices(obs)]
    if lam is not None:
        lam_raw = np.full_like(lam_raw, lam)
    return (rng.randn(rank * (rank + 1) // 2) * nscale,
            ((z - z.T) * 0.2)[np.tril_indices(rank, -1)], lam_raw,
            np.full((obs, rank), 0.5 / math.sqrt(rank)))


def _grid(n, seed, kind="irregular", obs=2):
    """(ts, xs) made with numpy: gaps 0.125-0.5 (or ``kind``'s), seeded
    standard normal observations."""
    rng = np.random.RandomState(seed)
    if kind == "regular":
        gaps = np.full(n, 0.25)
    elif kind == "long":
        gaps = rng.randint(80, 320, n) * 0.125  # 10 .. 40
    elif kind == "tiny":
        gaps = rng.randint(1, 5, n) * 2.5e-4  # 2.5e-4 .. 1e-3
    elif kind == "mixed":
        gaps = np.where(rng.rand(n) < 0.5, 1e-3, 10.0)
    else:
        gaps = rng.randint(1, 5, n) * 0.125
    return np.cumsum(gaps), rng.randn(n, obs)


def _port(arrays, dtype):
    return leg.LEGParams(*(torch.tensor(a, dtype=_DT[dtype])
                           for a in arrays))


def _jax(arrays, dtype):
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


# ---------------------------------------------------------------------------
# The SSM bridge and the filters against the JAX package.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["irregular", "regular", "gap_mask",
                                  "approximation"])
def test_leg_to_ssm_matches_jax(case, no_persistent_cache_writes):
    """leg_to_ssm == the JAX leg_to_ssm at float64 (A, Q, H, R to 1e-12 of
    their scale: both run the Pade-13 emission on the same gaps).  The
    gap mask restarts the filter at every 5th point (A = 0, Q = I)."""
    import jax.numpy as jnp

    from cyclic_gps_tpu.baselines import kalman as jk

    arrays = _arrays(3, 2, seed=1)
    ts, _ = _grid(41, seed=2, kind="regular" if case == "regular"
                  else "irregular")
    kw = {"regular": case == "regular",
          "use_approximation": case == "approximation"}
    mask = (np.arange(41) % 5 != 4).astype(np.float64)
    jkw = dict(kw, gap_mask=jnp.asarray(mask)) if case == "gap_mask" else kw
    tkw = dict(kw, gap_mask=torch.tensor(mask)) if case == "gap_mask" else kw
    ref = jk.leg_to_ssm(_jax(arrays, "float64"), jnp.asarray(ts), **jkw)
    got = kalman.leg_to_ssm(_port(arrays, "float64"), torch.tensor(ts),
                            **tkw)
    _close(got, ref, 1e-12, case)
    if case == "gap_mask":
        assert float(got.a[5].detach().abs().max()) == 0.0


_FILTERS = [(name, dtype) for name in ("filter_sequential", "filter_parallel")
            for dtype in ("float64", "float32")]


def _filter_references():
    """The JAX filters' float64 outputs on `test_filters_match_jax`'s
    input, both filters in one computation shared by the test workers."""
    import jax.numpy as jnp

    from cyclic_gps_tpu.baselines import kalman as jk
    from torch_reference_cache import shared

    def compute():
        import jax

        arrays = _arrays(3, 2, seed=3)
        ts, xs = _grid(13, seed=4)
        return {name: jax.jit(
            lambda p, t, x: getattr(jk, name)(jk.leg_to_ssm(p, t), x))(
                _jax(arrays, "float64"), jnp.asarray(ts), jnp.asarray(xs))
                for name in ("filter_sequential", "filter_parallel")}

    return shared("kalman_filters", compute)


@pytest.mark.parametrize("name,dtype", _FILTERS)
def test_filters_match_jax(name, dtype, no_persistent_cache_writes):
    """The filtered means, covariances and log-likelihood == the JAX
    filter's at float64 on the same SSM (T = 13: odd and even lengths at
    every level of the scan): 1e-10 of each output's scale at float64 (the
    same algorithm; the parallel filter on JAX's combination tree), 5e-5
    at float32 (the port's float32 roundoff over 13 dependent steps or 2
    log2 T combine levels; one JAX reference, float64, for both dtypes)."""
    arrays = _arrays(3, 2, seed=3)
    ts, xs = _grid(13, seed=4)
    ref = _filter_references()[name]
    p = _port(arrays, dtype)
    ssm = kalman.leg_to_ssm(p, torch.tensor(ts, dtype=_DT[dtype]))
    got = getattr(kalman, name)(ssm, torch.tensor(xs, dtype=_DT[dtype]))
    _close(got, ref, 1e-10 if dtype == "float64" else 5e-5, name)


def _scan_leaves(n):
    """Two integer leaves [2, 1, n] and [1, 3, n], seeded."""
    rng = np.random.RandomState(n)
    return (rng.randint(-3, 4, (2, 1, n)).astype(np.int64),
            rng.randint(-3, 4, (1, 3, n)).astype(np.int64))


def _not_associative(xp):
    """fn(a, b) = (2 a + b, a - 3 b) leafwise: NOT associative, so its scan
    depends on the combination tree, and integer arithmetic makes every
    entry exact.  Scanning with it compares trees, not roundoff."""
    def fn(a, b):
        return tuple(2 * x + y if i == 0 else x - 3 * y
                     for i, (x, y) in enumerate(zip(a, b)))
    return fn


def _scan_references():
    """jax.lax.associative_scan over the last axis at every length 1-37,
    in one jitted computation shared by the test workers."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        def scans(all_leaves):
            return [jax.lax.associative_scan(_not_associative(jnp), ls,
                                             axis=2)
                    for ls in all_leaves]

        return dict(zip(map(str, range(1, 38)), jax.jit(scans)(
            [tuple(jnp.asarray(a) for a in _scan_leaves(n))
             for n in range(1, 38)])))

    return shared("kalman_scans", compute)


@pytest.mark.parametrize("n", range(1, 38))
def test_associative_scan_is_jax_tree(n, no_persistent_cache_writes):
    """associative_scan == jax.lax.associative_scan (last axis) exactly, on
    a non-associative, non-commutative integer combine: every one of the
    n outputs is grouped as JAX groups it."""
    leaves = _scan_leaves(n)
    ref = _scan_references()[str(n)]
    got = kalman.associative_scan(
        _not_associative(torch), tuple(torch.tensor(a) for a in leaves))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("t", [300, 301])
def test_blocked_matches_flat(t):
    """filter_parallel_blocked and log_likelihood_blocked at block = 64
    (T not a multiple of it: 5 blocks, the last padded) == filter_parallel
    at float64: means, covariances and log-likelihood to 1e-10 of scale,
    and the parameter gradient of the log-likelihood through the
    checkpointed blocks to 1e-9 of each leaf's scale."""
    arrays = _arrays(3, 2, seed=5)
    ts, xs = _grid(t, seed=6)
    ts, xs = torch.tensor(ts), torch.tensor(xs)

    def run(fn):
        p = _port(arrays, "float64")
        for q in p.parameters():
            q.requires_grad_(True)
        ssm = kalman.leg_to_ssm(p, ts)
        out = fn(ssm)
        ll = out if isinstance(out, torch.Tensor) else out[2]
        return out, torch.autograd.grad(ll, list(p.parameters()))

    flat, g_flat = run(lambda s: kalman.filter_parallel(s, xs))
    blocked, _ = run(lambda s: kalman.filter_parallel_blocked(s, xs, 64))
    ll_b, g_b = run(lambda s: kalman.log_likelihood_blocked(s, xs, 64))
    _close(blocked, [f.detach() for f in flat], 1e-10, "blocked")
    _close([ll_b], [flat[2].detach()], 1e-10, "ll blocked")
    _close(g_b, g_flat, 1e-9, "gradient")


# ---------------------------------------------------------------------------
# The losses.
# ---------------------------------------------------------------------------


_LOSSES = [(name, dtype) for name in ("kalman", "kalman_regular")
           for dtype in ("float64", "float32")]


def _loss_inputs(name):
    ts, xs = _grid(12, seed=8, kind="regular" if name == "kalman_regular"
                   else "irregular")
    return _arrays(3, 2, seed=7), ts, xs


def _loss_references():
    """(value, gradient leaves) of the JAX losses at float64 on
    `_loss_inputs`, both losses in one computation shared by the test
    workers."""
    import jax
    import jax.numpy as jnp

    from cyclic_gps_tpu.train import loop as jloop
    from torch_reference_cache import shared

    def compute():
        out = {}
        for name in ("kalman", "kalman_regular"):
            arrays, ts, xs = _loss_inputs(name)
            v, g = jax.value_and_grad(jloop.LOSSES[name])(
                _jax(arrays, "float64"), jnp.asarray(ts), jnp.asarray(xs))
            out[name] = (v, list(g))
        return out

    return shared("kalman_losses", compute)


def _loss_port(name, arrays, dtype, ts, xs, backend="auto"):
    p = _port(arrays, dtype)
    for q in p.parameters():
        q.requires_grad_(True)
    kw = {} if name == "cr_residual" else {"backend": backend}
    v = loop.LOSSES[name](p, torch.tensor(ts, dtype=_DT[dtype]),
                          torch.tensor(xs, dtype=_DT[dtype]), **kw)
    return v, torch.autograd.grad(v, list(p.parameters()))


@pytest.mark.parametrize("name,dtype", _LOSSES)
def test_losses_match_jax(name, dtype, no_persistent_cache_writes):
    """nll_loss_kalman(_regular) value and gradient == the JAX loss's at
    float64 (T = 12): 1e-10 (value) and 1e-9 of each leaf's scale
    (gradient) at float64; 2e-5 and 2e-3 at float32 (the port's float32
    roundoff in the filter, as above, and in the gradient through the
    combine's pivoted solves; one JAX reference, float64, for both
    dtypes)."""
    v_ref, g_ref = _loss_references()[name]
    arrays, ts, xs = _loss_inputs(name)
    v, g = _loss_port(name, arrays, dtype, ts, xs)
    f64 = dtype == "float64"
    v_ref = float(v_ref)
    assert abs(float(v) - v_ref) <= (1e-10 if f64 else 2e-5) * abs(v_ref)
    _close(g, g_ref, 1e-9 if f64 else 2e-3, name)


def _k2_counts():
    """Kernel 2's counters: (launches, launches_rows, launches_thread)."""
    k2 = expm_cuda.transition_and_noise_cuda
    return k2.launches, k2.launches_rows, k2.launches_thread


def _to_cuda_route(monkeypatch):
    """Resolve every backend but "torch" to "cuda": the kernel routes run
    on CPU tensors through the wrappers' plain twins."""
    orig = pt.resolve_backend
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")
    return orig


@pytest.mark.parametrize("name", ["kalman", "kalman_regular"])
def test_kernel_route_matches_torch(name, monkeypatch):
    """At float32 the kernel route (kernel 2's wrapper under
    `expm_cuda._TnDiff`, its twin on CPU tensors, the structured Pade-7
    replay as its backward) == backend="torch" (the Pade-13 emission
    under autograd): value to 1e-5, gradient to 1e-3 of each leaf's scale
    (two float32 Pade approximants of the same exponential); no launch is
    counted on CPU tensors."""
    arrays = _arrays(3, 2, seed=9)
    ts, xs = _grid(40, seed=10, kind="regular" if name == "kalman_regular"
                   else "irregular")
    v_t, g_t = _loss_port(name, arrays, "float32", ts, xs, backend="torch")
    before = _k2_counts()
    replays = []
    orig = expm_cuda.tn_replay_structured
    monkeypatch.setattr(expm_cuda, "tn_replay_structured",
                        lambda *a: replays.append(1) or orig(*a))
    _to_cuda_route(monkeypatch)
    v_k, g_k = _loss_port(name, arrays, "float32", ts, xs, backend="auto")
    assert replays, "the kernel route's backward did not run"
    assert _k2_counts() == before
    assert abs(float(v_k) - float(v_t)) <= 1e-5 * abs(float(v_t))
    _close(g_k, [x.numpy() for x in g_t], 1e-3, name)


def test_kalman_equals_cr_float64():
    """The Kalman loss == the precision-form "cr" loss at float64 to 1e-9
    (the contract of tests/test_likelihood.py:99: two exact
    decompositions of one likelihood), value and gradient; the blocked
    filter too (block 64 on 200 points)."""
    arrays = _arrays(4, 2, seed=11)
    ts, xs = _grid(200, seed=12)
    v_k, g_k = _loss_port("kalman", arrays, "float64", ts, xs)
    p = _port(arrays, "float64")
    for q in p.parameters():
        q.requires_grad_(True)
    v_c = loop.nll_loss(p, torch.tensor(ts), torch.tensor(xs))
    g_c = torch.autograd.grad(v_c, list(p.parameters()))
    assert abs(float(v_k) - float(v_c)) <= 1e-9 * abs(float(v_c))
    _close(g_k, g_c, 1e-9, "gradient")
    ssm = kalman.leg_to_ssm(p, torch.tensor(ts))
    ll_b = kalman.log_likelihood_blocked(ssm, torch.tensor(xs), 64)
    assert abs(float(-ll_b / xs.size) - float(v_c)) <= 1e-9 * abs(
        float(v_c))


# The seven regimes of tests/test_residual_loss.py, each perturbing one
# failure axis, at N = 256 (the chunked residual path: s = 32, C = 8),
# seeded with fixed numbers.
_REGIMES = {
    # name: (rank, obs, gaps, nscale, raw lambda)
    "baseline": (3, 1, "irregular", 1.0, None),
    "stiff_g": (3, 1, "irregular", 6.0, None),
    "small_lambda": (3, 1, "irregular", 1.0, -3.5),
    "long_gaps": (3, 1, "long", 1.0, None),
    "tiny_gaps": (3, 1, "tiny", 1.0, None),
    "mixed_gaps": (3, 1, "mixed", 1.0, None),
    "rank5_multi": (5, 3, "irregular", 1.0, None),
}
_N_REGIME = 256


def _regime(name, seed=None):
    rank, obs, kind, nscale, lam = _REGIMES[name]
    if seed is None:
        seed = 100 + list(_REGIMES).index(name)
    ts, xs = _grid(_N_REGIME, seed, kind=kind, obs=obs)
    return _arrays(rank, obs, seed, nscale=nscale, lam=lam), ts, xs


@pytest.mark.parametrize("name", list(_REGIMES))
def test_residual_matches_kalman_float64(name):
    """At float64 the port's residual loss == the port's Kalman loss (two
    exact organisations of one likelihood): value to 1e-9, gradient to
    1e-5 of each leaf's scale (float64 roundoff amplified by cond(K), which
    grows like 1/dt: ~1e-6 at the 2.5e-4 gaps of tiny_gaps, <= 1e-10
    elsewhere)."""
    arrays, ts, xs = _regime(name)
    v_k, g_k = _loss_port("kalman", arrays, "float64", ts, xs)
    v_r, g_r = _loss_port("cr_residual", arrays, "float64", ts, xs)
    assert abs(float(v_r) - float(v_k)) <= 1e-9 * abs(float(v_k))
    _close(g_r, g_k, 1e-5, name)


# tiny_gaps on a second seed (its first is 104): the open fault below shows
# there too
_TINY_SEED2 = 304
_CASES32 = [(name, None) for name in _REGIMES] + [("tiny_gaps", _TINY_SEED2)]


def _jax_regime_values(loss, name):
    """The JAX package's float32 ``loss`` ("residual" or "kalman") on
    every regime of ``name``'s shape (rank 5 for rank5_multi, rank 3 for
    the others, tiny_gaps on its second seed among them): one computation
    per shape and loss (each traces and compiles once), shared by the
    test workers, which compute the four side by side."""
    import jax.numpy as jnp

    from cyclic_gps_tpu.train import loop as jloop
    from torch_reference_cache import shared

    fn = {"residual": jloop.nll_loss_residual,
          "kalman": jloop.nll_loss_kalman}[loss]
    rank5 = name == "rank5_multi"

    def compute():
        out = {}
        for case, seed in _CASES32:
            if (case == "rank5_multi") != rank5:
                continue
            arrays, ts, xs = _regime(case, seed)
            out[f"{case}-{seed}"] = np.asarray(fn(
                _jax(arrays, "float32"), jnp.asarray(ts, "float32"),
                jnp.asarray(xs, "float32")))
        return out

    return shared(f"kalman_regimes_{loss}_{'rank5' if rank5 else 'rank3'}",
                  compute)


def _port32(name, seed=None):
    """The port's float32 (residual, Kalman) losses on the regime."""
    arrays, ts, xs = _regime(name, seed)
    with torch.no_grad():
        args = (_port(arrays, "float32"),
                torch.tensor(ts, dtype=torch.float32),
                torch.tensor(xs, dtype=torch.float32))
        return (float(loop.nll_loss_residual(*args)),
                float(loop.nll_loss_kalman(*args)))


@pytest.mark.parametrize("name", list(_REGIMES))
def test_float32_losses_match_jax(name, no_persistent_cache_writes):
    """At float32 the port's Kalman loss == its JAX twin on every regime
    to 1e-5 relative (float32 roundoff in each framework's op order).
    The residual loss is held against its twin in
    `test_float32_residual_matches_jax`."""
    k_ref = float(_jax_regime_values("kalman", name)[f"{name}-None"])
    _, k = _port32(name)
    assert abs(k - k_ref) <= 1e-5 * abs(k_ref), (k, k_ref)


# The port's float32 residual loss is NaN on tiny_gaps (gaps of 2.5e-4 to
# 1e-3) where JAX's is finite: K rounded to float32 is not positive
# definite there (the float64 engine on the port's float32 K fails too).
# JAX's finite value is itself off the exact filter by more than its own
# test's 3e-4 bar (tests/test_residual_loss.py), so there is no float32
# answer to agree with yet; an open fault (ROADMAP.md, Queue 3).
_TINY_FAULT = pytest.mark.xfail(
    strict=True, reason="open fault: the float32 residual loss is NaN on "
    "tiny gaps where JAX's is finite (ROADMAP.md, Queue 3)")


@pytest.mark.parametrize("name,seed", [
    pytest.param(name, seed, id=name if seed is None else f"{name}-{seed}",
                 marks=_TINY_FAULT if name == "tiny_gaps" else ())
    for name, seed in _CASES32])
def test_float32_residual_matches_jax(name, seed,
                                      no_persistent_cache_writes):
    """At float32 the port's residual loss == its JAX twin on the regime
    to 1e-4 relative (the eliminations amplify float32 roundoff by K's
    conditioning); the two formulations' float32 disagreement with each
    other is the reference's own (ROADMAP.md, Queue 3)."""
    r_ref = float(_jax_regime_values("residual", name)[f"{name}-{seed}"])
    r, _ = _port32(name, seed)
    assert math.isfinite(r), (r, r_ref)
    assert abs(r - r_ref) <= 1e-4 * abs(r_ref), (r, r_ref)


def _tiny_gaps_k():
    """JAX's _k_system_chunked (K and its off-diagonal blocks,
    chunk-major, s = 32) on tiny_gaps at both seeds, float32 and
    float64, shared by the test workers."""
    import jax
    import jax.numpy as jnp

    from cyclic_gps_tpu.models import leg as jleg
    from torch_reference_cache import shared

    def compute():
        fn = jax.jit(lambda p, t, x: jleg._k_system_chunked(p, t, x, 32,
                                                            False)[:2])
        out = {}
        for seed in (None, _TINY_SEED2):
            arrays, ts, xs = _regime("tiny_gaps", seed)
            for dtype in ("float32", "float64"):
                out[f"{seed}-{dtype}"] = fn(
                    _jax(arrays, dtype), jnp.asarray(ts, dtype),
                    jnp.asarray(xs, dtype))
        return out

    return shared("tiny_gaps_k", compute)


def _k_error(k32, k64):
    """max over K and its off-diagonal blocks of |K32 - K64| / max|K64|."""
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - b))
                     / np.max(np.abs(b)))
               for a, b in zip(k32, k64))


@pytest.mark.parametrize("seed", [None, _TINY_SEED2],
                         ids=["104", str(_TINY_SEED2)])
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_float32_k_on_tiny_gaps(seed, route, monkeypatch,
                                no_persistent_cache_writes):
    """On tiny_gaps (the regime where both packages' float32 residual
    loss can fail, `test_float32_residual_matches_jax`) the port's
    float32 K is no worse than JAX's: its error against the float64 K
    (JAX's, of scale, over K and its off-diagonal blocks) is within 2x
    JAX's own float32 K's, on the plain route and on the kernel route's
    glue (kernels 2 and 3's twins).  K rounded to float32 at ~1e7 scale
    loses positive definiteness by chance in either package (ROADMAP.md,
    Queue 3): a limit the port shares with the reference."""
    refs = _tiny_gaps_k()
    k64 = [np.asarray(x) for x in refs[f"{seed}-float64"]]
    err_jax = _k_error(refs[f"{seed}-float32"], k64)
    arrays, ts, xs = _regime("tiny_gaps", seed)
    if route == "cuda":
        _to_cuda_route(monkeypatch)
    with torch.no_grad():
        k32 = leg._k_system_chunked(
            _port(arrays, "float32"), torch.tensor(ts, dtype=torch.float32),
            torch.tensor(xs, dtype=torch.float32), 32, False,
            backend=route)[:2]
    err = _k_error([x.numpy() for x in k32], k64)
    assert err <= 2.0 * err_jax, (err, err_jax)


# ---------------------------------------------------------------------------
# fit's default loss.
# ---------------------------------------------------------------------------


def _jax_default(arrays, ts, xs):
    """What JAX's fit(loss=None) picks at float32 (its train/loop.py:
    the grid rule, then the steady-state check on uniform grids of more
    than 8 SS_T0 points), with the check's residual."""
    import jax.numpy as jnp

    from cyclic_gps_tpu.baselines import kalman as jk
    from cyclic_gps_tpu.train import loop as jloop

    p = _jax(arrays, "float32")
    jts = jnp.asarray(ts, "float32")
    ssm0 = jk.leg_to_ssm(p, jts[: jloop.SS_T0 + 2], regular=True)
    gap = jk.steady_state_gap(ssm0.a[0], ssm0.q[0], ssm0.h, ssm0.r,
                              t0=jloop.SS_T0 // 2)
    return ("kalman_ss" if xs.shape[0] > 8 * jloop.SS_T0 and gap < 1e-6
            else "kalman_regular"), gap


@pytest.mark.parametrize("case", ["converged", "slow"])
def test_default_loss_on_long_uniform_grid(case):
    """On a uniform float32 grid of 16,385 points fit(loss=None) picks
    what JAX picks: "kalman_ss" where the Riccati recursion at the initial
    parameters has converged, and "kalman_regular" for a process so slow
    that it has not; either way a step of the picked loss runs, finite.
    The steady-state residual == JAX's to 1e-3 of itself plus 1e-7
    (float32: a converged recursion's residual is roundoff, ~1e-8, which
    each framework rounds its own way)."""
    nscale = 1.0 if case == "converged" else 0.01
    arrays = _arrays(2, 1, seed=13, nscale=nscale)
    n = 8 * loop.SS_T0 + 1
    ts, xs = _grid(n, seed=14, kind="regular", obs=1)
    want, gap_ref = _jax_default(arrays, ts, xs)
    assert want == ("kalman_ss" if case == "converged" else
                    "kalman_regular")
    p = _port(arrays, "float32")
    ts_t = torch.tensor(ts, dtype=torch.float32)
    xs_t = torch.tensor(xs, dtype=torch.float32)
    assert loop._default_loss(ts_t, xs_t) == "kalman_regular"
    assert loop._steady_state_loss(p, ts_t, xs_t, "kalman_regular") == want
    ssm0 = kalman.leg_to_ssm(p, ts_t[:loop.SS_T0 + 2], regular=True)
    gap = kalman.steady_state_gap(ssm0.a[0].detach(), ssm0.q[0].detach(),
                                  ssm0.h.detach(), ssm0.r.detach(),
                                  t0=loop.SS_T0 // 2)
    assert abs(gap - gap_ref) <= 1e-3 * gap_ref + 1e-7
    res = loop.fit(p, ts_t, xs_t, num_steps=1, log_every=0)
    assert np.isfinite(res.losses[0])


def test_steady_state_gap_matches_jax():
    """steady_state_gap == the JAX function at float64 (t0 = 64) to 1e-9
    of itself: the same Riccati steps."""
    import jax.numpy as jnp

    from cyclic_gps_tpu.baselines import kalman as jk

    arrays = _arrays(3, 2, seed=15)
    ts, _ = _grid(4, seed=16, kind="regular")
    ref_ssm = jk.leg_to_ssm(_jax(arrays, "float64"), jnp.asarray(ts),
                            regular=True)
    ref = jk.steady_state_gap(ref_ssm.a[0], ref_ssm.q[0], ref_ssm.h,
                              ref_ssm.r, t0=64)
    ssm = kalman.leg_to_ssm(_port(arrays, "float64"), torch.tensor(ts),
                            regular=True)
    got = kalman.steady_state_gap(ssm.a[0].detach(), ssm.q[0].detach(),
                                  ssm.h.detach(), ssm.r.detach(), t0=64)
    assert ref > 0 and abs(got - ref) <= 1e-9 * ref


# ---------------------------------------------------------------------------
# On the card: kernel 2's two designs against its twin, and its launch
# counters on every path.
# ---------------------------------------------------------------------------

_ROUNDS = (0, 1, 2, 3, 5, 7, 9)  # squaring rounds of the mixed gaps


def _mixed_gaps(g, m, seed):
    """m float32 gaps, each 32 consecutive ones mixing `_ROUNDS` squaring
    rounds and gaps just inside and just outside the Van Loan branch
    (dt ||G/2|| = 0.9 and 1.1), scaled by seeded factors in [0.9, 1]."""
    _, half, augn = expm_cuda._generator_norms(g.double().cpu())
    half, augn = float(half), float(augn)
    kinds = [3.92 * 2.0 ** (n - 0.5) / augn if n else 1.96 / augn
             for n in _ROUNDS] + [0.9 / half, 1.1 / half]
    rng = np.random.RandomState(seed)
    dt = np.array(kinds)[np.arange(m) % len(kinds)] * rng.uniform(0.9, 1.0,
                                                                   m)
    return torch.as_tensor(dt, dtype=torch.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_design_table():
    """Kernel 2's design table: R lanes a gap up to TN_ROWS_MAX_M gaps,
    one thread a gap above (chip_smoke.py's [tn-pick] times both on the
    card on both sides of the bound)."""
    m = expm_cuda.TN_ROWS_MAX_M
    assert [expm_cuda._tn_design(x) for x in (1, m, m + 1, 10 ** 6)] == [
        "rows", "rows", "thread", "thread"]


@pytest.mark.cuda
@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("m", [1, 31, 32, 33, 7813, 65536, 131072])
def test_emission_on_card(card, r, m):
    """Kernel 2, both designs, == its plain twin on gaps of both branches
    and 0-9 squaring rounds (rtol 1e-4, atol 1e-6: chip_smoke.py's bar;
    the same float32 Pade-7); the wrapper launches once, on the design the
    table picks at m."""
    p = leg.init_params(r, 2, generator=torch.Generator().manual_seed(r),
                        device=card)
    with torch.no_grad():
        g = leg.g_matrix(p).contiguous()
    dt = _mixed_gaps(g, m, seed=10 * r + m).to(card)
    before = _k2_counts()
    got = expm_cuda.transition_and_noise_cuda(g, dt)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_k2_counts(), before))
    assert moved == ((1, 1, 0) if expm_cuda._tn_design(m) == "rows"
                     else (1, 0, 1))
    ref = expm_cuda.transition_and_noise_plain(g, dt)
    outs = [got] + [expm_cuda._tn_launch(d, g, dt)
                    for d in ("rows", "thread")]
    for out in outs:
        for a, b in zip(out, ref):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["log_likelihood", "posterior", "residual",
                                  "kalman", "kalman_regular", "predictions"])
def test_every_path_launches_kernel_2(card, path, monkeypatch):
    """Each path that launches kernel 2 (the likelihood's chunk-crossing
    gaps, the posterior's, the residual loss's Markov quadratic, the
    Kalman losses' every gap, intercast's target gaps) launches it at
    least once, and each launch counts on the design the table picks at
    its gap count."""
    p = leg.init_params(5, 2, generator=torch.Generator().manual_seed(0),
                        device=card)
    ts, xs = _grid(4096, seed=17, kind="regular" if path == "kalman_regular"
                   else "irregular")
    ts = torch.tensor(ts, dtype=torch.float64, device=card)
    xs = torch.tensor(xs, dtype=torch.float32, device=card)
    sizes = []
    pick = expm_cuda._tn_design
    monkeypatch.setattr(expm_cuda, "_tn_design",
                        lambda m: sizes.append(m) or pick(m))
    before = _k2_counts()
    if path == "log_likelihood":
        v = leg.log_likelihood(p, ts, xs)
    elif path == "posterior":
        with torch.no_grad():
            v = leg.insample_posterior(p, ts, xs, method="precision")[0]
    elif path == "residual":
        v = loop.nll_loss_residual(p, ts, xs)
    elif path == "predictions":
        with torch.no_grad():
            v = leg.make_predictions(p, ts, xs, 0.5 * (ts[1:] + ts[:-1]),
                                     method="precision")[0]
    else:
        v = loop.LOSSES[path](p, ts, xs)
    if v.requires_grad:
        v.sum().backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(v).all())
    n, w, t = (a - b for a, b in zip(_k2_counts(), before))
    assert n > 0 and n == len(sizes)
    assert w == sum(pick(m) == "rows" for m in sizes) and w + t == n
