"""PyTorch port vs the JAX package: the stacked multi-series entries
(cyclic_gps_tpu_torch/models/leg.py, train/loop.py).

B independent series stacked into one block-tridiagonal system with the
series-boundary gaps masked.  On the CPU the port's stacked likelihood
(value and gradient), per-series likelihoods (and their Kalman twin),
stacked posteriors and batched predictions are held against the JAX
package's on the same numpy-seeded inputs at float64; the stacked value
against the sum of the series' own likelihoods; the mask through the
kernel routes (`_KGapParts`, `_GapMahalFused`, with the kernels' plain
twins on CPU tensors) against JAX's masked XLA assembly.  JAX is imported
inside the CPU references only, so the card tests (marked ``cuda``: each
of kernels 1-11 on the inputs the stacked paths hand it, under a series
mask, against its twin) collect without it:
``python -m pytest --noconftest tests/test_torch_stacked.py -m cuda``.
"""

import functools
import math

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda
from cyclic_gps_tpu_torch.train import loop

torch.set_num_threads(1)

_LENGTHS = (110, 75, 140)  # ragged, irregular; 325 points, s = 32, C = 11
_BATCH = (3, 96, 17)  # make_predictions_batch: B series of n, P targets


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


def _series(lengths, seed, obs=2):
    """Per-series (ts, xs) made with numpy (gaps 0.125-0.5, each series
    starting at its own offset: timestamps restart at the boundaries) and
    the stacked (ts, xs, ids)."""
    rng = np.random.RandomState(seed)
    parts = [(rng.rand() * 3.0 + np.cumsum(rng.randint(1, 5, n) * 0.125),
              rng.randn(n, obs)) for n in lengths]
    return (parts, np.concatenate([t for t, _ in parts]),
            np.concatenate([x for _, x in parts]),
            np.repeat(np.arange(len(lengths)), lengths))


def _inputs():
    return (_arrays(3, 2, seed=41), *_series(_LENGTHS, seed=42))


def _batch_inputs():
    b, nb, p = _BATCH
    rng = np.random.RandomState(43)
    return (_arrays(3, 2, seed=44),
            np.sort(rng.rand(b, nb) * 20, axis=1) + 1.0,
            rng.randn(b, nb, 2),
            # targets before, inside and after each series' range
            np.sort(rng.rand(b, p) * 26, axis=1) - 2.0)


def _port(arrays, dtype=torch.float64, grad=False):
    p = leg.LEGParams(*(torch.tensor(a, dtype=dtype) for a in arrays))
    for q in p.parameters():
        q.requires_grad_(grad)
    return p


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


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


def _reference(key):
    """The JAX package's stacked entries at float64 on `_inputs` (and
    `_batch_inputs`), one JAX computation per entry, each computed once
    per run and shared by the test workers."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        from cyclic_gps_tpu.models import leg as jleg

        arrays, _, ts, xs, ids = _inputs()
        args = (_jax(arrays), jnp.asarray(ts), jnp.asarray(xs),
                jnp.asarray(ids, jnp.int32))
        if key == "stacked":
            v, g = jax.value_and_grad(
                lambda p: jleg.log_likelihood_stacked(p, *args[1:]))(args[0])
            return v, list(g)
        if key == "per_series":
            return jleg.log_likelihood_per_series(
                *args, num_series=len(_LENGTHS))
        if key == "posterior":
            return jleg.insample_posterior_stacked(*args)
        arrays, ts_b, xs_b, tg_b = _batch_inputs()
        return jleg.make_predictions_batch(
            _jax(arrays), jnp.asarray(ts_b), jnp.asarray(xs_b),
            jnp.asarray(tg_b), include_obs_noise=True)

    return shared(f"stacked_{key}", compute)


def _to_cuda_route(monkeypatch, route):
    """On the "cuda" route every backend but "torch" resolves to "cuda":
    the kernel routes run on CPU tensors through the wrappers' plain
    twins (the emission kernels 2-5 take float32 only, so at float64
    their tensor code runs)."""
    if route == "cuda":
        monkeypatch.setattr(pt, "resolve_backend",
                            lambda b, t: "torch" if b == "torch" else "cuda")


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_stacked_matches_jax(route, monkeypatch, no_persistent_cache_writes):
    """log_likelihood_stacked on three ragged irregular series (timestamps
    restarting at each boundary) == JAX's at float64: the value to 1e-9
    relative and each gradient leaf to 1e-9 of its scale; the value ==
    the sum of the series' own log_likelihood to 1e-10 relative and the
    gradient == the sum of theirs to 1e-9; log_likelihood_batch ==
    log_likelihood_stacked with consecutive ids; stack_series builds the
    stacked arrays."""
    v_ref, g_ref = _reference("stacked")
    arrays, parts, ts, xs, ids = _inputs()
    _to_cuda_route(monkeypatch, route)
    p = _port(arrays, grad=True)
    v = leg.log_likelihood_stacked(p, _t(ts), _t(xs), _t(ids, torch.int64))
    g = torch.autograd.grad(v, list(p.parameters()))
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref))
    _close(g, g_ref, 1e-9, "gradient")
    own = [leg.log_likelihood(p, _t(t), _t(x)) for t, x in parts]
    v_sum = sum(float(x) for x in own)
    assert abs(float(v) - v_sum) <= 1e-10 * abs(v_sum)
    g_sum = [sum(x) for x in zip(*(torch.autograd.grad(
        x, list(p.parameters())) for x in own))]
    _close(g, g_sum, 1e-9, "gradient vs the series'")
    ts2, xs2, ids2 = leg.stack_series([(_t(t), _t(x)) for t, x in parts])
    assert torch.equal(ts2, _t(ts)) and torch.equal(xs2, _t(xs))
    assert torch.equal(ids2, _t(ids, torch.int64))
    with torch.no_grad():  # the first 70 points of each series
        ts_b = _t(np.stack([t[:70] for t, _ in parts]))
        xs_b = _t(np.stack([x[:70] for _, x in parts]))
        batch = leg.log_likelihood_batch(p, ts_b, xs_b)
        flat = leg.log_likelihood_stacked(
            p, ts_b.reshape(-1), xs_b.reshape(-1, 2),
            torch.arange(3).repeat_interleave(70))
    assert bool(torch.isfinite(batch)) and float(batch) == float(flat)


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_per_series_matches_jax(route, monkeypatch,
                                no_persistent_cache_writes):
    """log_likelihood_per_series == JAX's vector at float64 to 1e-9
    relative per entry, and sums to the stacked value (1e-11); its Kalman
    twin (loop.log_likelihood_per_series_kalman, the boundary-masked
    filter's rows summed by series) == the same JAX vector to 1e-9, and
    loop.nll_loss_kalman_stacked == -sum / size to 1e-9 (two exact
    decompositions of each series' likelihood); the gradient of a
    weighted sum of the per-series values == the weighted sum of the
    series' own gradients (1e-7 of scale: the per-row log-dets' analytic
    adjoint is exact for series-constant weights over decoupled series)."""
    ref = np.asarray(_reference("per_series"))
    arrays, parts, ts, xs, ids = _inputs()
    _to_cuda_route(monkeypatch, route)
    p = _port(arrays, grad=True)
    args = (_t(ts), _t(xs), _t(ids, torch.int64))
    ll_b = leg.log_likelihood_per_series(p, *args, num_series=3)
    np.testing.assert_allclose(ll_b.detach().numpy(), ref, rtol=1e-9)
    with torch.no_grad():
        stacked = float(leg.log_likelihood_stacked(p, *args))
        kal = loop.log_likelihood_per_series_kalman(p, *args, num_series=3)
        nll_k = float(loop.nll_loss_kalman_stacked(p, *args))
    assert abs(float(ll_b.sum()) - stacked) <= 1e-11 * abs(stacked)
    np.testing.assert_allclose(kal.numpy(), ref, rtol=1e-9)
    assert abs(nll_k + ref.sum() / xs.size) <= 1e-9 * abs(ref.sum() /
                                                          xs.size)
    w = torch.tensor([0.3, -1.7, 2.1], dtype=torch.float64)
    g = torch.autograd.grad(torch.sum(w * ll_b), list(p.parameters()))
    g_ref = [sum(x) for x in zip(*(
        [float(wi) * y for y in torch.autograd.grad(
            leg.log_likelihood(p, _t(t), _t(x)), list(p.parameters()))]
        for wi, (t, x) in zip(w, parts)))]
    _close(g, g_ref, 1e-7, "weighted gradient")


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_stacked_posteriors_match_jax(route, monkeypatch,
                                      no_persistent_cache_writes):
    """insample_posterior_stacked and posterior_mean_stacked == JAX's
    insample_posterior_stacked at float64 (1e-9 of each output's scale);
    the cross-covariances at the two series boundaries are exactly zero
    (independent series)."""
    ref = _reference("posterior")
    arrays, _, ts, xs, ids = _inputs()
    _to_cuda_route(monkeypatch, route)
    p = _port(arrays)
    args = (_t(ts), _t(xs), _t(ids, torch.int64))
    with torch.no_grad():
        got = leg.insample_posterior_stacked(p, *args)
        mean = leg.posterior_mean_stacked(p, *args)
    _close(got, ref, 1e-9, "insample_posterior_stacked")
    _close([mean], ref[:1], 1e-9, "posterior_mean_stacked")
    for cut in np.cumsum(_LENGTHS)[:-1]:
        assert float(got[2][cut - 1].abs().max()) == 0.0


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_make_predictions_batch_matches_jax(route, monkeypatch,
                                            no_persistent_cache_writes):
    """make_predictions_batch (one stacked posterior, one intercast over
    all B P targets) == JAX's (its intercast vmapped over the series) at
    float64, with observation noise, targets before, inside and after
    each series: 1e-9 of each output's scale; and == each series' own
    make_predictions(method="precision") to 1e-9."""
    ref = _reference("predictions")
    arrays, ts_b, xs_b, tg_b = _batch_inputs()
    _to_cuda_route(monkeypatch, route)
    p = _port(arrays)
    with torch.no_grad():
        got = leg.make_predictions_batch(p, _t(ts_b), _t(xs_b), _t(tg_b),
                                         include_obs_noise=True)
        _close(got, ref, 1e-9, "make_predictions_batch")
        for i in range(ts_b.shape[0]):
            own = leg.make_predictions(p, _t(ts_b[i]), _t(xs_b[i]),
                                       _t(tg_b[i]), include_obs_noise=True,
                                       method="precision")
            _close([got[0][i], got[1][i]], own, 1e-9, f"series {i}")


def _masked_k_reference():
    """JAX's masked XLA assembly `_k_gap_parts_xla` (rank 3, s = 8,
    n = 230 in four series, the mask of their boundaries; test_batched's
    shapes) at float64: (k_cm, off_cm, lq_cm) and the gradients with
    respect to (g, boost) of a seeded weighted sum of them."""
    from torch_reference_cache import shared

    def compute():
        import jax
        import jax.numpy as jnp

        from cyclic_gps_tpu.models import leg as jleg

        g, boost, ts, mask, w_k, w_o = (jnp.asarray(a)
                                        for a in _masked_inputs())

        def parts(g_, b_):
            return jleg._k_gap_parts_xla(g_, b_, ts, 8, False, 3,
                                         jnp.float64, gap_mask=mask)

        def loss(g_, b_):
            k, o, lq = parts(g_, b_)
            return jnp.sum(k * w_k) + jnp.sum(o * w_o) + 0.7 * jnp.sum(lq)

        def both(g_, b_):
            return parts(g_, b_), jax.grad(loss, argnums=(0, 1))(g_, b_)

        k_parts, grads = jax.jit(both)(g, boost)
        return list(k_parts), list(grads)

    return shared("stacked_masked_k", compute)


def _masked_inputs():
    """(g, boost, ts, mask, w_k, w_o) as float64 numpy: LEG rank 3 / obs
    2 parameters made with numpy, 230 timestamps in four series of 70,
    60, 55 and 45 (each restarting), their boundary mask, and seeded
    weights of K's and the off blocks' entries."""
    arrays = _arrays(3, 2, seed=45)
    p = _port(arrays)
    with torch.no_grad():
        g = leg.g_matrix(p)
        llt = leg.lambda_lambda_t(p)
        boost = p.b.T @ torch.linalg.solve(llt, p.b)
    parts, ts, _, ids = _series((70, 60, 55, 45), seed=46)
    mask = leg._series_gap_mask(_t(ids, torch.int64)).double()
    rng = np.random.RandomState(47)
    c = -(-230 // 8)
    return (g.numpy(), boost.numpy(), ts, mask.numpy(),
            rng.randn(8, 3, 3, c), rng.randn(8, 3, 3, c))


def test_masked_kernel_routes_match_jax(monkeypatch,
                                        no_persistent_cache_writes):
    """The series mask through the kernel routes at float32 (kernels 2-5
    by their plain twins on CPU tensors): `_KGapParts` (the K system
    kernel's route) == JAX's masked XLA assembly (float64) in values
    (rtol 1e-3, atol 1e-4 of scale: K ~ Q1^{-1} amplifies float32
    rounding; tests/test_batched.py's kernel bar) and in the gradients of
    a weighted sum with respect to (g, boost) through the adjoint twin
    (2e-3 of scale); the stacked likelihood on the fused route
    (`_GapMahalFused`, kernel 4's twin) and its gradient (the masked
    two-kernel replay) == the float64 JAX stacked likelihood (2e-5
    relative; gradient leaves 5e-3 of scale: float32 sums over 325 rows),
    and the masks reached both routes."""
    (k_ref, g_ref) = _masked_k_reference()
    g, boost, ts, mask, w_k, w_o = (torch.tensor(a) for a in
                                    _masked_inputs())
    g, boost = g.float().requires_grad_(), boost.float().requires_grad_()
    k, o, lq = leg._KGapParts.apply(g, boost, ts.float(), mask.float(), 8)
    _close([k, o, lq], k_ref, 1e-3, "K parts")
    loss = (torch.sum(k * w_k.float()) + torch.sum(o * w_o.float())
            + 0.7 * torch.sum(lq))
    _close(torch.autograd.grad(loss, [g, boost]), g_ref, 2e-3, "adjoint")
    assert float(lq[69 % 8, 69 // 8]) == 0.0  # the first boundary gap

    v_ref, gr_ref = _reference("stacked")
    arrays, _, ts, xs, ids = _inputs()
    _to_cuda_route(monkeypatch, "cuda")
    masks = []
    fused = leg._GapMahalFused.apply
    monkeypatch.setattr(leg._GapMahalFused, "apply",
                        lambda *a: masks.append(a[3]) or fused(*a))
    p = _port(arrays, torch.float32, grad=True)
    v = leg.log_likelihood_stacked(p, _t(ts), _t(xs, torch.float32),
                                   _t(ids, torch.int64))
    grads = torch.autograd.grad(v, list(p.parameters()))
    assert len(masks) == 1 and int(masks[0].sum()) == sum(_LENGTHS) - 3
    assert abs(float(v) - float(v_ref)) <= 2e-5 * abs(float(v_ref))
    _close(grads, gr_ref, 5e-3, "fused gradient")


def test_stacked_training(no_persistent_cache_writes):
    """train_step_stacked: the "cr" step's loss == -JAX's stacked
    log-likelihood / size and the "kalman" step's the same to 1e-9
    (float64, the same parameters); fit_stacked descends on an
    equal-length regular batch (finite, the last 4 of 12 losses below the
    first); an unknown loss raises ValueError and LBFGS stays refused."""
    v_ref, _ = _reference("stacked")
    arrays, _, ts, xs, ids = _inputs()
    want = -float(v_ref) / xs.size
    args = (_t(ts), _t(xs), _t(ids, torch.int64))
    for name in ("cr", "kalman"):
        p = _port(arrays, grad=True)
        opt = loop.make_optimizer("adam", 1e-2, reduce_on_plateau=False)
        got = float(loop.train_step_stacked(p, opt, *args, loss=name))
        assert abs(got - want) <= 1e-9 * abs(want), name
    with pytest.raises(ValueError, match="unknown loss"):
        loop.train_step_stacked(p, opt, *args, loss="kalman_ss")
    b, nb = 3, 80
    rng = np.random.RandomState(5)
    ts_b = rng.rand(b, 1) * 10 + 0.25 * np.arange(nb)[None, :]
    p = _port(arrays, grad=True)
    res = loop.fit_stacked(p, _t(ts_b).reshape(-1),
                           _t(rng.randn(b * nb, 2)),
                           torch.arange(b).repeat_interleave(nb),
                           num_steps=12, log_every=0, regular=True)
    assert np.isfinite(res.losses).all()
    assert max(res.losses[-4:]) < res.losses[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.make_optimizer("lbfgs")


# ---------------------------------------------------------------------------
# On the card: kernels 1-11 on the inputs the stacked paths hand them.
# ---------------------------------------------------------------------------

_CARD_KERNELS = {
    # key: (module, wrapper stem, rtol, atol of each output's scale)
    "transition_and_noise": (expm_cuda, 1e-4, 1e-6),
    "k_system": (expm_cuda, 1e-3, 1e-4),
    "gap_mahal_sweep": (expm_cuda, 1e-3, 1e-4),
    "k_system_adjoint": (expm_cuda, 1e-3, 1e-4),
    "forward_sweep": (sweep_cuda, 1e-3, 1e-4),
    "forward_sweep_solveinv": (sweep_cuda, 1e-3, 1e-4),
    "backward_solve_takahashi": (sweep_cuda, 1e-3, 1e-4),
    "forward_sweep_collect": (sweep_cuda, 1e-3, 1e-4),
    "backward_substitute": (sweep_cuda, 1e-3, 1e-4),
    "forward_sweep_inverse": (sweep_cuda, 1e-3, 1e-4),
    "takahashi_backward": (sweep_cuda, 1e-3, 1e-4),
}
_LEG_NAMES = ("transition_and_noise", "k_system", "gap_mahal_sweep",
              "k_system_adjoint")  # imported into models/leg.py


@pytest.fixture(scope="module")
def stacked_kernel_inputs():
    """Each kernel's largest call on the card while the stacked paths run
    (rank 5, obs 2, float32, 12 series of seeded lengths 300-1,900, so
    that boundaries fall inside chunks and on wrap rows): the stacked
    likelihood and its gradient (kernels 2-7 and 1 in the replayed
    two-kernel route), then insample_posterior_stacked (2, 3, 8-11)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    card = torch.device("cuda", 0)
    rng = np.random.RandomState(48)
    lengths = tuple(int(n) for n in rng.randint(300, 1900, 12))
    _, ts, xs, ids = _series(lengths, seed=49)
    ts, xs = _t(ts).to(card), _t(xs, torch.float32).to(card)
    ids = _t(ids, torch.int64).to(card)
    p = leg.init_params(5, 2, generator=torch.Generator().manual_seed(50),
                        device=card)
    captured = {}
    mp = pytest.MonkeyPatch()
    for key, (module, _, _) in _CARD_KERNELS.items():
        owner = leg if key in _LEG_NAMES else module
        orig = getattr(owner, f"{key}_cuda")

        # the wrapper counts its launches on the name it is called
        # through: the spy carries its counters (functools.wraps)
        @functools.wraps(orig)
        def spy(*args, _orig=orig, _key=key, **kw):
            size = max(a.numel() for a in args if isinstance(a,
                                                            torch.Tensor))
            if _key not in captured or size > captured[_key][2]:
                captured[_key] = (args, kw, size)
            return _orig(*args, **kw)

        mp.setattr(owner, f"{key}_cuda", spy)
    try:
        v = leg.log_likelihood_stacked(p, ts, xs, ids)
        torch.autograd.grad(v, list(p.parameters()))
        with torch.no_grad():
            leg.insample_posterior_stacked(p, ts, xs, ids)
        torch.cuda.synchronize()
    finally:
        mp.undo()
    return captured


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(_CARD_KERNELS))
def test_kernel_under_series_mask_on_card(stacked_kernel_inputs, key):
    """Kernel ``key`` on the inputs the stacked paths hand it (boundary
    gaps masked in the middle of chunks and on wrap rows) == its plain
    twin: rtol and atol of each output's scale as chip_smoke.py's
    [kernels] bars (kernel 5's c_dt, which cancels terms far larger than
    itself, against the float64 twin)."""
    module, rtol, atol = _CARD_KERNELS[key]
    args, kw, _ = stacked_kernel_inputs[key]
    with torch.no_grad():
        got = getattr(module, f"{key}_cuda")(*args, **kw)
        f64 = key == "k_system_adjoint"
        ref = getattr(module, f"{key}_plain")(
            *[a.double() if f64 and isinstance(a, torch.Tensor) else a
              for a in args], **kw)
        torch.cuda.synchronize()
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    ref = (ref,) if isinstance(ref, torch.Tensor) else tuple(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.double().cpu(), b.double().cpu()
        assert bool(torch.isfinite(a).all()), f"{key} out {i}"
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol * scale,
                                   msg=f"{key} out {i}")
