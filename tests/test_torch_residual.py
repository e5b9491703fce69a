"""PyTorch port vs the JAX package: the float32-safe residual likelihood
(`leg.log_likelihood_residual`) and the training loss that picks it
(`train.loop.nll_loss_residual`, ``"cr_residual"``).

Inputs are made with numpy (or the JAX package's seeded initialiser) and
handed to both packages; the JAX references are shared between the test
workers (`torch_reference_cache.shared`).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.data.synthetic import generate_data as jgenerate_data
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu_torch.convert import params_from_jax
from cyclic_gps_tpu_torch.data.synthetic import generate_data
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.train import loop
from torch_reference_cache import shared

torch.set_num_threads(1)


def _value_and_grads(fn, p, ts, xs):
    v = fn(p, ts, xs)
    g = torch.autograd.grad(v, list(p.parameters()))
    return float(v.detach()), [t.numpy() for t in g]


def _jax_value_and_grads(fn, jp, ts, xs):
    v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(ts),
                                           jnp.asarray(xs)))(jp)
    return v, list(g)


def _check(value, grads, ref_value, ref_grads, rtol, g_rtol, g_atol):
    np.testing.assert_allclose(value, float(ref_value), rtol=rtol)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a, np.asarray(b), rtol=g_rtol,
                                   atol=g_atol)


def _parity_case():
    """tests/test_likelihood.py's residual case: N = 400 irregular (above
    the chunked threshold, s = 32), rank 3, obs 2, float64."""
    ts, xs = jgenerate_data(400, 2, dtype=jnp.float64, spacing="irregular",
                            seed=3)
    jp = jleg.init_params(jax.random.key(1), rank=3, obs_dim=2,
                          dtype=jnp.float64)
    return jp, np.asarray(ts), np.asarray(xs)


def test_residual_matches_jax_f64():
    """The port's residual likelihood and its gradient equal the JAX
    package's at float64 (values rtol 1e-10, gradients rtol 1e-7 / atol
    1e-10: the bars of tests/test_likelihood.py), and equal the port's own
    `log_likelihood` at the same bars: the variational mahalanobis and
    the per-row-paired log-det are identities, not approximations."""
    jp, ts, xs = _parity_case()
    ref_v, ref_g = shared("residual_f64_n400", lambda: _jax_value_and_grads(
        jleg.log_likelihood_residual, jp, ts, xs))
    p = params_from_jax(jp, device="cpu")
    t_ts, t_xs = generate_data(400, 2, dtype=torch.float64,
                               spacing="irregular", seed=3, device="cpu")
    np.testing.assert_array_equal(t_ts.numpy(), ts)
    v, g = _value_and_grads(leg.log_likelihood_residual, p, t_ts, t_xs)
    _check(v, g, ref_v, ref_g, 1e-10, 1e-7, 1e-10)
    v_cr, g_cr = _value_and_grads(leg.log_likelihood, p, t_ts, t_xs)
    _check(v, g, v_cr, g_cr, 1e-10, 1e-7, 1e-10)


def test_residual_below_threshold_is_log_likelihood():
    """Below the chunked threshold (N < 64) the residual form is
    `log_likelihood` itself, as in the JAX package."""
    jp, _, _ = _parity_case()
    p = params_from_jax(jp, device="cpu")
    ts, xs = generate_data(40, 2, dtype=torch.float64, seed=4,
                           device="cpu")
    with torch.no_grad():
        assert float(leg.log_likelihood_residual(p, ts, xs)) == float(
            leg.log_likelihood(p, ts, xs))


def test_residual_f32_smooth_regime():
    """tests/test_likelihood.py's float32 smooth-fit regime (tight gaps,
    small observation noise, cond(K) ~ 1e6+): the port's float32 residual
    likelihood stays within 5e-4 (relative) of the float64 value, the
    JAX test's bar."""
    rng = np.random.RandomState(7)
    n = 2048
    ts64 = np.cumsum(1e-4 + 2e-4 * rng.rand(n))
    jp = jleg.init_params(jax.random.key(2), rank=2, obs_dim=1,
                          dtype=jnp.float64, prior_length_scale=0.05)
    xs64 = (np.sin(2 * np.pi * ts64 * 3.0)[:, None]
            + 0.02 * rng.randn(n, 1))
    p64 = params_from_jax(jp, device="cpu")
    p32 = loop.params_from_arrays(
        *(t.detach().numpy() for t in p64.parameters()),
        dtype=torch.float32, device="cpu")
    with torch.no_grad():
        ref = float(leg.log_likelihood(p64, torch.tensor(ts64),
                                       torch.tensor(xs64)))
        got = float(leg.log_likelihood_residual(
            p32, torch.tensor(ts64, dtype=torch.float32),
            torch.tensor(xs64, dtype=torch.float32)))
    assert np.isfinite(got)
    assert abs(got - ref) / abs(ref) < 5e-4, (got, ref)


# tests/test_residual_loss.py's three hard regimes, seeded by
# zlib.crc32(name) (that file seeds from the salted hash(name))
_N_REGIME = 2048


def _regime(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    rank, obs = (5, 3) if name == "rank5_multi" else (3, 1)
    jp = jleg.init_params(jax.random.key(7), rank=rank, obs_dim=obs,
                          dtype=jnp.float64)
    jp = jp._replace(n_params=jnp.asarray(rng.randn(*jp.n_params.shape)))
    grid = np.random.RandomState(11)
    if name == "tiny_gaps":
        gaps = grid.randint(1, 5, _N_REGIME) * 2.5e-4
    elif name == "mixed_gaps":
        gaps = np.where(grid.rand(_N_REGIME) < 0.5, 1e-3, 10.0)
    else:
        gaps = grid.randint(1, 5, _N_REGIME) * 0.125
    return jp, np.cumsum(gaps), rng.randn(_N_REGIME, obs)


@pytest.mark.parametrize("name", ["tiny_gaps", "mixed_gaps", "rank5_multi"])
def test_residual_regimes_match_jax(name):
    """The port's residual likelihood and gradient against the JAX
    package's at float64, N = 2048, in the three regimes of
    tests/test_residual_loss.py that stress it (gaps ~1e-3; gaps
    alternating 1e-3 and 10; rank 5, obs 3), each with a random
    non-normal N.  Bars: value rtol 1e-8, gradient max |port - JAX| <=
    1e-5 of each leaf's largest entry.  In the mixed regime the JAX
    package's own residual and plain likelihoods differ by ~3e-9
    relative in value, and the two packages' plain likelihood gradients
    by ~4e-6 of their scale: float64 rounding amplified by the
    conditioning of K (gaps of 1e-3 beside gaps of 10)."""
    jp, ts, xs = _regime(name)
    ref_v, ref_g = shared(f"residual_regime_{name}", lambda: (
        _jax_value_and_grads(jleg.log_likelihood_residual, jp, ts, xs)))
    p = params_from_jax(jp, device="cpu")
    v, g = _value_and_grads(leg.log_likelihood_residual, p,
                            torch.tensor(ts), torch.tensor(xs))
    assert np.isfinite(v) and all(np.all(np.isfinite(a)) for a in g)
    np.testing.assert_allclose(v, float(ref_v), rtol=1e-8)
    for a, b in zip(g, ref_g):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_residual_kernel_route_glue(monkeypatch):
    """At float32 with every backend but "torch" resolved to "cuda" (the
    kernel wrappers run their plain twins on CPU tensors), the residual
    likelihood takes the kernel routes' glue -- the K-system Function,
    the solve + per-row log-det engine and the (e, Q) Function of the
    quadratic -- and agrees with the "torch" route: value rtol 1e-5,
    gradients 1e-3 of each leaf's scale (float32, Pade-7 vs Pade-13)."""
    from cyclic_gps_tpu_torch.ops import sweep_cuda

    jp, ts, xs = _parity_case()
    p = loop.params_from_arrays(*(np.array(a) for a in jp),
                                dtype=torch.float32, device="cpu")
    t_ts, t_xs = torch.tensor(ts), torch.tensor(xs, dtype=torch.float32)
    ref_v, ref_g = _value_and_grads(
        lambda *a: leg.log_likelihood_residual(*a, backend="torch"), p,
        t_ts, t_xs)
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")
    calls = []
    for mod, name in ((leg, "k_system_cuda"),
                      (sweep_cuda, "forward_sweep_collect_cuda"),
                      (leg, "transition_and_noise_diff")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    v, g = _value_and_grads(leg.log_likelihood_residual, p, t_ts, t_xs)
    assert {"k_system_cuda", "forward_sweep_collect_cuda",
            "transition_and_noise_diff"} <= set(calls)
    np.testing.assert_allclose(v, ref_v, rtol=1e-5)
    for a, b in zip(g, ref_g):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * np.abs(b).max())


def test_residual_quad_slabs():
    """The Markov quadratic of the residual form in gap slabs under
    checkpointing (as at N > 65,536 gaps) equals the one-slab evaluation,
    value and gradient, with slabs that do not divide the gap count."""
    jp, ts, xs = _parity_case()
    p = params_from_jax(jp, device="cpu")
    diffs = torch.tensor(np.diff(ts))
    z_em = torch.tensor(np.random.RandomState(5).randn(3, ts.size))

    def value_and_grads(slab):
        g = leg.g_matrix(p)
        v = leg._residual_quad_streamed(g, diffs, z_em, slab=slab)
        return float(v.detach()), torch.autograd.grad(
            v, list(p.parameters()), allow_unused=True)

    v1, g1 = value_and_grads(ts.size)
    for slab in (7, 128):
        v, g = value_and_grads(slab)
        np.testing.assert_allclose(v, v1, rtol=1e-12)
        for a, b in zip(g, g1):
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                           atol=1e-12)


def test_default_loss_picks_residual():
    """fit(loss=None)'s choice, checked on timestamp arrays only: float32
    on an irregular grid of more than 2^17 points takes "cr_residual",
    which resolves to `nll_loss_residual`; 2^17 points take "kalman", a
    uniform grid "kalman_regular", float64 "cr"."""
    n = 2 ** 17 + 1
    ts = torch.cumsum(torch.rand(n, generator=torch.Generator()
                                 .manual_seed(0)) + 0.01, 0)
    xs = torch.zeros(n, 1)
    assert loop._default_loss(ts, xs) == "cr_residual"
    assert loop._default_loss(ts[:-1], xs[:-1]) == "kalman"
    assert loop._default_loss(torch.arange(64.0), torch.zeros(64, 1)) == (
        "kalman_regular")
    assert loop._default_loss(ts, xs.double()) == "cr"
    assert loop._loss_fn("cr_residual") is loop.nll_loss_residual
    assert loop.LOSSES["cr_residual"] is loop.nll_loss_residual
    # every loss of the JAX package is ported
    assert set(loop.LOSSES) == {"cr", "cr_residual", "kalman",
                                "kalman_regular", "kalman_ss"}


def test_nll_loss_residual_train_step():
    """One train_step on "cr_residual" at float64 (N = 400) takes the
    loss -log_likelihood_residual / (N obs) and moves the parameters."""
    jp, ts, xs = _parity_case()
    p = params_from_jax(jp, device="cpu")
    t_ts, t_xs = torch.tensor(ts), torch.tensor(xs)
    with torch.no_grad():
        want = -float(leg.log_likelihood_residual(p, t_ts, t_xs)) / xs.size
    b0 = p.b.detach().clone()
    value = loop.train_step(p, loop.make_optimizer(), t_ts, t_xs,
                            loss="cr_residual")
    np.testing.assert_allclose(float(value), want, rtol=1e-12)
    assert not torch.equal(p.b.detach(), b0)
