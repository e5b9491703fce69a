"""PyTorch port vs the JAX package: training.

Adam train steps from the same parameters against the JAX optax step,
the reduce-on-plateau scale against optax's, checkpoints across the two
packages, and the losses and optimizers that are not ported yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclic_gps_tpu.data.synthetic import generate_data as jgenerate_data
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu.train import loop as jloop
from cyclic_gps_tpu_torch.convert import params_from_jax, params_to_numpy
from cyclic_gps_tpu_torch.data.synthetic import generate_data
from cyclic_gps_tpu_torch.train import loop

torch.set_num_threads(1)

_STEPS = 3


def _jax_params(seed):
    """Rank 3 / obs 2 packed parameters made with numpy (N = I + 0.3 Z,
    R = (Z - Z^T) / 5, raw Lambda = 0.1 I, B = 0.5)."""
    rng = np.random.RandomState(seed)
    ti, tl = np.tril_indices(3), np.tril_indices(3, -1)
    z = rng.randn(3, 3)
    return jleg.LEGParams(*(jnp.asarray(a, jnp.float64) for a in (
        np.eye(3)[ti] + 0.3 * rng.randn(ti[0].size), ((z - z.T) * 0.2)[tl],
        (0.1 * np.eye(2))[np.tril_indices(2)], np.full((2, 3), 0.5))))


@pytest.fixture(scope="module")
def jax_train_run():
    """Parameters and losses of _STEPS JAX Adam train steps (lr 1e-2,
    reduce-on-plateau on), rank 3, n = 100 irregular, float64."""
    jp = _jax_params(7)
    jts, jxs = jgenerate_data(100, 2, dtype=jnp.float64, seed=8)
    opt = jloop.make_optimizer("adam", 1e-2)
    state = opt.init(jp)
    params, losses = [jp], []
    for _ in range(_STEPS):
        jp, state, value = jloop.train_step(jp, state, jts, jxs, opt)
        params.append(jp)
        losses.append(float(value))
    return params, losses


@pytest.mark.parametrize("steps", [1, _STEPS])
def test_train_steps_match_jax(steps, jax_train_run):
    """``steps`` Adam train_steps of the port from params_from_jax
    parameters == the JAX train_step at float64 (rank 3, n = 100): every
    loss and every parameter leaf after the last step to 1e-9 (rtol and
    atol; the two Adams round the same update differently, ~1e-16)."""
    jparams, jlosses = jax_train_run
    p = params_from_jax(jparams[0], device="cpu")
    ts, xs = generate_data(100, 2, dtype=torch.float64, seed=8,
                           device="cpu")
    opt = loop.make_optimizer("adam", 1e-2)
    losses = [float(loop.train_step(p, opt, ts, xs)) for _ in range(steps)]
    np.testing.assert_allclose(losses, jlosses[:steps], rtol=1e-9)
    for a, b in zip(params_to_numpy(p), jparams[steps]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-9)


def _loss_script():
    """80 loss values: a fast descent, then a flat stretch whose noise
    stays under the 1e-4 relative improvement bar -- a plateau long
    enough for a scale cut even when values are averaged in fives."""
    rng = np.random.RandomState(0)
    v = np.concatenate([10.0 - 0.5 * np.arange(10),
                        2.5 * (1.0 + 1e-6 * rng.randn(70))])
    assert v.size == 80
    return v


@pytest.mark.parametrize("cooldown,accumulation", [(0, 5), (3, 1)])
def test_plateau_matches_optax(cooldown, accumulation):
    """ReduceOnPlateau's scale == optax.contrib.reduce_on_plateau's at
    every step of a scripted 80-value loss sequence (factor 0.1, patience
    10, default rtol/atol/min_scale), with the train loop's settings
    (cooldown 0, averaged over 5) and with a cooldown; exact (the same
    float64 arithmetic)."""
    kw = dict(factor=0.1, patience=10, cooldown=cooldown,
              accumulation_size=accumulation)
    tx = optax.contrib.reduce_on_plateau(**kw)
    state = tx.init(jnp.zeros(()))
    update = jax.jit(lambda st, v: tx.update(jnp.ones(()), st, value=v))
    port = loop.ReduceOnPlateau(**kw)
    ref, got = [], []
    for v in _loss_script():
        upd, state = update(state, v)
        ref.append(float(upd))
        got.append(port.update(float(v)))
    assert got == ref
    assert min(got) < 1.0  # the script reaches a cut


def test_checkpoints_cross_between_packages(tmp_path):
    """save_params of either package loads in the other, leaf for leaf
    and bit for bit (the same npz keys); params_from_arrays keeps the
    values."""
    jp = _jax_params(3)
    jloop.save_params(str(tmp_path / "jax.npz"), jp)
    p = loop.load_params(str(tmp_path / "jax.npz"), device="cpu")
    for a, b in zip(params_to_numpy(p), jp):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert p.b.dtype == torch.float64
    loop.save_params(str(tmp_path / "port.npz"), p)
    back = jloop.load_params(str(tmp_path / "port.npz"))
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = loop.params_from_arrays(*params_to_numpy(p), dtype=torch.float32,
                                device="cpu")
    assert q.b.dtype == torch.float32
    np.testing.assert_array_equal(q.b.detach().numpy(),
                                  np.float32(np.asarray(jp.b)))


_UNPORTED = ["kalman", "kalman_regular", "kalman_ss", "cr_residual"]


@pytest.mark.parametrize("loss", _UNPORTED)
def test_unported_losses_raise(loss):
    """A loss the JAX package has and the port does not yet raises
    NotImplementedError naming its ROADMAP item, before any work; an
    unknown loss raises ValueError."""
    p = params_from_jax(_jax_params(1), device="cpu")
    ts, xs = generate_data(16, 2, seed=1, device="cpu")
    opt = loop.make_optimizer()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.train_step(p, opt, ts, xs, loss=loss)
    with pytest.raises(ValueError, match="unknown loss"):
        loop.train_step(p, opt, ts, xs, loss="nope")


@pytest.mark.parametrize("name", ["lbfgs", "bfgs"])
def test_lbfgs_not_ported(name):
    """LBFGS waits for a port of optax's zoom line search:
    make_optimizer raises NotImplementedError naming the ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.make_optimizer(name)


@pytest.mark.parametrize("spacing", ["irregular", "regular"])
def test_fit_default_loss(spacing):
    """fit(loss=None) at float64 trains with "cr" (losses finite and
    falling over 3 steps); at float32 it picks what the JAX package picks
    (a Kalman loss here), which is not ported, and raises -- it does not
    fall back to "cr"."""
    p = params_from_jax(_jax_params(2), device="cpu")
    ts, xs = generate_data(64, 2, spacing=spacing, seed=2, device="cpu")
    res = loop.fit(p, ts, xs, num_steps=3, log_every=0)
    assert res.params is p and len(res.losses) == 3
    assert np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    p32 = loop.params_from_arrays(*params_to_numpy(p), dtype=torch.float32,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="kalman"):
        loop.fit(p32, ts.float(), xs.float(), num_steps=1)
