"""Training: full-batch gradient steps on the LEG likelihood.

Counterpart of ``cyclic_gps_tpu/train/loop.py``.  The JAX package runs
one jitted optax step (``jax.value_and_grad`` of the loss, Adam, then
``optax.contrib.reduce_on_plateau`` scaling the update); here the
gradient comes from ``torch.autograd`` through the likelihood's custom
backwards (models/leg.py), Adam is ``torch.optim.Adam`` (the same update
as ``optax.adam``, eps = 1e-8), and `ReduceOnPlateau` reproduces optax's
plateau scale, applied to Adam's learning rate (Adam's step is linear in
it, so this equals scaling the update).

Parameters are updated in place; `train_step` and `fit` run on the
device the parameters live on.  Losses and optimizers the JAX package
has but this one does not yet raise ``NotImplementedError`` naming their
ROADMAP.md item.  Checkpoints are ``.npz`` files with the JAX package's
keys, so either package loads the other's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from cyclic_gps_tpu_torch import resolve_device
from cyclic_gps_tpu_torch.models import leg

Tensor = torch.Tensor


def nll_loss(params: leg.LEGParams, ts: Tensor, xs: Tensor) -> Tensor:
    """-log_likelihood / nobs (nobs = N * obs_dim, one full batch)."""
    return -leg.log_likelihood(params, ts, xs) / xs.numel()


LOSSES = {"cr": nll_loss}

# losses of the JAX package still to port, and where they stand in line
_UNPORTED_LOSSES = {
    "cr_residual": "ROADMAP.md, Queue 1: leg.log_likelihood_residual",
    "kalman": "ROADMAP.md, Queue 1: baselines/kalman.py",
    "kalman_regular": "ROADMAP.md, Queue 1: baselines/kalman.py",
    "kalman_ss": "ROADMAP.md, Queue 1: baselines/kalman.py",
}


def _loss_fn(name: str):
    if name in LOSSES:
        return LOSSES[name]
    if name in _UNPORTED_LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet ({_UNPORTED_LOSSES[name]})")
    raise ValueError(f"unknown loss {name!r}")


class ReduceOnPlateau:
    """The scale of ``optax.contrib.reduce_on_plateau``, one loss value at
    a time (same arguments and defaults).  Values are averaged over
    ``accumulation_size`` steps; each full average either improves on the
    best by more than rtol * |best| + atol or counts towards ``patience``,
    and a plateau of ``patience`` averages multiplies the scale by
    ``factor`` (floored at ``min_scale``), then waits ``cooldown``
    averages.  `update` returns the scale for the current step."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 rtol: float = 1e-4, atol: float = 0.0, cooldown: int = 0,
                 accumulation_size: int = 1, min_scale: float = 0.0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        if rtol < 0.0 or atol < 0.0 or rtol > 1.0 or rtol == atol == 0.0:
            raise ValueError(f"need 0 <= rtol <= 1, atol >= 0, not both "
                             f"zero; got rtol={rtol}, atol={atol}")
        self.factor, self.patience = factor, patience
        self.rtol, self.atol = rtol, atol
        self.cooldown, self.accumulation_size = cooldown, accumulation_size
        self.min_scale = min_scale
        self.scale = 1.0
        self.best_value = math.inf
        self.plateau_count = 0
        self.cooldown_count = 0
        self.count = 0
        self.avg_value = 0.0

    def update(self, value: float) -> float:
        self.avg_value = (self.count * self.avg_value + value) / (
            self.count + 1)
        self.count += 1
        if self.count == self.accumulation_size:
            self._update_scale()
        return self.scale

    def _update_scale(self) -> None:
        improved = self.avg_value < ((1 - self.rtol) * self.best_value
                                     - self.atol)
        if improved:
            self.best_value = self.avg_value
        plateau = 0 if improved else self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count = 0
            self.cooldown_count -= 1
        else:
            hit = plateau == self.patience
            self.plateau_count = 0 if hit else plateau
            self.scale = max(self.scale * self.factor if hit else self.scale,
                             self.min_scale)
            self.cooldown_count = self.cooldown if hit else 0
        self.count = 0
        self.avg_value = 0.0


class Optimizer:
    """Adam with an optional plateau scale on its step.  It binds to the
    parameter module of its first `step` and refuses any other."""

    def __init__(self, lr: float, plateau: Optional[ReduceOnPlateau]):
        self.lr = lr
        self.plateau = plateau
        self.params = None
        self._adam = None

    def step(self, params: leg.LEGParams, value: float) -> None:
        """Apply one update from the gradients in ``params``' ``.grad``,
        given the loss ``value`` they came from."""
        if self._adam is None:
            self.params = params
            self._adam = torch.optim.Adam(params.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif params is not self.params:
            raise ValueError("this optimizer is bound to another parameter "
                             "module")
        scale = 1.0 if self.plateau is None else self.plateau.update(value)
        for group in self._adam.param_groups:
            group["lr"] = self.lr * scale
        self._adam.step()


def make_optimizer(name: str = "adam", lr: float = 1e-2,
                   reduce_on_plateau: bool = True) -> Optimizer:
    """Adam, optionally with the reference's reduce-on-plateau scale
    (factor 0.1, patience 10, cooldown 0, averaged over 5 steps)."""
    name = name.lower()
    if name in ("lbfgs", "bfgs"):
        raise NotImplementedError(
            "LBFGS is not ported yet (ROADMAP.md, Queue 1: LBFGS with "
            "optax's zoom line search; torch.optim.LBFGS searches "
            "differently)")
    if name != "adam":
        raise ValueError(f"unknown optimizer {name!r}")
    plateau = (ReduceOnPlateau(factor=0.1, patience=10, cooldown=0,
                               accumulation_size=5)
               if reduce_on_plateau else None)
    return Optimizer(lr, plateau)


def train_step(params: leg.LEGParams, opt: Optimizer, ts: Tensor,
               xs: Tensor, loss: str = "cr") -> Tensor:
    """One full-batch gradient step on ``params`` (updated in place);
    returns the loss before the step, a 0-d tensor on the params'
    device."""
    loss_fn = _loss_fn(loss)
    device = params.b.device
    value = loss_fn(params, ts.to(device), xs.to(device))
    for p in params.parameters():
        p.grad = None
    value.backward()
    value = value.detach()
    opt.step(params, float(value))
    return value


def _default_loss(ts: Tensor, xs: Tensor) -> str:
    """The loss the JAX package's ``fit(loss=None)`` picks, but for the
    steady-state check that can turn "kalman_regular" into "kalman_ss"
    (both are unported)."""
    if xs.dtype == torch.float64:
        return "cr"
    d = np.diff(ts.detach().cpu().numpy())
    if d.size > 0 and np.allclose(d, d[0], rtol=1e-6, atol=0):
        return "kalman_regular"
    # kalman.SMOOTHER_BLOCK = 2**17 in the JAX package
    return "cr_residual" if xs.shape[0] > 2 ** 17 else "kalman"


@dataclass
class FitResult:
    params: leg.LEGParams
    losses: List[float] = field(default_factory=list)


def fit(
    params: leg.LEGParams,
    ts: Tensor,
    xs: Tensor,
    num_steps: int = 1000,
    optimizer: str = "adam",
    lr: float = 1e-2,
    log_every: int = 100,
    callback: Optional[Callable[[int, float], None]] = None,
    loss: Optional[str] = None,
) -> FitResult:
    """Full-batch training loop on the params' device.  ``loss=None``
    picks what the JAX package picks: "cr" at float64; at float32 the
    Kalman or residual losses, which are not ported yet and raise."""
    device = params.b.device
    ts, xs = ts.to(device), xs.to(device)
    loss = loss or _default_loss(ts, xs)
    _loss_fn(loss)
    opt = make_optimizer(optimizer, lr)
    losses = []
    for step in range(num_steps):
        loss_f = float(train_step(params, opt, ts, xs, loss))
        losses.append(loss_f)
        if callback is not None:
            callback(step, loss_f)
        elif log_every and step % log_every == 0:
            print(f"step {step:5d}  NLL {loss_f:.6f}")
    return FitResult(params=params, losses=losses)


# ---------------------------------------------------------------------------
# Checkpoints: the four packed arrays in an npz, under the JAX package's
# keys.
# ---------------------------------------------------------------------------

_KEYS = ("n_params", "r_params", "lambda_params", "b")


def save_params(path: str, params: leg.LEGParams) -> None:
    np.savez(path, **{k: getattr(params, k).detach().cpu().numpy()
                      for k in _KEYS})


def params_from_arrays(n, r, lam, b, dtype=torch.float64,
                       device=None) -> leg.LEGParams:
    """Parameters from raw packed arrays (e.g. exported by another
    implementation), on ``device`` (default: the card)."""
    device = resolve_device(device)
    return leg.LEGParams(*(torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device).clone()
                           for a in (n, r, lam, b)))


def load_params(path: str, dtype=None, device=None) -> leg.LEGParams:
    """Parameters from a checkpoint of either package, on ``device``
    (default: the card), in ``dtype`` (default: as stored)."""
    data = np.load(path)
    arrs = [data[k] for k in _KEYS]
    dtype = dtype or torch.from_numpy(arrs[0][:0]).dtype
    return params_from_arrays(*arrs, dtype=dtype, device=device)
