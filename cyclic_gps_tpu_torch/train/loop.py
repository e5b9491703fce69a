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
device the parameters live on.  The Kalman filter losses run
``baselines/kalman.py``.  `train_step_stacked` / `fit_stacked` train on
B stacked series (one block-diagonal system).  The optimizer the JAX
package has but this one does not yet (LBFGS) raises
``NotImplementedError`` naming its ROADMAP.md item.  Checkpoints are
``.npz`` files with the JAX package's keys, so either package loads the
other's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from cyclic_gps_tpu_torch import resolve_device
from cyclic_gps_tpu_torch.baselines import kalman
from cyclic_gps_tpu_torch.models import leg

Tensor = torch.Tensor


def nll_loss(params: leg.LEGParams, ts: Tensor, xs: Tensor) -> Tensor:
    """-log_likelihood / nobs (nobs = N * obs_dim, one full batch)."""
    return -leg.log_likelihood(params, ts, xs) / xs.numel()


def nll_loss_residual(params: leg.LEGParams, ts: Tensor,
                      xs: Tensor) -> Tensor:
    """Float32-safe precision-form NLL (`leg.log_likelihood_residual`):
    the variational residual mahalanobis and per-row-paired log-dets.
    Mathematically `nll_loss`; robust where it breaks at single precision
    (large irregular grids trained at float32)."""
    return -leg.log_likelihood_residual(params, ts, xs) / xs.numel()


def _kalman_ll(params: leg.LEGParams, ts: Tensor, xs: Tensor,
               regular: bool, backend: str) -> Tensor:
    ssm = kalman.leg_to_ssm(params, ts, regular=regular, backend=backend)
    if xs.shape[0] > kalman.SMOOTHER_BLOCK:
        # the flat scan's working set grows with T; the blocked filter
        # carries (m, P, ll) across checkpointed blocks, so the value and
        # the gradient run in O(block) memory
        return kalman.log_likelihood_blocked(ssm, xs)
    return kalman.filter_parallel(ssm, xs)[2]


def nll_loss_kalman(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                    backend: str = "auto") -> Tensor:
    """The same NLL through the parallel Kalman filter
    (`kalman.filter_parallel`; above 2^17 points the blocked filter).
    Mathematically `nll_loss`, but robust at single precision: the
    filter's innovation covariances are bounded below by the observation
    noise, where the precision form's blocks grow like 1/(dt
    lambda_min(sym G)).  On the card at float32 every gap's (A, Q) comes
    from the (e, Q) kernel; ``backend`` as for `leg.log_likelihood`."""
    return -_kalman_ll(params, ts, xs, False, backend) / xs.numel()


def nll_loss_kalman_regular(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                            backend: str = "auto") -> Tensor:
    """`nll_loss_kalman` for a uniform grid: one (A, Q) broadcast over
    the T steps instead of one per gap."""
    return -_kalman_ll(params, ts, xs, True, backend) / xs.numel()


SS_T0 = 2048  # steady-state switch point: exact for decay rates
#               lambda dt > ~ -ln(eps) / (2 SS_T0) ~ 0.004


def nll_loss_kalman_steady(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                           backend: str = "auto") -> Tensor:
    """Uniform-grid NLL via the steady-state filter
    (`kalman.log_likelihood_steady`): the exact filter for the first
    SS_T0 steps, then the constant-gain tail as dense matrix products.
    Exact to working precision while the Riccati recursion converges
    within SS_T0 steps; `fit` picks it only after checking
    `kalman.steady_state_gap` at the initial parameters (a fit drifting
    to an extremely smooth process, decay rate lambda dt < ~0.004, should
    force loss="kalman_regular").  ``backend`` reaches the one (A, Q)
    emission."""
    ssm = kalman.leg_to_ssm(params, ts, regular=True, backend=backend)
    return -kalman.log_likelihood_steady(
        ssm.a[0], ssm.q[0], ssm.h, ssm.r, xs, t0=SS_T0) / xs.numel()


LOSSES = {"cr": nll_loss, "cr_residual": nll_loss_residual,
          "kalman": nll_loss_kalman,
          "kalman_regular": nll_loss_kalman_regular,
          "kalman_ss": nll_loss_kalman_steady}


def _loss_fn(name: str, losses=None):
    losses = LOSSES if losses is None else losses
    if name in losses:
        return losses[name]
    raise ValueError(f"unknown loss {name!r}")


# ---------------------------------------------------------------------------
# Stacked multi-series losses: B independent series sharing the
# parameters, stacked into one system (leg.log_likelihood_stacked).
# ---------------------------------------------------------------------------


def nll_loss_stacked(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                     series_ids: Tensor, regular: bool = False,
                     backend: str = "auto") -> Tensor:
    """Mean per-observation NLL over B independent series stacked into one
    pass of the engine (`leg.log_likelihood_stacked`).  The precision
    form's float32 caveat applies per series; short series keep dt times
    the smoothness moderate, where the precision form stays well
    conditioned."""
    return -leg.log_likelihood_stacked(params, ts, xs, series_ids,
                                       regular=regular,
                                       backend=backend) / xs.numel()


def _masked_ssm(params, ts, series_ids, backend):
    """The boundary-masked SSM: transitions into each series' first point
    become (A = 0, Q = I), so the filter restarts from the stationary
    prior at every series."""
    return kalman.leg_to_ssm(params, ts,
                             gap_mask=leg._series_gap_mask(series_ids),
                             backend=backend)


def nll_loss_kalman_stacked(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                            series_ids: Tensor,
                            backend: str = "auto") -> Tensor:
    """Stacked multi-series NLL through the Kalman filter: the float32-
    robust counterpart of `nll_loss_stacked` (the conditioning argument
    of `nll_loss_kalman`, per series), on the boundary-masked SSM; above
    2^17 points in all the blocked filter."""
    ssm = _masked_ssm(params, ts, series_ids, backend)
    if xs.shape[0] > kalman.SMOOTHER_BLOCK:
        ll = kalman.log_likelihood_blocked(ssm, xs)
    else:
        ll = kalman.filter_parallel(ssm, xs)[2]
    return -ll / xs.numel()


def log_likelihood_per_series_kalman(params: leg.LEGParams, ts: Tensor,
                                     xs: Tensor, series_ids: Tensor,
                                     num_series: int,
                                     backend: str = "auto") -> Tensor:
    """The per-series log-likelihoods [num_series] through the Kalman
    filter (the float32-robust twin of `leg.log_likelihood_per_series`):
    the boundary-masked SSM's per-step predictive log-densities
    (`kalman.log_likelihood_rows_blocked`, O(block) memory), summed by
    series id."""
    ssm = _masked_ssm(params, ts, series_ids, backend)
    rows = kalman.log_likelihood_rows_blocked(ssm, xs)
    return leg._segment_sum(rows, series_ids, num_series)


STACKED_LOSSES = {
    "cr": nll_loss_stacked,  # the precision form (the fast path)
    "kalman": lambda p, t, x, ids, regular=False, backend="auto":
        nll_loss_kalman_stacked(p, t, x, ids, backend=backend),
}


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
    return _step(params, opt,
                 lambda: loss_fn(params, ts.to(device), xs.to(device)))


def _step(params: leg.LEGParams, opt: Optimizer, value_fn) -> Tensor:
    """Zero the gradients, backpropagate ``value_fn()``, take one step of
    ``opt``; returns the detached loss."""
    value = value_fn()
    for p in params.parameters():
        p.grad = None
    value.backward()
    value = value.detach()
    opt.step(params, float(value))
    return value


def train_step_stacked(params: leg.LEGParams, opt: Optimizer, ts: Tensor,
                       xs: Tensor, series_ids: Tensor,
                       regular: bool = False, loss: str = "cr") -> Tensor:
    """One gradient step on a stacked multi-series batch (``params``
    updated in place; ``loss`` a key of `STACKED_LOSSES`); returns the
    loss before the step."""
    loss_fn = _loss_fn(loss, STACKED_LOSSES)
    device = params.b.device
    ts, xs, series_ids = (t.to(device) for t in (ts, xs, series_ids))
    return _step(params, opt, lambda: loss_fn(params, ts, xs, series_ids,
                                              regular=regular))


def _default_loss(ts: Tensor, xs: Tensor) -> str:
    """The loss the JAX package's ``fit(loss=None)`` picks from the grid
    alone: "cr" at float64; at float32 "kalman_regular" on a uniform grid,
    "cr_residual" on an irregular grid of more than 2^17 points and
    "kalman" below.  `fit` then runs the steady-state check
    (`_steady_state_loss`) that can turn "kalman_regular" into
    "kalman_ss"."""
    if xs.dtype == torch.float64:
        return "cr"
    d = np.diff(ts.detach().cpu().numpy())
    if d.size > 0 and np.allclose(d, d[0], rtol=1e-6, atol=0):
        return "kalman_regular"
    return ("cr_residual" if xs.shape[0] > kalman.SMOOTHER_BLOCK
            else "kalman")


def _steady_state_loss(params: leg.LEGParams, ts: Tensor, xs: Tensor,
                       loss: str) -> str:
    """JAX's second step of the default: on a uniform grid of more than
    8 SS_T0 points, "kalman_ss" where the Riccati recursion at the initial
    parameters has converged by SS_T0 / 2 steps (relative residual below
    1e-6), else ``loss`` unchanged."""
    if loss != "kalman_regular" or xs.shape[0] <= 8 * SS_T0:
        return loss
    with torch.no_grad():
        ssm0 = kalman.leg_to_ssm(params, ts[:SS_T0 + 2], regular=True)
        gap = kalman.steady_state_gap(ssm0.a[0], ssm0.q[0], ssm0.h, ssm0.r,
                                      t0=SS_T0 // 2)
    return "kalman_ss" if gap < 1e-6 else loss


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
    """Full-batch training loop on the params' device.  ``loss``: "cr"
    (the partitioned likelihood, `nll_loss`), "cr_residual" (its
    float32-safe precision form, `nll_loss_residual`), "kalman" or
    "kalman_regular" (the parallel Kalman filter, `nll_loss_kalman`).
    ``loss=None`` picks what the JAX package picks (`_default_loss`, then
    `_steady_state_loss`): "cr" at float64; at float32 "cr_residual" on an
    irregular grid of more than 2^17 points, "kalman" on a smaller one,
    and on a uniform grid "kalman_regular", or "kalman_ss"
    (`nll_loss_kalman_steady`) where the steady-state check passes."""
    device = params.b.device
    ts, xs = ts.to(device), xs.to(device)
    if loss is None:
        loss = _steady_state_loss(params, ts, xs, _default_loss(ts, xs))
    _loss_fn(loss)
    return _fit_loop(params, make_optimizer(optimizer, lr), num_steps,
                     log_every, callback,
                     lambda opt: train_step(params, opt, ts, xs, loss))


def _fit_loop(params, opt, num_steps, log_every, callback, step_fn):
    losses = []
    for step in range(num_steps):
        loss_f = float(step_fn(opt))
        losses.append(loss_f)
        if callback is not None:
            callback(step, loss_f)
        elif log_every and step % log_every == 0:
            print(f"step {step:5d}  NLL {loss_f:.6f}")
    return FitResult(params=params, losses=losses)


def fit_stacked(
    params: leg.LEGParams,
    ts: Tensor,
    xs: Tensor,
    series_ids: Tensor,
    num_steps: int = 1000,
    optimizer: str = "adam",
    lr: float = 1e-2,
    log_every: int = 100,
    callback: Optional[Callable[[int, float], None]] = None,
    regular: bool = False,
    loss: str = "cr",
) -> FitResult:
    """Full-batch training on B stacked series (shared parameters, one
    block-diagonal system a step; see `leg.log_likelihood_stacked`).  For
    an equal-length batch flatten [B, n] / [B, n, obs] and pass
    consecutive ids.  ``loss``: "cr" (the precision form, the fast path)
    or "kalman" (the boundary-masked filter, float32-robust for fits that
    drift into very smooth regimes; `nll_loss_kalman_stacked`)."""
    device = params.b.device
    ts, xs, series_ids = (t.to(device) for t in (ts, xs, series_ids))
    _loss_fn(loss, STACKED_LOSSES)
    return _fit_loop(params, make_optimizer(optimizer, lr), num_steps,
                     log_every, callback,
                     lambda opt: train_step_stacked(
                         params, opt, ts, xs, series_ids, regular, loss))


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
