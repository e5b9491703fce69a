"""Carry LEG and celerite weights between the JAX package and this one.

Both packages pack the parameters the same way (LEG: N lower-triangular,
R strictly lower, raw Lambda lower-triangular, dense B; celerite: the
N diagonal and subdiagonal, the R subdiagonal, raw Lambda, B), so
converting is a copy of the arrays.  Nothing here imports JAX: the JAX
side hands over and takes back plain numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cyclic_gps_tpu_torch.models.celerite import CeleriteParams
from cyclic_gps_tpu_torch.models.leg import LEGParams


class NumpyLEGParams(NamedTuple):
    """The four packed arrays, in the JAX ``LEGParams`` field order (so
    ``cyclic_gps_tpu.models.leg.LEGParams(*map(jnp.asarray, p))``
    rebuilds the JAX parameters)."""

    n_params: np.ndarray
    r_params: np.ndarray
    lambda_params: np.ndarray
    b: np.ndarray


def params_from_jax(p, device=None) -> LEGParams:
    """A JAX ``LEGParams`` (or anything with its four fields as array-likes,
    e.g. numpy arrays) -> this package's ``LEGParams`` on ``device``,
    keeping the dtype."""

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    return LEGParams(t(p.n_params), t(p.r_params), t(p.lambda_params),
                     t(p.b))


def params_to_numpy(p: LEGParams) -> NumpyLEGParams:
    """This package's ``LEGParams`` -> the four packed numpy arrays."""

    def a(t):
        return t.detach().cpu().numpy()

    return NumpyLEGParams(a(p.n_params), a(p.r_params), a(p.lambda_params),
                          a(p.b))


def grads_to_numpy(p: LEGParams) -> NumpyLEGParams:
    """The gradients held in the four leaves' ``.grad``, as numpy arrays
    in the same order (what ``jax.grad`` returns as a ``LEGParams``)."""
    return NumpyLEGParams(*(t.grad.detach().cpu().numpy() for t in
                            (p.n_params, p.r_params, p.lambda_params, p.b)))


class NumpyCeleriteParams(NamedTuple):
    """The five celerite arrays, in the JAX ``CeleriteParams`` field order
    (so ``cyclic_gps_tpu.models.celerite.CeleriteParams(*map(jnp.asarray,
    p))`` rebuilds the JAX parameters)."""

    n_diag: np.ndarray
    n_sub: np.ndarray
    r_sub: np.ndarray
    lambda_params: np.ndarray
    b: np.ndarray


def celerite_params_from_jax(p, device=None) -> CeleriteParams:
    """A JAX ``CeleriteParams`` (or anything with its five fields as
    array-likes) -> this package's ``CeleriteParams`` on ``device``,
    keeping the dtype."""
    return CeleriteParams(*(torch.as_tensor(np.array(getattr(p, k)),
                                            device=device)
                            for k in NumpyCeleriteParams._fields))


def celerite_params_to_numpy(p: CeleriteParams) -> NumpyCeleriteParams:
    """This package's ``CeleriteParams`` -> the five numpy arrays."""
    return NumpyCeleriteParams(*(getattr(p, k).detach().cpu().numpy()
                                 for k in NumpyCeleriteParams._fields))
