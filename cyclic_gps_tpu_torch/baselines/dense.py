"""Naive dense O(N^2)/O(N^3) oracles for correctness testing.

Counterpart of ``cyclic_gps_tpu/baselines/dense.py`` (reference
model_utils.py:110-142).  Used only as test oracles; never in the fast
path.
"""

from __future__ import annotations

import math

import torch

from cyclic_gps_tpu_torch.models import leg

Tensor = torch.Tensor


def prior_covariance(ts: Tensor, g: Tensor) -> Tensor:
    """Dense PEG prior covariance over grid ``ts``.

    Block (i, j) = expm(-0.5 |t_i - t_j| G) for i >= j and its transpose
    for i < j.  Returns [N*r, N*r].
    """
    n = ts.shape[0]
    r = g.shape[0]
    absd = torch.abs(ts[:, None] - ts[None, :])  # [N, N]
    e = leg.expm_batch(-0.5 * absd[..., None, None] * g[None, None])
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                  device=ts.device))
    blocks = torch.where(lower[..., None, None], e, e.transpose(-1, -2))
    return blocks.permute(0, 2, 1, 3).reshape(n * r, n * r)


def log_marginal_likelihood(
    n_mat: Tensor, r_mat: Tensor, b: Tensor, llt: Tensor, ts: Tensor,
    xs: Tensor
) -> Tensor:
    """Dense marginal likelihood N(x; 0, Btilde Sigma Btilde^T + Ltilde)."""
    num = ts.shape[0]
    g = n_mat @ n_mat.T + r_mat - r_mat.T + leg.G_DIAG_EPS * torch.eye(
        n_mat.shape[0], dtype=n_mat.dtype, device=n_mat.device
    )
    sigma = prior_covariance(ts, g)
    eye_n = torch.eye(num, dtype=b.dtype, device=b.device)
    b_tilde = torch.kron(eye_n, b)
    llt_tilde = torch.kron(eye_n, llt)
    cov = b_tilde @ sigma @ b_tilde.T + llt_tilde
    x = xs.reshape(-1)
    mahal = x @ torch.linalg.solve(cov, x)
    logdet = torch.linalg.slogdet(2 * math.pi * cov)[1]
    return -0.5 * (mahal + logdet)


def log_marginal_likelihood_from_params(params, ts: Tensor,
                                        xs: Tensor) -> Tensor:
    return log_marginal_likelihood(
        leg.n_matrix(params),
        leg.r_matrix(params),
        params.b,
        leg.lambda_lambda_t(params),
        ts,
        xs,
    )
