"""Small Gaussian-calculus helpers (batched, PyTorch).

Counterpart of ``cyclic_gps_tpu/models/gaussians.py``: the block builders
and ``gaussian_stitch``, batched over leading dimensions so prediction
runs over all target points at once.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def build_2x2_block(a: Tensor, b: Tensor, c: Tensor, d: Tensor) -> Tensor:
    """[[a, b], [c, d]] with arbitrary leading batch dims."""
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)],
                     dim=-2)


def build_3x3_block(a, b, c, d, e, f, g, h, i) -> Tensor:
    rows = [torch.cat([a, b, c], dim=-1), torch.cat([d, e, f], dim=-1),
            torch.cat([g, h, i], dim=-1)]
    return torch.cat(rows, dim=-2)


def gaussian_stitch(joint_mean, joint_cov, marginal_mean, marginal_cov):
    """Moments of q(y) = integral p(y|x) q(x) dx, with p(x, y) =
    N(joint_mean, joint_cov) (x the first m coordinates) and q(x) =
    N(marginal_mean, marginal_cov).  Batched over leading dims."""
    m = marginal_cov.shape[-1]
    cov_xx = joint_cov[..., :m, :m]
    cov_yx = joint_cov[..., m:, :m]
    cov_xy = joint_cov[..., :m, m:]
    cov_yy = joint_cov[..., m:, m:]
    # T = cov_yx cov_xx^{-1}  (solve on the transposed system).  As
    # jnp.linalg.solve, a singular batch element gives non-finite values
    # instead of raising: callers select such elements away.
    t = torch.linalg.solve_ex(cov_xx.transpose(-1, -2),
                              cov_yx.transpose(-1, -2))[0].transpose(-1, -2)
    mean = joint_mean[..., m:] + (t @ marginal_mean[..., None])[..., 0]
    cov = cov_yy - t @ cov_xy + t @ marginal_cov @ t.transpose(-1, -2)
    return mean, cov
