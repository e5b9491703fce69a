"""Element-major batched matrix exponential (Pade-13, dynamic squaring),
PyTorch.

Counterpart of ``cyclic_gps_tpu/ops/expm_em.py``.  The batch lives on
the minor axis ([d, d, N] element-major) and all matrix algebra is the
unrolled small-block kind (ops/smallblock.py).

Algorithm: scaling-and-squaring with the degree-13 Pade approximant
(Higham 2005).  Each matrix is squared back only as often as its own
norm requires; the loop runs to the batch maximum with per-matrix masks,
as the JAX version's ``while_loop`` does.  `expm_em` is a
``torch.autograd.Function`` whose backward is the JAX package's custom
VJP, the Frechet-derivative identity

    expm([[A, E], [0, A]]) = [[e^A, L(A, E)], [0, e^A]],
    adjoint:  A_bar = L(A^T, Y_bar),

i.e. one more (2d x 2d) element-major expm, not autograd through the
squaring loop.
"""

from __future__ import annotations

import torch

from . import smallblock as sb

Tensor = torch.Tensor

_PADE13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
    33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0,
)
_THETA13 = 5.371920351148152
_MAX_SQUARINGS = 40  # safety cap for the dynamic loop


def lu_solve(a: Tensor, b: Tensor) -> Tensor:
    """Per-block solve A X = B by unpivoted Gaussian elimination.

    a: [d, d, B], b: [d, e, B].  Intended for well-conditioned systems
    (the Pade denominator after scaling is I - small); no pivoting.
    """
    d = a.shape[0]
    m = a
    rhs = b
    rows = torch.arange(d, device=a.device)
    for j in range(d):
        piv_inv = 1.0 / m[j, j]
        mask = (rows > j).to(a.dtype)[:, None]
        f = m[:, j] * piv_inv[None, :] * mask  # elimination factors [d, B]
        m = m - f[:, None, :] * m[j][None, :, :]
        rhs = rhs - f[:, None, :] * rhs[j][None, :, :]
    # back substitution (m is now upper triangular)
    x = [None] * d
    for i in reversed(range(d)):
        acc = rhs[i]
        for k in range(i + 1, d):
            acc = acc - m[i, k][None, :] * x[k]
        x[i] = acc / m[i, i][None, :]
    return torch.stack(x, dim=0)


def lu_solve_pivoted(a: Tensor, b: Tensor) -> Tensor:
    """Per-block solve A X = B by Gaussian elimination WITH partial
    pivoting, element-major (a: [d, d, B], b: [d, e, B]).

    For general nonsymmetric systems with no pivot-size guarantee.  Pivot
    selection is a batched argmax + masked row swap.
    """
    d = a.shape[0]
    m = a
    rhs = b
    rows = torch.arange(d, device=a.device)
    for j in range(d):
        # partial pivot: index (>= j) of the largest |column-j| entry
        cand = torch.abs(m[:, j])  # [d, B]
        cand = torch.where((rows >= j)[:, None], cand, -1.0)
        p = torch.argmax(cand, dim=0)  # [B]
        # swap rows j and p in m and rhs (vectorised over the batch)
        sel_p = (rows[:, None] == p[None, :]).to(a.dtype)  # [d, B]
        sel_j = (rows == j).to(a.dtype)[:, None]  # [d, 1]
        row_p_m = torch.einsum("ib,ikb->kb", sel_p, m)  # [d, B]
        row_j_m = m[j]
        m = (
            m
            + sel_j[:, None, :] * (row_p_m - row_j_m)[None]
            - sel_p[:, None, :] * (row_p_m - row_j_m)[None]
        )
        row_p_r = torch.einsum("ib,ikb->kb", sel_p, rhs)
        row_j_r = rhs[j]
        rhs = (
            rhs
            + sel_j[:, None, :] * (row_p_r - row_j_r)[None]
            - sel_p[:, None, :] * (row_p_r - row_j_r)[None]
        )
        piv_inv = 1.0 / m[j, j]
        mask = (rows > j).to(a.dtype)[:, None]
        f = m[:, j] * piv_inv[None, :] * mask
        m = m - f[:, None, :] * m[j][None, :, :]
        rhs = rhs - f[:, None, :] * rhs[j][None, :, :]
    x = [None] * d
    for i in reversed(range(d)):
        acc = rhs[i]
        for k in range(i + 1, d):
            acc = acc - m[i, k][None, :] * x[k]
        x[i] = acc / m[i, i][None, :]
    return torch.stack(x, dim=0)


def _expm_em_impl(a: Tensor) -> Tensor:
    d = a.shape[0]
    eye = sb.eye_em(d, a)

    # per-matrix inf-norm (max absolute row sum)
    norm = torch.amax(torch.sum(torch.abs(a), dim=1), dim=0)  # [B]
    s = torch.ceil(torch.log2(torch.clamp(norm / _THETA13, min=1.0)))
    s = torch.clamp(s, 0, _MAX_SQUARINGS)
    a = a * torch.exp2(-s)[None, None, :]

    b = _PADE13
    a2 = sb.matmul(a, a)
    a4 = sb.matmul(a2, a2)
    a6 = sb.matmul(a2, a4)
    w1 = b[13] * a6 + b[11] * a4 + b[9] * a2
    w2 = b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye
    u = sb.matmul(a, sb.matmul(a6, w1) + w2)
    z1 = b[12] * a6 + b[10] * a4 + b[8] * a2
    v = sb.matmul(a6, z1) + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye

    r = lu_solve(v - u, v + u)

    # masked squaring: only as many rounds as the batch needs (one host
    # read of the batch maximum, the counterpart of the JAX while_loop)
    s_max = int(torch.amax(s)) if s.numel() else 0
    for k in range(s_max):
        do = (s > k).to(a.dtype)[None, None, :]
        r = do * sb.matmul(r, r) + (1.0 - do) * r
    return r


class _ExpmEm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _expm_em_impl(a)

    @staticmethod
    def backward(ctx, ybar):
        (a,) = ctx.saved_tensors
        d = a.shape[0]
        a_t = sb.transpose(a)
        top = torch.cat([a_t, ybar], dim=1)
        bot = torch.cat([torch.zeros_like(a), a_t], dim=1)
        return _expm_em_impl(torch.cat([top, bot], dim=0))[:d, d:]


def expm_em(a: Tensor) -> Tensor:
    """Batched expm of an element-major batch [d, d, B] -> [d, d, B],
    differentiable through the Frechet VJP (module docstring)."""
    return _ExpmEm.apply(a)
