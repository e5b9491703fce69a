"""Element-major batched small-block linear algebra (PyTorch).

Counterpart of ``cyclic_gps_tpu/ops/smallblock.py``.  A batch of B tiny
d x d blocks is stored as a tensor of shape ``[d, d, B]`` so the huge
batch axis is the minor (contiguous) dimension and every block operation
is a handful of wide elementwise tensor ops.  Factorizations and solves
are d-step column sweeps over whole ``[d, B]`` / ``[d, d, B]`` tensors,
unrolled in Python (d is small).

Conventions
-----------
* "em" (element-major) block batches: ``[d, d, B]``; ``A[i, k]`` is a [B]
  vector holding element (i, k) of every block.
* em vector batches: ``[d, B]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def to_em(blocks: Tensor) -> Tensor:
    """[B, d, d] batch-major -> [d, d, B] element-major."""
    return blocks.permute(1, 2, 0)


def from_em(blocks_em: Tensor) -> Tensor:
    """[d, d, B] element-major -> [B, d, d] batch-major."""
    return blocks_em.permute(2, 0, 1)


def vec_to_em(x: Tensor) -> Tensor:
    """[B, d] -> [d, B]."""
    return x.transpose(0, 1)


def vec_from_em(x_em: Tensor) -> Tensor:
    """[d, B] -> [B, d]."""
    return x_em.transpose(0, 1)


def transpose(a: Tensor) -> Tensor:
    """Per-block transpose of an em batch: swap the two element axes."""
    return a.transpose(0, 1)


def eye_em(d: int, like: Tensor) -> Tensor:
    """[d, d, 1] identity with the dtype/device of ``like``."""
    return torch.eye(d, dtype=like.dtype, device=like.device)[:, :, None]


def identity_like(a: Tensor) -> Tensor:
    """em batch of identity blocks with the shape/dtype of ``a``."""
    return eye_em(a.shape[0], a).expand(a.shape)


def matmul(a: Tensor, b: Tensor, ta: bool = False, tb: bool = False) -> Tensor:
    """Per-block matmul of em batches as a sum of k outer products.

    Computes ``op(a) @ op(b)`` per block where ``op`` optionally transposes.
    a: [d, p, B] (or transposed), b: [p, e, B] (or transposed) -> [d, e, B].
    """
    if ta:
        a = transpose(a)
    if tb:
        b = transpose(b)
    p = a.shape[1]
    acc = a[:, 0, None, :] * b[None, 0, :, :]
    for k in range(1, p):
        acc = acc + a[:, k, None, :] * b[None, k, :, :]
    return acc


def matvec(a: Tensor, x: Tensor, ta: bool = False) -> Tensor:
    """Per-block matrix-vector product: a [d, p, B], x [p, B] -> [d, B]."""
    if ta:
        a = transpose(a)
    p = a.shape[1]
    acc = a[:, 0, :] * x[None, 0, :]
    for k in range(1, p):
        acc = acc + a[:, k, :] * x[None, k, :]
    return acc


def _col_mask(d: int, j: int, like: Tensor) -> Tensor:
    """[d, 1] mask selecting rows >= j."""
    return (torch.arange(d, device=like.device) >= j).to(like.dtype)[:, None]


PIVOT_FLOOR_F32 = 1e-6  # relative pivot floor for single precision


def cholesky(a: Tensor, jitter: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Per-block lower Cholesky of an em batch of SPD blocks.

    Outer-product form: d steps, each extracting one scaled column and
    applying a rank-1 downdate to the trailing submatrix.  Returns
    ``(L, inv_diag)`` with ``inv_diag[j] = 1 / L[j, j]`` ([d, B]).

    At single precision, pivots are floored at ``PIVOT_FLOOR_F32`` times
    the original diagonal entry (roundoff can drive true-positive pivots
    of very ill-conditioned blocks negative); at float64 the floor is off
    and the factorization is exact.
    """
    d = a.shape[0]
    x = a + jitter * eye_em(d, a) if jitter else a
    floor_rel = PIVOT_FLOOR_F32 if a.dtype == torch.float32 else 0.0
    cols = []
    invs = []
    for j in range(d):
        piv = x[j, j]
        if floor_rel:
            piv = torch.maximum(piv, floor_rel * a[j, j])
        piv_inv = 1.0 / torch.sqrt(piv)
        col = x[:, j] * (piv_inv[None, :] * _col_mask(d, j, a))
        if floor_rel:
            col = col.clone()
            col[j] = torch.sqrt(piv)
        cols.append(col)
        invs.append(piv_inv)
        if j + 1 < d:
            x = x - col[:, None, :] * col[None, :, :]
    L = torch.stack(cols, dim=1)  # columns j -> axis 1
    return L, torch.stack(invs, dim=0)


def chol_log_diag_sum(L: Tensor) -> Tensor:
    """sum log L[j, j] over blocks and batch -> scalar."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=0, dim2=1)))


def chol_log_diag_rows(L: Tensor) -> Tensor:
    """sum log L[j, j] over the block dims only -> [B]."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=0, dim2=1)), dim=1)


def solve_lower(L: Tensor, inv_diag: Tensor, y: Tensor) -> Tensor:
    """Per-block lower-triangular solve ``L X = Y`` with matrix RHS.

    L: [d, d, B], inv_diag: [d, B], y: [d, e, B] -> x: [d, e, B].
    """
    d = L.shape[0]
    res = y
    rows = []
    for i in range(d):
        xi = res[i] * inv_diag[i][None, :]  # [e, B]
        rows.append(xi)
        if i + 1 < d:
            res = res - L[:, i, None, :] * xi[None, :, :]
    return torch.stack(rows, dim=0)


def solve_lower_vec(L: Tensor, inv_diag: Tensor, y: Tensor) -> Tensor:
    """Per-block lower-triangular solve ``L x = y`` with vector RHS [d, B]."""
    d = L.shape[0]
    res = y
    comps = []
    for i in range(d):
        xi = res[i] * inv_diag[i]
        comps.append(xi)
        if i + 1 < d:
            res = res - L[:, i, :] * xi[None, :]
    return torch.stack(comps, dim=0)


def solve_lower_t(L: Tensor, inv_diag: Tensor, y: Tensor) -> Tensor:
    """Per-block solve ``L^T X = Y`` (back substitution), matrix RHS
    [d, e, B]."""
    d = L.shape[0]
    res = y
    rows = [None] * d
    for i in reversed(range(d)):
        xi = res[i] * inv_diag[i][None, :]
        rows[i] = xi
        if i > 0:
            res = res - L[i, :, None, :] * xi[None, :, :]
    return torch.stack(rows, dim=0)


def solve_lower_t_vec(L: Tensor, inv_diag: Tensor, y: Tensor) -> Tensor:
    """Per-block solve ``L^T x = y`` (back substitution), vector RHS [d, B]."""
    d = L.shape[0]
    res = y
    comps = [None] * d
    for i in reversed(range(d)):
        xi = res[i] * inv_diag[i]
        comps[i] = xi
        if i > 0:
            res = res - L[i, :, :] * xi[None, :]  # (L^T)[:, i] = L[i, :]
    return torch.stack(comps, dim=0)


def tri_lower_inverse(L: Tensor, inv_diag: Tensor) -> Tensor:
    """Per-block inverse of a lower-triangular em batch via a triangular
    solve against the identity."""
    return solve_lower(L, inv_diag, identity_like(L))


# ---------------------------------------------------------------------------
# Shifts along the batch (block-sequence) axis: the nearest-neighbour
# coupling of the block-tridiagonal structure.
# ---------------------------------------------------------------------------


def shift_up(a: Tensor) -> Tensor:
    """a[..., k] <- a[..., k+1]; last entry zero-filled."""
    pad = a.new_zeros(a.shape[:-1] + (1,))
    return torch.cat([a[..., 1:], pad], dim=-1)


def shift_down(a: Tensor) -> Tensor:
    """a[..., k] <- a[..., k-1]; first entry zero-filled."""
    pad = a.new_zeros(a.shape[:-1] + (1,))
    return torch.cat([pad, a[..., :-1]], dim=-1)


def shift_up_chol(L: Tensor, inv_diag: Tensor) -> Tuple[Tensor, Tensor]:
    """Shift a Cholesky-factor batch up one block, padding with identity.

    The pad value multiplies only zero blocks (the trailing off-diagonal
    invariant), but must be a valid triangular factor so reciprocals stay
    finite.
    """
    d = L.shape[0]
    L_pad = torch.cat([L[..., 1:], eye_em(d, L)], dim=-1)
    one = inv_diag.new_ones(inv_diag.shape[:-1] + (1,))
    inv_pad = torch.cat([inv_diag[..., 1:], one], dim=-1)
    return L_pad, inv_pad


def interleave(a: Tensor, b: Tensor) -> Tensor:
    """Merge even (a) and odd (b) subsequences along the last axis.

    a, b: [..., m] -> [..., 2m] with out[..., 0::2] = a, out[..., 1::2] = b.
    """
    stacked = torch.stack([a, b], dim=-1)
    return stacked.reshape(a.shape[:-1] + (a.shape[-1] * 2,))
