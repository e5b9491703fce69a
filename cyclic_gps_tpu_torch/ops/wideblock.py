"""8-aligned blocked math for wide (8 < d <= 16) small-block batches
(PyTorch).

Counterpart of ``cyclic_gps_tpu/ops/wideblock.py``.  A d = 8 + e block
batch (1 <= e <= 8) is stored as two tensors, chunk (batch) axis last:

    a11 [8, 8, C]    top-left 8x8 block
    st  [3e, 8, C]   row-packed strips:
                       st[0:e]    = A21          (bottom-left  [e, 8])
                       st[e:2e]   = A12^T        (top-right transposed)
                       st[2e:3e]  = A22          (bottom-right [e, e],
                                                  columns >= e ZERO)

On the TPU this layout keeps every sublane dimension at exactly 8.  The
port keeps it at the boundary of the wide kernels (ops/wide_cuda.py) so
that the kernels, their plain twins and the JAX package exchange the same
arrays; the plain twins and the host glue of the wide route
(ops/partitioned.py) compute with the helpers below.

Transposition swaps the two square blocks' leading axes; the strips swap
roles ((A^T)21 = A12^T is how the top-right strip is already stored).

Invariant: the A22 strip's columns >= e are zero.  Every producer below
preserves it (padding columns multiply only zero inputs).

The module keeps the JAX module's whole set of helpers for parity:
`wsub`, `wscale` and `wsolve_lower_t_vec` have no caller in the port and
are exercised only by tests/test_torch_wide.py against their JAX
counterparts.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _sw(a: Tensor) -> Tensor:
    return a.transpose(0, 1)


def _pad_cols(a: Tensor, width: int = 8) -> Tensor:
    """[p, q, C] -> [p, 8, C] with zero columns appended."""
    p, q = a.shape[0], a.shape[1]
    if q == width:
        return a
    return torch.cat([a, a.new_zeros((p, width - q) + a.shape[2:])], dim=1)


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------


def to_wide(x: Tensor) -> Tuple[Tensor, Tensor]:
    """[d, d, C] -> (a11 [8, 8, C], st [3e, 8, C]) for d = 8 + e."""
    a11 = x[:8, :8]
    a21 = x[8:, :8]
    a12t = _sw(x[:8, 8:])
    a22 = _pad_cols(x[8:, 8:])
    return a11.contiguous(), torch.cat([a21, a12t, a22], dim=0)


def from_wide(a11: Tensor, st: Tensor) -> Tensor:
    """Inverse of `to_wide`: (a11, st) -> [d, d, C]."""
    e = st.shape[0] // 3
    a12 = _sw(st[e:2 * e])
    a22 = st[2 * e:, :e]
    top = torch.cat([a11, a12], dim=1)
    bot = torch.cat([st[:e], a22], dim=1)
    return torch.cat([top, bot], dim=0)


def parts(st: Tensor):
    e = st.shape[0] // 3
    return st[:e], st[e:2 * e], st[2 * e:]


def build(a21: Tensor, a12t: Tensor, a22: Tensor) -> Tensor:
    return torch.cat([a21, a12t, a22], dim=0)


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------


def wtranspose(a11: Tensor, st: Tensor) -> Tuple[Tensor, Tensor]:
    """A^T: swap the square blocks' axes; the strips swap roles."""
    a21, a12t, a22 = parts(st)
    e = a21.shape[0]
    a22t = _pad_cols(_sw(a22)[:e])
    return _sw(a11), build(a12t, a21, a22t)


def wadd(a11, ast, b11, bst):
    return a11 + b11, ast + bst


def wsub(a11, ast, b11, bst):
    return a11 - b11, ast - bst


def wscale(a11, ast, s):
    return a11 * s, ast * s


def _outer_sum(a: Tensor, b: Tensor) -> Tensor:
    """sum_k a[:, k] b[k, :] over the columns of a [p, K, C] and the rows
    of b [K, q, C], in ascending k (the TPU kernels' order)."""
    out = a[:, 0:1] * b[0:1]
    for k in range(1, a.shape[1]):
        out = out + a[:, k:k + 1] * b[k:k + 1]
    return out


def wmm(a11, ast, b11, bst) -> Tuple[Tensor, Tensor]:
    """C = A @ B, all wide."""
    a21, a12t, a22 = parts(ast)
    b21, b12t, b22 = parts(bst)
    e = a21.shape[0]
    a12 = _sw(a12t)                    # [8, e, C]
    a11t = _sw(a11)
    b12p = _pad_cols(_sw(b12t))        # [8, 8, C], cols >= e zero
    b22t = _pad_cols(_sw(b22)[:e])     # [e, 8, C]
    c11 = _outer_sum(a11, b11) + _outer_sum(a12, b21[:e])
    c21 = _outer_sum(a21, b11) + _outer_sum(a22[:, :e], b21)
    c12t = _outer_sum(b12t, a11t) + _outer_sum(b22t[:, :e], a12t)
    c22 = _outer_sum(a21, b12p) + _outer_sum(a22[:, :e], b22)
    return c11, build(c21, c12t, c22)


def wmm_tn(a11, ast, b11, bst):
    """A^T @ B."""
    t11, tst = wtranspose(a11, ast)
    return wmm(t11, tst, b11, bst)


def wmm_nt(a11, ast, b11, bst):
    """A @ B^T."""
    t11, tst = wtranspose(b11, bst)
    return wmm(a11, ast, t11, tst)


def wmv(a11, ast, x1, x2) -> Tuple[Tensor, Tensor]:
    """A @ x with x = (x1 [8, 1, C], x2 [e, 1, C])."""
    a21, a12t, a22 = parts(ast)
    e = a21.shape[0]
    y1 = _outer_sum(a11, x1) + _outer_sum(_sw(a12t), x2)
    y2 = _outer_sum(a21, x1) + _outer_sum(a22[:, :e], x2)
    return y1, y2


def wmv_t(a11, ast, x1, x2):
    """A^T @ x."""
    t11, tst = wtranspose(a11, ast)
    return wmv(t11, tst, x1, x2)


# --- small dense helpers on [p, 8, C] panels (p <= 8 rows) ---------------


def _chol_panel(x: Tensor, p: int):
    """Lower Cholesky of the leading p x p block of x [p, 8, C] (columns
    >= p ignored).  rsqrt pivots, no floor, as the TPU kernels take them.
    Returns (L [p, 8, C], inv_diag [p, 1, C], per-lane sum log diag
    [1, 1, C])."""
    cols, invd_rows = [], []
    ld = x.new_zeros((1, 1) + x.shape[2:])
    for j in range(p):
        piv = x[0:1, j:j + 1]
        piv_inv = torch.rsqrt(piv)
        col = x[:, j:j + 1] * piv_inv          # rows j..p-1
        cols.append(torch.cat([col.new_zeros((j,) + col.shape[1:]), col],
                              dim=0) if j else col)
        invd_rows.append(piv_inv)
        ld = ld + 0.5 * torch.log(piv)
        if j + 1 < p:
            # rank-1 downdate of rows j+1..; the padded row has zeros past
            # column p (ignored)
            x = x[1:] - col[1:] * _pad_cols(_sw(cols[-1]))
    L = _pad_cols(torch.cat(cols, dim=1))
    return L, torch.cat(invd_rows, dim=0), ld


def _solve_panel(L: Tensor, invd: Tensor, y: Tensor, p: int) -> Tensor:
    """L X = Y on the leading p x p of L [p, 8, C]; Y [p, q, C]."""
    res, rows = y, []
    for i in range(p):
        xi = res[0:1] * invd[i:i + 1]
        rows.append(xi)
        if i + 1 < p:
            res = res[1:] - L[i + 1:, i:i + 1] * xi
    return torch.cat(rows, dim=0)


def _solve_panel_t(L: Tensor, invd: Tensor, y: Tensor, p: int) -> Tensor:
    """L^T X = Y on the leading p x p of L [p, 8, C]; Y [p, q, C] (back
    substitution)."""
    res, rows = y, [None] * p
    for i in reversed(range(p)):
        xi = res[i:i + 1] * invd[i:i + 1]
        rows[i] = xi
        if i > 0:
            res = res[:i] - _sw(L[i:i + 1])[:i] * xi
    return torch.cat(rows, dim=0)


def wchol(p11, pst):
    """Blocked lower Cholesky of a wide SPD batch.

    Returns (L11 [8, 8, C], Lst [3e, 8, C] with the A12^T strip zero,
    invd1 [8, 1, C], invd2 [e, 1, C], per-lane sum log diag [1, 1, C])."""
    p21, p12t, p22 = parts(pst)
    e = p21.shape[0]
    L11, invd1, ld1 = _chol_panel(p11, 8)
    # L21 = P21 L11^{-T}: solve L11 (L21^T) = P21^T
    l21t = _solve_panel(L11, invd1, _sw(p21), 8)       # [8, e, C]
    l21 = _sw(l21t)                                    # [e, 8, C]
    # Schur complement S = P22 - L21 L21^T (columns >= e stay zero)
    s = p22 - _outer_sum(l21, _pad_cols(l21t))
    L22, invd2, ld2 = _chol_panel(s, e)
    return L11, build(l21, torch.zeros_like(p12t), L22), invd1, invd2, \
        ld1 + ld2


def wsolve_lower(L11, Lst, invd1, invd2, y11, yst):
    """L X = Y with L wide lower-triangular (from `wchol`), Y wide."""
    l21, _, L22 = parts(Lst)
    y21, y12t, y22 = parts(yst)
    e = l21.shape[0]
    # top rows: [X11 | X12] = L11^{-1} [Y11 | Y12]
    x11 = _solve_panel(L11, invd1, y11, 8)
    x12 = _solve_panel(L11, invd1, _sw(y12t), 8)       # [8, e, C]
    # bottom rows: L22 X2 = Y2 - L21 X_top
    r21 = y21 - _outer_sum(l21, x11)
    r22 = y22 - _outer_sum(l21, _pad_cols(x12))
    x21 = _solve_panel(L22, invd2, r21, e)
    x22 = _solve_panel(L22, invd2, r22, e)
    return x11, build(x21, _sw(x12), x22)


def wsolve_lower_vec(L11, Lst, invd1, invd2, y1, y2):
    """L x = y with y = (y1 [8, 1, C], y2 [e, 1, C])."""
    l21, _, L22 = parts(Lst)
    e = l21.shape[0]
    x1 = _solve_panel(L11, invd1, y1, 8)
    x2 = _solve_panel(L22, invd2, y2 - _outer_sum(l21, x1), e)
    return x1, x2


def wsolve_lower_t_vec(L11, Lst, invd1, invd2, y1, y2):
    """L^T x = y (back substitution): bottom rows first."""
    l21, _, L22 = parts(Lst)
    e = l21.shape[0]
    x2 = _solve_panel_t(L22, invd2, y2, e)
    # top rows: L11^T x1 = y1 - L21^T x2
    x1 = _solve_panel_t(L11, invd1, y1 - _outer_sum(_sw(l21), x2), 8)
    return x1, x2


def wsolve_lower_t(L11, Lst, invd1, invd2, y11, yst):
    """L^T X = Y with Y wide (matrix right-hand side)."""
    l21, _, L22 = parts(Lst)
    y21, y12t, y22 = parts(yst)
    e = l21.shape[0]
    # bottom rows first: X2 = L22^{-T} Y2
    x21 = _solve_panel_t(L22, invd2, y21, e)
    x22 = _solve_panel_t(L22, invd2, y22, e)
    # top rows: L11^T X_top = Y_top - L21^T X_bot
    l21t = _sw(l21)                                    # [8, e, C]
    r11 = y11 - _outer_sum(l21t, x21)
    # x22 rows are already zero-padded past column e
    r12p = _pad_cols(_sw(y12t)) - _outer_sum(l21t, x22)
    x11 = _solve_panel_t(L11, invd1, r11, 8)
    x12p = _solve_panel_t(L11, invd1, r12p, 8)         # cols >= e zero
    return x11, build(x21, _sw(x12p)[:e], x22)
