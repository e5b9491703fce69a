"""Branch-free cyclic reduction for symmetric block-tridiagonal matrices
(PyTorch).

Counterpart of ``cyclic_gps_tpu/ops/cyclic_reduction.py``:

* **Power-of-two padding.**  The input matrix (N diagonal blocks) is
  extended to M = 2^ceil(log2 N) blocks with identity diagonal blocks and
  zero off-diagonal blocks; the padded matrix is block-diag(J, I), so its
  log-det, solves, Mahalanobis forms and inverse blocks restrict exactly
  to the original ones, and every reduction level halves exactly.
* **Trailing-zero invariant.**  Off-diagonal batches have the length of
  the diagonal batch with the (absent) last block held at zero; one
  reduction level maps this invariant to itself, so every level is the
  same branch-free computation.

All block math runs in element-major layout (ops/smallblock.py).

* ``decompose`` is the block Cholesky L of T J T^T where T is the
  recursive even/odd permutation.
* ``logdet`` returns log|J|; ``mahal`` returns y^T J^{-1} y; ``solve``
  returns J^{-1} y; ``mahal_and_logdet`` is the fused single pass;
  ``inverse_blocks`` returns the tridiagonal blocks of J^{-1}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import torch

from . import smallblock as sb

Tensor = torch.Tensor


class CRLevel(NamedTuple):
    """One cyclic-reduction level (element-major tensors, m blocks each).

    D:        Cholesky factors of the even diagonal blocks      [d, d, m]
    D_invd:   reciprocals of diag(D)                            [d, m]
    F:        U diagonal blocks  (Oe_k D_k^{-T})                [d, d, m]
    G:        U off-diag blocks  (Oo_k^T D_{k+1}^{-T}); G[m-1]=0 [d, d, m]
    """

    D: Tensor
    D_invd: Tensor
    F: Tensor
    G: Tensor


@dataclass
class CRDecomposition:
    """Full cyclic-reduction decomposition.

    levels:  finest-to-coarsest CRLevels (level k has M/2^{k+1} blocks).
    D_last:  Cholesky of the final 1-block system                [d, d, 1]
    D_last_invd:                                                  [d, 1]
    n:       original (unpadded) number of diagonal blocks.
    """

    levels: Tuple[CRLevel, ...]
    D_last: Tensor
    D_last_invd: Tensor
    n: int


def padded_size(n: int) -> int:
    """Next power of two >= n."""
    return 1 << max(0, (n - 1).bit_length())


def level_sizes(n: int) -> List[int]:
    """Number of *real* (unpadded) blocks eliminated at each padded level;
    the final entry is for the last 1-block system (real iff n is a
    power of two)."""
    m = padded_size(n)
    sizes = []
    for k in range(m.bit_length() - 1):
        step = 1 << (k + 1)
        first = (1 << k) - 1
        sizes.append(max(0, -(-(n - first) // step)))
    sizes.append(1 if n == m else 0)
    return sizes


def pad_blocks(diag: Tensor, off: Tensor) -> Tuple[Tensor, Tensor]:
    """Pad to power-of-two size; returns element-major (R, O), both [d,d,M].

    diag: [N, d, d]; off: [N-1, d, d] with off[i] = J[i+1, i].
    Padding blocks are identity (diag) / zero (off); O[M-1] is the
    invariant zero slot.
    """
    n, d, _ = diag.shape
    m = padded_size(n)
    R = sb.to_em(diag)
    O = sb.to_em(off) if n > 1 else diag.new_zeros((d, d, 0))
    if m > n:
        R = torch.cat([R, sb.eye_em(d, diag).expand(d, d, m - n)], dim=-1)
    O = torch.cat([O, diag.new_zeros((d, d, m - n + 1))], dim=-1)
    return R, O


def _reduction_level(R: Tensor, O: Tensor, jitter: float = 0.0, shifts=sb):
    """One branch-free CR level.

    R, O: [d, d, m] element-major, m even, with O[..., m-1] == 0.
    Returns (CRLevel with m/2 blocks, (R', O') of the half-size system with
    the same trailing-zero invariant).  ``shifts`` supplies the one-block
    nearest-neighbour shifts (shift_up / shift_up_chol).
    """
    Re, Ro = R[..., 0::2], R[..., 1::2]
    Oe, Oo = O[..., 0::2], O[..., 1::2]

    D, D_invd = sb.cholesky(Re, jitter=jitter)
    # F_k = Oe_k D_k^{-T}  <=>  D_k F_k^T = Oe_k^T
    F = sb.transpose(sb.solve_lower(D, D_invd, sb.transpose(Oe)))
    # G_k = Oo_k^T D_{k+1}^{-T}  <=>  D_{k+1} G_k^T = Oo_k
    D1, D1_invd = shifts.shift_up_chol(D, D_invd)
    G = sb.transpose(sb.solve_lower(D1, D1_invd, Oo))

    # Schur complement of the even blocks: R' = Ro - F F^T - G G^T,
    # O'_k = -F_{k+1} G_k^T.  G[m/2-1] = 0 keeps the invariant O'[m/2-1] = 0.
    Rn = Ro - sb.matmul(F, F, tb=True) - sb.matmul(G, G, tb=True)
    On = -sb.matmul(shifts.shift_up(F), G, tb=True)
    return CRLevel(D, D_invd, F, G), (Rn, On)


def _fused_levels(R, O, yt, jitter: float = 0.0, shifts=sb, stop: int = 1):
    """Run reduction levels while more than ``stop`` blocks remain,
    accumulating the Mahalanobis and half-log-det contributions.

    Returns (R, O, yt, mahal_partial, half_logdet_partial).
    """
    mh = R.new_zeros(())
    ld = R.new_zeros(())
    while R.shape[-1] > stop:
        lvl, (R, O) = _reduction_level(R, O, jitter=jitter, shifts=shifts)
        ld = ld + sb.chol_log_diag_sum(lvl.D)
        z = sb.solve_lower_vec(lvl.D, lvl.D_invd, yt[:, 0::2])
        mh = mh + torch.sum(z * z)
        yt = yt[:, 1::2] - (
            sb.matvec(lvl.F, z) + sb.matvec(lvl.G, shifts.shift_up(z))
        )
    return R, O, yt, mh, ld


def _pad_rhs(y: Tensor, m: int) -> Tensor:
    """Natural [n, d] -> element-major [d, m] with zero padding."""
    n, d = y.shape
    return torch.cat([sb.vec_to_em(y), y.new_zeros((d, m - n))], dim=-1)


def decompose(diag: Tensor, off: Tensor, jitter: float = 0.0) -> CRDecomposition:
    """Cyclic-reduction (= permuted block Cholesky) of a SPD block-tridiag J.

    diag: [N, d, d] diagonal blocks; off: [N-1, d, d] lower off-diagonals
    (off[i] = J[i+1, i]).
    """
    n = diag.shape[0]
    R, O = pad_blocks(diag, off)
    levels = []
    while R.shape[-1] > 1:
        level, (R, O) = _reduction_level(R, O, jitter=jitter)
        levels.append(level)
    D_last, D_last_invd = sb.cholesky(R, jitter=jitter)
    return CRDecomposition(tuple(levels), D_last, D_last_invd, n)


def halfsolve(decomp: CRDecomposition, y: Tensor) -> List[Tensor]:
    """Solve L z = T y level by level.

    y: [N, d].  Returns the cyclic-reduction representation of z: a list
    of per-level tensors of shape [m_k, d] (unpadded sizes).
    """
    n = y.shape[0]
    yt = _pad_rhs(y, padded_size(n))
    sizes = level_sizes(n)
    zs: List[Tensor] = []
    for k, lvl in enumerate(decomp.levels):
        z = sb.solve_lower_vec(lvl.D, lvl.D_invd, yt[:, 0::2])
        zs.append(sb.vec_from_em(z)[: sizes[k]])
        # residual: Q y - U z  with U z = F z + G (shift-up z)
        yt = yt[:, 1::2] - (
            sb.matvec(lvl.F, z) + sb.matvec(lvl.G, sb.shift_up(z))
        )
    if sizes[-1] > 0:
        z = sb.solve_lower_vec(decomp.D_last, decomp.D_last_invd, yt)
        zs.append(sb.vec_from_em(z)[: sizes[-1]])
    return zs


def backhalfsolve(decomp: CRDecomposition, zs: Sequence[Tensor]) -> Tensor:
    """Solve L^T x = z bottom-up, returning x in natural order [N, d]."""
    n = decomp.n
    d = decomp.D_last.shape[0]
    ref = decomp.D_last
    sizes = level_sizes(n)
    pad_sizes = [padded_size(n) >> (k + 1) for k in range(len(decomp.levels))]
    pad_sizes.append(1)

    def pad_level(z, target):
        z_em = sb.vec_to_em(z.to(ref.dtype))
        extra = target - z_em.shape[-1]
        if extra:
            z_em = torch.cat([z_em, ref.new_zeros((d, extra))], dim=-1)
        return z_em

    if sizes[-1] > 0:
        z_last = pad_level(zs[-1], pad_sizes[-1])
    else:
        z_last = ref.new_zeros((d, 1))
    x = sb.solve_lower_t_vec(decomp.D_last, decomp.D_last_invd, z_last)
    for k in range(len(decomp.levels) - 1, -1, -1):
        lvl = decomp.levels[k]
        # U^T x: (U^T x)_j = F_j^T x_j + G_{j-1}^T x_{j-1}
        utx = sb.matvec(lvl.F, x, ta=True) + sb.shift_down(
            sb.matvec(lvl.G, x, ta=True)
        )
        yt = pad_level(zs[k], pad_sizes[k]) - utx
        x_even = sb.solve_lower_t_vec(lvl.D, lvl.D_invd, yt)
        x = sb.interleave(x_even, x)
    return sb.vec_from_em(x)[:n]


def solve(decomp: CRDecomposition, y: Tensor) -> Tensor:
    """J^{-1} y for y [N, d]."""
    return backhalfsolve(decomp, halfsolve(decomp, y))


def logdet(decomp: CRDecomposition) -> Tensor:
    """log |J| = 2 sum log diag(D) over all levels (padding adds log 1)."""
    acc = sb.chol_log_diag_sum(decomp.D_last)
    for lvl in decomp.levels:
        acc = acc + sb.chol_log_diag_sum(lvl.D)
    return 2.0 * acc


def mahal(decomp: CRDecomposition, y: Tensor) -> Tensor:
    """y^T J^{-1} y = ||L^{-1} T y||^2."""
    zs = halfsolve(decomp, y)
    return sum(torch.sum(z * z) for z in zs)


def mahal_and_logdet(
    diag: Tensor, off: Tensor, y: Tensor, jitter: float = 0.0
) -> Tuple[Tensor, Tensor]:
    """Fused single pass computing (y^T J^{-1} y, log|J|) without storing
    the decomposition."""
    n = y.shape[0]
    R, O = pad_blocks(diag, off)
    yt = _pad_rhs(y, R.shape[-1])
    R, O, yt, mh, ld = _fused_levels(R, O, yt, jitter=jitter)
    D, D_invd = sb.cholesky(R, jitter=jitter)
    ld = ld + sb.chol_log_diag_sum(D)
    z = sb.solve_lower_vec(D, D_invd, yt)
    mh = mh + torch.sum(z * z)
    return mh, 2.0 * ld


def logdet_direct(diag: Tensor, off: Tensor, jitter: float = 0.0) -> Tensor:
    """Fused log|J| without storing the decomposition or touching a RHS."""
    R, O = pad_blocks(diag, off)
    ld = diag.new_zeros(())
    while R.shape[-1] > 1:
        lvl, (R, O) = _reduction_level(R, O, jitter=jitter)
        ld = ld + sb.chol_log_diag_sum(lvl.D)
    D, _ = sb.cholesky(R, jitter=jitter)
    return 2.0 * (ld + sb.chol_log_diag_sum(D))


def inverse_blocks(decomp: CRDecomposition) -> Tuple[Tensor, Tensor]:
    """Diagonal and lower off-diagonal blocks of J^{-1}.

    Bottom-up selected inversion: at each level, with permuted factor
    [[D, 0], [W, L~]] and coarse inverse blocks Sig = (L~ L~^T)^{-1}, the
    fine-level inverse blocks are assembled from D^{-1}, W D^{-1} and Sig.
    Returns ([N, d, d], [N-1, d, d]).
    """
    Di = sb.tri_lower_inverse(decomp.D_last, decomp.D_last_invd)
    Sd = sb.matmul(Di, Di, ta=True)  # [d, d, 1]
    So = torch.zeros_like(Sd)  # trailing-zero invariant
    for lvl in reversed(decomp.levels):
        D, D_invd, F, G = lvl
        Di = sb.tri_lower_inverse(D, D_invd)
        DtiDi = sb.matmul(Di, Di, ta=True)
        FDi = sb.matmul(F, Di)
        GDi = sb.matmul(G, sb.shift_up(Di))  # pad irrelevant: G last = 0
        # V = -Sig (W D^{-1}): main and upper-diagonal blocks.
        Vd = -(sb.matmul(Sd, FDi) + sb.shift_down(sb.matmul(So, GDi)))
        Vo = -(
            sb.matmul(Sd, GDi)
            + sb.matmul(sb.transpose(So), sb.shift_up(FDi))
        )
        # Even diagonal blocks: D^{-T}D^{-1} + (WD^{-1})^T Sig (WD^{-1}).
        newd = DtiDi - (
            sb.matmul(FDi, Vd, ta=True)
            + sb.shift_down(sb.matmul(GDi, Vo, ta=True))
        )
        Sd = sb.interleave(newd, Sd)
        So = sb.interleave(Vd, sb.transpose(Vo))
    n = decomp.n
    return sb.from_em(Sd)[:n], sb.from_em(So)[: n - 1]
