"""Partitioned block-Thomas engine for SPD block-tridiagonal systems
(PyTorch, forward values).

Counterpart of ``cyclic_gps_tpu/ops/partitioned.py``:

  * the chain of N blocks is cut into C chunks of s blocks; chunk
    boundaries (every s-th block) are kept, interiors are eliminated;
  * all C interiors are eliminated simultaneously: one sweep over the
    s-1 interior positions with the chunk axis C vectorised (tensors are
    stored "chunk-major": [step, d, d, C]);
  * the Schur complement onto the boundaries is again block-tridiagonal
    with C blocks and is finished by the same engine recursively, down
    to the cyclic-reduction terminal (< ``_TERMINAL`` blocks).

Math (standard 2x2 block elimination; see the JAX module docstring):
per chain, with block-Cholesky factors D_j and C_j = O_j D_j^{-T},
  W0_1 = D_1^{-1} O_left;  W0_j = -D_j^{-1} C_{j-1} W0_{j-1},
  W1   = D_{s-1}^{-1} O_right^T,
  w_j  = D_j^{-1} (y_j - C_{j-1} w_{j-1}),
and the reduced system over the C boundary blocks is
  diag_c = R_{cs} - sum_j W0_j^T W0_j - (W1^T W1)_{chain c-1},
  off_c  = -(W1^T W0_{s-1})_{chain c},
  rhs_c  = y_{cs} - sum_j W0_j^T w_j - (W1^T w_{s-1})_{chain c-1}.
log|J| = 2 sum log diag D + log|reduced|;  y^T J^{-1} y = sum ||w||^2 +
mahal(reduced, rhs).

Backends: ``"torch"`` runs the plain tensor sweep below on any device;
``"cuda"`` runs the hand-written sweep kernels (ops/sweep_cuda.py);
``"auto"`` picks ``"cuda"`` for CUDA tensors.  Every sweep of the
reduced-system ladder dispatches the same way; only the terminal cyclic
reduction stays plain tensor code.

Gradients: `mahal_and_logdet_cm` is a ``torch.autograd.Function`` whose
backward is the JAX package's analytic adjoint (`_mahal_cm_bwd`): one
collect sweep streaming the shared hat stacks and one descending pass
running the back-substitution and the hat-form Takahashi recursion
(`_solve_inverse_from_cm`), on every backend.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import cyclic_reduction as cr
from . import smallblock as sb

Tensor = torch.Tensor


def default_chunk_len(n: int) -> int:
    """Pick s so the sweep depth and the reduced system are balanced."""
    if n < 32768:
        return 32
    return 128


_TERMINAL = 64  # below this, finish with cyclic reduction


def resolve_backend(backend: str, t: Tensor) -> str:
    """``"auto"`` -> ``"cuda"`` for a CUDA tensor ``t``, else ``"torch"``.

    ``"torch"`` (the counterpart of JAX's explicit ``"xla"``) runs the
    plain tensor code on any device; ``"cuda"`` demands the kernels and
    raises for a tensor that is not on a CUDA device."""
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    if backend == "torch":
        return backend
    if backend == "cuda":
        if not t.is_cuda:
            raise ValueError(
                f"backend='cuda' needs CUDA tensors, got device {t.device}")
        return backend
    raise ValueError(f"unknown backend {backend!r}; "
                     "expected 'auto', 'torch' or 'cuda'")


def _chunk_layout(diag: Tensor, off: Tensor, y: Optional[Tensor], s: int):
    """Natural [N, d, d] blocks -> chunk-major element-major tensors.

    Returns (R_cm [s, d, d, C], O_cm [s, d, d, C], y_cm [s, d, C] | None,
    C).  Index i = c*s + j lives at [j, ..., c].  Padding blocks are
    identity (diag) / zero (off, y) -- exact for logdet / mahal / solve.
    """
    n, d, _ = diag.shape
    c = -(-n // s)
    m = c * s
    if m > n:
        eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
        diag = torch.cat([diag, eye.expand(m - n, d, d)], dim=0)
    off = torch.cat([off, diag.new_zeros((m - n + 1, d, d))], dim=0)
    R_cm = diag.reshape(c, s, d, d).permute(1, 2, 3, 0).contiguous()
    O_cm = off.reshape(c, s, d, d).permute(1, 2, 3, 0).contiguous()
    y_cm = None
    if y is not None:
        if m > n:
            y = torch.cat([y, y.new_zeros((m - n, d))], dim=0)
        y_cm = y.reshape(c, s, d).permute(1, 2, 0).contiguous()
    return R_cm, O_cm, y_cm, c


def _chunk_layout_em(diag_em, off_em, y_em, s: int):
    """`_chunk_layout` on ELEMENT-MAJOR inputs (diag [d, d, n], off
    [d, d, >= n-1] valid to n-2, y [d, n]) -- the reduced-system
    recursion's native format."""
    d, _, n = diag_em.shape
    c = -(-n // s)
    m = c * s
    if m > n:
        diag_em = torch.cat(
            [diag_em, sb.eye_em(d, diag_em).expand(d, d, m - n)], dim=-1)
        y_em = torch.cat([y_em, y_em.new_zeros((d, m - n))], dim=-1)
    off_em = torch.cat(
        [off_em[:, :, : n - 1], diag_em.new_zeros((d, d, m - n + 1))], dim=-1
    )
    R_cm = diag_em.reshape(d, d, c, s).permute(3, 0, 1, 2).contiguous()
    O_cm = off_em.reshape(d, d, c, s).permute(3, 0, 1, 2).contiguous()
    y_cm = y_em.reshape(d, c, s).permute(2, 0, 1).contiguous()
    return R_cm, O_cm, y_cm, c


class _SweepState(NamedTuple):
    c_prev: Optional[Tensor]  # [d, d, C]  C_j after step j
    w0: Tensor  # [d, d, C]  W0_j
    w: Tensor  # [d, C]     w_j
    dj: Tensor  # [d, d, C]  D_j
    invd: Tensor  # [d, C]
    acc00: Tensor  # [d, d, C]  running sum W0^T W0
    accy0: Tensor  # [d, C]     running sum W0^T w
    mh: Tensor  # []         running sum ||w||^2
    ld: Tensor  # []         running sum log diag D


def _step(state: Optional[_SweepState], R_j, O_j, y_j, O_left, jitter):
    """One elimination step.  ``state is None`` marks j = 1 (no previous
    coupling; W0 seeded from the left-boundary coupling O_left)."""
    if state is None:
        P = R_j
    else:
        P = R_j - sb.matmul(state.c_prev, state.c_prev, tb=True)
    D, invd = sb.cholesky(P, jitter=jitter)
    if state is None:
        w0 = sb.solve_lower(D, invd, O_left)
        w = sb.solve_lower_vec(D, invd, y_j)
        acc00 = sb.matmul(w0, w0, ta=True)
        accy0 = sb.matvec(w0, w, ta=True)
        mh = torch.sum(w * w)
        ld = sb.chol_log_diag_sum(D)
    else:
        w0 = -sb.solve_lower(D, invd, sb.matmul(state.c_prev, state.w0))
        w = sb.solve_lower_vec(
            D, invd, y_j - sb.matvec(state.c_prev, state.w)
        )
        acc00 = state.acc00 + sb.matmul(w0, w0, ta=True)
        accy0 = state.accy0 + sb.matvec(w0, w, ta=True)
        mh = state.mh + torch.sum(w * w)
        ld = state.ld + sb.chol_log_diag_sum(D)
    c_new = sb.transpose(sb.solve_lower(D, invd, sb.transpose(O_j)))
    return _SweepState(c_new, w0, w, D, invd, acc00, accy0, mh, ld)


def _collect_solve(state: _SweepState):
    """Per-step back-substitution factors in hat form, so the backward
    walk is pure multiply-add:

      x_j = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}

    with hat_C_j = D_j^{-T} C_j^T, hat_W0_j = D_j^{-T} W0_j and
    hat_w_j = D_j^{-T} w_j."""
    hat_c = sb.solve_lower_t(state.dj, state.invd,
                             sb.transpose(state.c_prev))
    hat_w0 = sb.solve_lower_t(state.dj, state.invd, state.w0)
    hat_w = sb.solve_lower_t_vec(state.dj, state.invd, state.w)
    return hat_c, hat_w0, hat_w


def _collect_solve_inverse(state: _SweepState):
    """The hat factors AND the hat-form Takahashi input from the same
    step: (hat_c, hat_w0, hat_w, pinv) with pinv = P_j^{-1} =
    D_j^{-T} D_j^{-1}.  One collect sweep serves both halves of every
    analytic backward, the solve and the selected inversion."""
    di = sb.tri_lower_inverse(state.dj, state.invd)
    pinv = sb.matmul(di, di, ta=True)
    return _collect_solve(state) + (pinv,)


def _collect_ldrows(state: _SweepState):
    """Per-step per-chunk pivot log-determinants 2 log|D_j| ([C] per
    step) -- the per-row decomposition of the sweep's logdet."""
    return 2.0 * sb.chol_log_diag_rows(state.dj)


_COLLECTORS = {"ldrows": _collect_ldrows,
               "solve_inverse": _collect_solve_inverse}


def _forward_sweep(R_cm, O_cm, y_cm, jitter, collect):
    """Eliminate all chunk interiors (j = 1 .. s-1).

    ``collect`` is None (fused mahal/logdet: nothing stored), "ldrows"
    (per-step pivot log-dets) or "solve_inverse" (the hat factors of
    `_collect_solve` + pinv).  Returns (final state, W1, stacked | None):
    one [s-1, ...] stack, or a tuple of them for a tuple collector.
    """
    s = R_cm.shape[0]
    collector = _COLLECTORS[collect] if collect else None
    state = _step(None, R_cm[1], O_cm[1], y_cm[1], O_cm[0], jitter)
    outs = [collector(state)] if collector else None
    for j in range(2, s):
        state = _step(state, R_cm[j], O_cm[j], y_cm[j], None, jitter)
        if collector:
            outs.append(collector(state))
    stacked = None
    if collector and isinstance(outs[0], tuple):
        stacked = tuple(torch.stack(leaf, dim=0) for leaf in zip(*outs))
    elif collector:
        stacked = torch.stack(outs, dim=0)
    # right coupling: W1 = D_{s-1}^{-1} O_cm[s-1]^T (zero for the last
    # chunk by the trailing-zero invariant)
    w1 = sb.solve_lower(state.dj, state.invd, sb.transpose(O_cm[s - 1]))
    return state, w1, stacked


def _forward_state(R_cm, O_cm, y_cm, jitter, backend):
    """The sweep's final state and W1, by the resolved ``backend``: the
    hand-written kernel ("cuda") or the plain sweep ("torch")."""
    if backend == "cuda":
        from .sweep_cuda import forward_sweep_cuda

        s = R_cm.shape[0]
        (acc00, accy0, w0l, wl, dl, invdl, mh, ld,
         _) = forward_sweep_cuda(R_cm, O_cm, y_cm, jitter=jitter)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(O_cm[s - 1]))
        return _SweepState(None, w0l, wl, dl, invdl, acc00, accy0, mh,
                           ld), w1
    state, w1, _ = _forward_sweep(R_cm, O_cm, y_cm, jitter, collect=None)
    return state, w1


def _reduced_system(R_cm, y_cm, state, w1):
    s11 = sb.matmul(w1, w1, ta=True)
    red_diag = R_cm[0] - state.acc00 - sb.shift_down(s11)
    red_off = -sb.matmul(w1, state.w0, ta=True)  # J[b_{c+1}, b_c]
    red_rhs = (
        y_cm[0]
        - state.accy0
        - sb.shift_down(sb.matvec(w1, state.w, ta=True))
    )
    return red_diag, red_off, red_rhs


def _mahal_and_logdet_em(diag_em, off_em, y_em, jitter, backend="torch"):
    """`_mahal_and_logdet_impl` on element-major inputs (off_em valid to
    n-2; trailing entries ignored) -- the reduced-system recursion.
    ``backend`` is already resolved ("torch" or "cuda")."""
    d, _, n = diag_em.shape
    s = default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        return cr.mahal_and_logdet(
            sb.from_em(diag_em), sb.from_em(off_em)[: n - 1],
            sb.vec_from_em(y_em), jitter=jitter,
        )
    R_cm, O_cm, y_cm, c = _chunk_layout_em(diag_em, off_em, y_em, s)
    state, w1 = _forward_state(R_cm, O_cm, y_cm, jitter, backend)
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    red_mh, red_ld = _mahal_and_logdet_em(red_diag, red_off, red_rhs,
                                          jitter, backend)
    return state.mh + red_mh, 2.0 * state.ld + red_ld


def _mahal_and_logdet_impl(diag, off, y, s, jitter, backend="torch"):
    """Recursive partitioned elimination: each pass shrinks N by ~s until
    the terminal cyclic reduction.  ``backend`` is already resolved."""
    n = diag.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        return cr.mahal_and_logdet(diag, off, y, jitter=jitter)
    R_cm, O_cm, y_cm, c = _chunk_layout(diag, off, y, s)
    state, w1 = _forward_state(R_cm, O_cm, y_cm, jitter, backend)
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    red_mh, red_ld = _mahal_and_logdet_em(red_diag, red_off, red_rhs,
                                          jitter, backend)
    return state.mh + red_mh, 2.0 * state.ld + red_ld


def mahal_and_logdet(
    diag: Tensor,
    off: Tensor,
    y: Tensor,
    s: Optional[int] = None,
    jitter: float = 0.0,
    backend: str = "auto",
) -> Tuple[Tensor, Tensor]:
    """Fused (y^T J^{-1} y, log|J|) via partitioned elimination.

    diag [N, d, d], off [N-1, d, d] (off[i] = J[i+1, i]), y [N, d].
    Matches cr.mahal_and_logdet; a chain of streaming passes, each
    shrinking N by the chunk length.
    """
    n = diag.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        return cr.mahal_and_logdet(diag, off, y, jitter=jitter)
    R_cm, O_cm, y_cm, _ = _chunk_layout(diag, off, y, s)
    return mahal_and_logdet_cm(R_cm, O_cm, y_cm, jitter, backend)


def _mahal_cm_primal(R_cm, O_cm, y_cm, jitter, backend):
    state, w1 = _forward_state(R_cm, O_cm, y_cm, jitter, backend)
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    red_mh, red_ld = _mahal_and_logdet_em(red_diag, red_off, red_rhs,
                                          jitter, backend)
    return state.mh + red_mh, 2.0 * state.ld + red_ld


class _MahalCm(torch.autograd.Function):
    """(mahal, logdet) with the analytic adjoint (O(1) stored state: the
    residuals are the inputs).  With x = J^{-1} y and Sigma = J^{-1}
    (selected blocks):

      d(mh)/dR_i = -x_i x_i^T     d(mh)/dO_i = -2 x_{i+1} x_i^T
      d(ld)/dR_i = Sigma_ii       d(ld)/dO_i = 2 Sigma_{i+1,i}
      d(mh)/dy   = 2 x

    The counterpart of the JAX ``_mahal_cm`` custom VJP
    (partitioned.py:400-444); it is also what makes the kernels, whose
    outputs carry no ``grad_fn``, usable under autograd."""

    @staticmethod
    def forward(ctx, R_cm, O_cm, y_cm, jitter, backend):
        ctx.save_for_backward(R_cm, O_cm, y_cm)
        ctx.jitter, ctx.backend = jitter, backend
        return _mahal_cm_primal(R_cm, O_cm, y_cm, jitter, backend)

    @staticmethod
    def backward(ctx, gm, gl):
        R_cm, O_cm, y_cm = ctx.saved_tensors
        s, d, _, c = R_cm.shape
        x_pad, sig_diag, sig_off = _solve_inverse_from_cm(
            R_cm, O_cm, y_cm, ctx.jitter, ctx.backend)
        xo = x_pad[:, :, None] * x_pad[:, None, :]
        x_next = torch.cat([x_pad[1:], x_pad.new_zeros((1, d))], dim=0)
        xo_off = x_next[:, :, None] * x_pad[:, None, :]  # x_{i+1} x_i^T
        g_diag = gl * sig_diag - gm * xo
        g_off = 2.0 * (gl * sig_off - gm * xo_off)
        g_y = 2.0 * gm * x_pad
        g_R = g_diag.reshape(c, s, d, d).permute(1, 2, 3, 0)
        g_O = g_off.reshape(c, s, d, d).permute(1, 2, 3, 0)
        g_yc = g_y.reshape(c, s, d).permute(1, 2, 0)
        return g_R, g_O, g_yc, None, None


def mahal_and_logdet_cm(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                        jitter: float = 0.0,
                        backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Fused (y^T J^{-1} y, log|J|) on ALREADY chunk-major inputs
    (R_cm/O_cm [s, d, d, C], y_cm [s, d, C], trailing-zero O invariant,
    identity/zero padding for any tail).

    ``backend``: "torch" (plain sweep), "cuda" (the sweep kernels, for
    the top level and every sweep of the reduced ladder) or "auto" (cuda
    for CUDA tensors).  The JAX counterpart defaults to its plain
    backend; here "auto" is the default so that a CUDA caller never runs
    the plain sweep without asking for it.  Differentiable on every
    backend through the analytic adjoint (`_MahalCm`)."""
    return _MahalCm.apply(R_cm, O_cm, y_cm, jitter,
                          resolve_backend(backend, R_cm))


# ---------------------------------------------------------------------------
# The fused solve + selected inversion: the backward of every analytic VJP.
# The Takahashi recurrence in hat variables needs only (hat_c = D^{-T} C^T,
# hat_w0 = D^{-T} W0, pinv = P^{-1} = D^{-T} D^{-1}):
#
#   phi_off_j = -phi_{j+1} hat_c_j^T
#   phi_j     = pinv_j + hat_c_j phi_{j+1} hat_c_j^T
#   u0_j      = hat_w0_j - hat_c_j u0_{j+1}
#   u1_j      = -hat_c_j u1_{j+1}
#
# so one collect sweep (collect="solve_inverse") serves both the
# back-substitution and the Takahashi walk; on the card both walks run in
# one descending kernel (ops/sweep_cuda.backward_solve_takahashi_cuda).
# ---------------------------------------------------------------------------


def _back_substitute(state, w1, hat_cs, hat_w0s, hat_ws, xb, c):
    """Chain back-substitution on the hat factors + the reduced boundary
    solution xb [d, C] -> the padded natural-order solution [C*s, d]
    (the plain branch of the JAX function; its kernel branch belongs to
    the posterior slice)."""
    s = hat_cs.shape[0] + 1
    xb_next = sb.shift_up(xb)  # next chunk's boundary (0 for last)
    hat_w1 = sb.solve_lower_t(state.dj, state.invd, w1)
    # last interior row j = s-1 (carries the W1 term, no x_{j+1}); hats
    # recomputed from the live final state
    hat_w0_l = sb.solve_lower_t(state.dj, state.invd, state.w0)
    hat_w_l = sb.solve_lower_t_vec(state.dj, state.invd, state.w)
    x = (hat_w_l - sb.matvec(hat_w0_l, xb) - sb.matvec(hat_w1, xb_next))
    rows = [x]
    for t in range(s - 3, -1, -1):
        x = (hat_ws[t] - sb.matvec(hat_w0s[t], xb)
             - sb.matvec(hat_cs[t], x))
        rows.append(x)
    interior = torch.stack(rows[::-1], dim=0)  # [s-1, d, C], j = 1..s-1
    x_cm = torch.cat([xb[None], interior], dim=0)
    d = xb.shape[0]
    return x_cm.permute(2, 0, 1).reshape(c * s, d)


def _takahashi_hat_walk(hc_s, hw0_s, pinv_s, hat_w1, p00, p01, p10, p11):
    """Hat-form Takahashi recursion over one level's collected stacks
    (plain loop; the kernel twin is fused into
    `backward_solve_takahashi_cuda`).

    hc_s / hw0_s / pinv_s: [s-1, d, d, C] per-step stacks (steps
    j = 1..s-1); hat_w1 = D_{s-1}^{-T} W1; p00/p01/p10/p11: the reduced
    boundary system's selected-inverse blocks [d, d, C].  Returns
    (diag_int [s-1, d, d, C] = Sigma_jj rows j = 1..s-1,
     off_rows [s-1, d, d, C] = Sigma_{j+1, j} rows j = 1..s-1 (row s-1
     is the right-edge block), u0_final, u1_final [d, d, C])."""
    mm = sb.matmul

    def sigma_bb_ut(u0, u1):
        a0 = mm(p00, u0, tb=True) + mm(p01, u1, tb=True)
        a1 = mm(p10, u0, tb=True) + mm(p11, u1, tb=True)
        return a0, a1

    # seed at j = s-1: phi / u0 are the stacks' last rows
    phi, u0, u1 = pinv_s[-1], hw0_s[-1], hat_w1
    a0, a1 = sigma_bb_ut(u0, u1)
    diags = [phi + mm(u0, a0) + mm(u1, a1)]
    offs = [-a1]
    for t in range(hc_s.shape[0] - 2, -1, -1):
        hc_j = hc_s[t]
        phi_off = -mm(phi, hc_j, tb=True)
        phi_j = pinv_s[t] + mm(mm(hc_j, phi), hc_j, tb=True)
        u0_j = hw0_s[t] - mm(hc_j, u0)
        u1_j = -mm(hc_j, u1)
        a0, a1 = sigma_bb_ut(u0_j, u1_j)
        diags.append(phi_j + mm(u0_j, a0) + mm(u1_j, a1))
        offs.append(phi_off + mm(u0, a0) + mm(u1, a1))
        phi, u0, u1 = phi_j, u0_j, u1_j
    return (torch.stack(diags[::-1], dim=0), torch.stack(offs[::-1], dim=0),
            u0, u1)


def _solve_inverse_em(diag_em, off_em, y_em, jitter, backend="torch"):
    """Recursive fused (J^{-1} y, selected inverse) on element-major
    inputs (off_em valid to n-2).  Returns (x [d, n], sig_diag
    [d, d, n], sig_off [d, d, n] with sig_off[..., i] = Sigma_{i+1, i}
    and the trailing slot zero).  The terminal level shares one CR
    decomposition between the solve and the selected inversion; every
    other level dispatches by the resolved ``backend``."""
    d, _, n = diag_em.shape
    s = default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(sb.from_em(diag_em), sb.from_em(off_em)[: n - 1],
                           jitter=jitter)
        x = cr.solve(dec, sb.vec_from_em(y_em))
        sd, so = cr.inverse_blocks(dec)
        so_em = torch.cat([sb.to_em(so), diag_em.new_zeros((d, d, 1))],
                          dim=-1)
        return sb.vec_to_em(x), sb.to_em(sd), so_em
    R_cm, O_cm, y_cm, c = _chunk_layout_em(diag_em, off_em, y_em, s)
    x_nat, sd_nat, so_nat = _solve_inverse_from_cm(R_cm, O_cm, y_cm,
                                                   jitter, backend)
    return (sb.vec_to_em(x_nat[:n]), sb.to_em(sd_nat[:n]),
            sb.to_em(so_nat[:n]))


def _solve_inverse_from_cm(R_cm, O_cm, y_cm, jitter, backend="torch"):
    """Fused (x = J^{-1} y, selected inverse of J) on chunk-major inputs
    from ONE forward collect sweep; returns padded natural-order
    (x [C*s, d], sig_diag [C*s, d, d], sig_off [C*s, d, d] with row i =
    Sigma_{i+1, i}).  ``backend="cuda"`` runs the sweep as the
    solve+inverse collect kernel and both upward walks as one descending
    kernel; "torch" runs the plain sweep and walks."""
    s, d = R_cm.shape[0], R_cm.shape[1]
    c = R_cm.shape[-1]
    if backend == "cuda":
        from .sweep_cuda import (backward_solve_takahashi_cuda,
                                 forward_sweep_solveinv_cuda)

        (acc00, accy0, w0l, wl, dl, invdl, mh, ld, hc_s, hw0_s, hw_s,
         pinv_s, _) = forward_sweep_solveinv_cuda(R_cm, O_cm, y_cm,
                                                  jitter=jitter)
        state = _SweepState(None, w0l, wl, dl, invdl, acc00, accy0, mh, ld)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(O_cm[s - 1]))
    else:
        state, w1, stacked = _forward_sweep(R_cm, O_cm, y_cm, jitter,
                                            collect="solve_inverse")
        hc_s, hw0_s, hw_s, pinv_s = stacked
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    xb, p00, p10 = _solve_inverse_em(red_diag, red_off, red_rhs, jitter,
                                     backend)
    p11 = sb.shift_up(p00)
    p01 = sb.transpose(p10)
    hat_w1 = sb.solve_lower_t(state.dj, state.invd, w1)
    xb_next = sb.shift_up(xb)

    if backend == "cuda":
        (interior, diag_int, off_rows, u0f,
         u1f) = backward_solve_takahashi_cuda(
            hc_s, hw0_s, hw_s, pinv_s, *[a.contiguous() for a in (
                hat_w1, xb, xb_next, p00, p01, p10, p11)])
    else:
        interior = None  # assembled below by _back_substitute
        diag_int, off_rows, u0f, u1f = _takahashi_hat_walk(
            hc_s, hw0_s, pinv_s, hat_w1, p00, p01, p10, p11)

    off_edge_left = -(sb.matmul(u0f, p00) + sb.matmul(u1f, p10))
    diag_cm = torch.cat([p00[None], diag_int], dim=0)
    off_cm = torch.cat([off_edge_left[None], off_rows], dim=0)
    sig_diag = diag_cm.permute(3, 0, 1, 2).reshape(-1, d, d)
    sig_off = off_cm.permute(3, 0, 1, 2).reshape(-1, d, d)

    if interior is None:
        x_nat = _back_substitute(state, w1, hc_s, hw0_s, hw_s, xb, c)
    else:
        x_cm = torch.cat([xb[None], interior], dim=0)
        x_nat = x_cm.permute(2, 0, 1).reshape(c * s, d)
    return x_nat, sig_diag, sig_off


def solve_and_inverse_cm(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                         jitter: float = 0.0, backend: str = "auto"):
    """(J^{-1} y [C*s, d] padded natural order, Sigma_ii [C*s, d, d],
    Sigma_{i+1,i} [C*s, d, d]) from ONE forward collect sweep and one
    descending pass -- the backward primitive of `mahal_and_logdet_cm`.
    Forward-only entry (it is the backward)."""
    return _solve_inverse_from_cm(R_cm, O_cm, y_cm, jitter,
                                  resolve_backend(backend, R_cm))
