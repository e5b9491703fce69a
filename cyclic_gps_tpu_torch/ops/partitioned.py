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

Entries: (mahal, logdet) `mahal_and_logdet(_cm)` and `logdet`; the solve
`solve(_cm)` / `solve_and_logdet`; the per-row pivot log-dets
`logdet_rows(_cm)`, `logdet_per_segment` and the fused
`solve_and_ld_rows_cm`; the selected inversion `inverse_blocks(_cm)`; and
the fused solve + selected inversion `solve_and_inverse_cm`.

Backends: ``"torch"`` runs the plain tensor sweeps below on any device;
``"cuda"`` runs the hand-written sweep kernels (ops/sweep_cuda.py);
``"auto"`` picks ``"cuda"`` for CUDA tensors, at float32 and float64
alike.  Every sweep of the reduced-system ladder dispatches the same way
(the JAX package runs its ladder levels on XLA); only the terminal
cyclic reduction stays plain tensor code.  At 8 < d < 16 the
natural-layout `mahal_and_logdet` on "cuda" takes the wide route
(`_MahalWide`, the wide-layout kernels of ops/wide_cuda.py), and so do the
(mahal, logdet) ladder and the fused solve + selected inversion of every
analytic backward (`_solve_inverse_from_cm`) at those sizes; the solve and
the selected inversion run their own kernels' runtime-d instances there
(ops/sweep_cuda.py); the entries whose forward runs the likelihood's sweep
kernel (the chunk-major (mahal, logdet), the per-row log-dets) have no
kernel at those sizes and refuse on "cuda".

Gradients: `mahal_and_logdet_cm`, `solve_cm`, `logdet_rows_cm` and
`solve_and_ld_rows_cm` are ``torch.autograd.Function``s whose backwards
are the JAX package's analytic adjoints (`_mahal_cm_bwd`,
`_solve_cm_bwd`, `_ld_rows_cm_bwd`, `_solve_ldr_cm_bwd`), built on one
collect sweep streaming the shared hat stacks and one descending pass
running the back-substitution and the hat-form Takahashi recursion
(`_solve_inverse_from_cm`), on every backend.  The selected inversion
has no backward of its own: its plain route differentiates by autograd,
its kernel route refuses inputs that require grad (as the JAX package's
TPU kernels have no VJP either).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import cyclic_reduction as cr
from . import smallblock as sb
from . import wideblock as wb

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


def _collect_inverse(state: _SweepState):
    """Per-step raw factors for the selected inversion (D, invd, C, W0)."""
    return state.dj, state.invd, state.c_prev, state.w0


def _collect_solve_ldrows(state: _SweepState):
    """The hat factors AND the per-row pivot log-dets from the same step
    (the fused solve + per-row log-det sweep, `solve_and_ld_rows_cm`)."""
    return _collect_solve(state) + (_collect_ldrows(state),)


def _collect_solve_inverse_ld(state: _SweepState):
    """`_collect_solve_inverse` plus the per-row pivot log-dets."""
    return _collect_solve_inverse(state) + (_collect_ldrows(state),)


_COLLECTORS = {"solve": _collect_solve, "inverse": _collect_inverse,
               "ldrows": _collect_ldrows,
               "solve_ldrows": _collect_solve_ldrows,
               "solve_inverse": _collect_solve_inverse,
               "solve_inverse_ld": _collect_solve_inverse_ld}


def _forward_sweep(R_cm, O_cm, y_cm, jitter, collect):
    """Eliminate all chunk interiors (j = 1 .. s-1).

    ``collect`` is None (fused mahal/logdet: nothing stored) or a key of
    `_COLLECTORS` ("solve": the hat factors of `_collect_solve`,
    "inverse": the raw factors, "ldrows": per-step pivot log-dets, and
    their combinations).  Returns (final state, W1, stacked | None): one
    [s-1, ...] stack, or a tuple of them for a tuple collector.
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
    if _is_wide(d, backend):
        return _mahal_wide_cm_primal(*_to_wide_stack(R_cm),
                                     *_to_wide_stack(O_cm), y_cm, jitter)
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
    shrinking N by the chunk length.  At 8 < d < 16 on the kernels
    (``backend`` resolving to "cuda") it takes the wide route
    (`_MahalWide`: kernel 16 forward, 21 and 22 in the analytic
    backward), as the JAX package does on the TPU.
    """
    n, d = diag.shape[0], diag.shape[1]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        return cr.mahal_and_logdet(diag, off, y, jitter=jitter)
    if _is_wide(d, resolve_backend(backend, diag)):
        return _MahalWide.apply(diag, off, y, s, jitter)
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


def logdet(diag: Tensor, off: Tensor, s: Optional[int] = None,
           jitter: float = 0.0) -> Tensor:
    """log|J| via partitioned elimination (no right-hand side)."""
    n, d, _ = diag.shape
    zeros = diag.new_zeros((n, d))
    return mahal_and_logdet(diag, off, zeros, s=s, jitter=jitter)[1]


# ---------------------------------------------------------------------------
# The WIDE route (8 < d < 16) on the card: the wide-layout kernels of
# ops/wide_cuda.py (kernel 16 in the forward, 21 and 22 in the analytic
# backward), the counterpart of the JAX package's wide branches
# (partitioned.py:465-621, 1731-1837).  The chunk interiors are eliminated
# on wide stacks; the C-sized reduced boundary system is assembled in the
# plain layout, and its ladder re-enters the wide route at every chunked
# level (`_mahal_and_logdet_em`, `_solve_inverse_from_cm`), since the
# likelihood's sweep kernel and its backward pair have no instance at these
# sizes.  Stacks stay at the true chunk count (the TPU kernels pad them to
# their lane tile).
# ---------------------------------------------------------------------------


def _is_wide(d: int, backend: str) -> bool:
    """Whether a level at block size ``d`` takes the wide kernels."""
    return 8 < d < 16 and backend == "cuda"


def _to_wide_stack(x: Tensor) -> Tuple[Tensor, Tensor]:
    """`wideblock.to_wide` over a leading stack axis: [m, d, d, C] ->
    (a11 [m, 8, 8, C], st [m, 3e, 8, C])."""
    e = x.shape[1] - 8
    a22 = x[:, 8:, 8:]
    a22 = torch.cat([a22, a22.new_zeros(a22.shape[:2] + (8 - e,)
                                        + a22.shape[3:])], dim=2)
    return (x[:, :8, :8].contiguous(),
            torch.cat([x[:, 8:, :8], x[:, :8, 8:].transpose(1, 2), a22],
                      dim=1))


def _from_wide_stack(a11: Tensor, st: Tensor) -> Tensor:
    """`wideblock.from_wide` over a leading stack axis: (a11 [m, 8, 8, C],
    st [m, 3e, 8, C]) -> [m, d, d, C]."""
    e = st.shape[1] // 3
    top = torch.cat([a11, st[:, e:2 * e].transpose(1, 2)], dim=2)
    bot = torch.cat([st[:, :e], st[:, 2 * e:, :e]], dim=2)
    return torch.cat([top, bot], dim=1)


def _chunk_layout_wide(diag: Tensor, off: Tensor, y: Tensor, s: int):
    """Natural [N, d, d] -> WIDE chunk-major (R11 [s, 8, 8, C], Rst
    [s, 3e, 8, C], O11, Ost, y_cm [s, d, C], C); padding blocks identity /
    zero as in `_chunk_layout`."""
    R_cm, O_cm, y_cm, c = _chunk_layout(diag, off, y, s)
    return (*_to_wide_stack(R_cm), *_to_wide_stack(O_cm), y_cm, c)


def mahal_and_logdet_wide(r11: Tensor, rst: Tensor, o11: Tensor,
                          ost: Tensor, y_cm: Tensor,
                          jitter: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Fused (mahal, logdet) on ALREADY wide-layout chunk-major inputs
    (`_chunk_layout_wide`'s format), through kernel 16 for CUDA tensors
    and its plain twin for CPU tensors.  Forward-only entry (the
    differentiable route is the natural-layout `mahal_and_logdet`), kept
    as the JAX package's public counterpart; the port's routes call
    `_mahal_wide_cm_primal` directly."""
    return _mahal_wide_cm_primal(r11, rst, o11, ost, y_cm, jitter)


def _wide_state(acc11, accst, accy0, w011, w0st, wl, d11, dst, invd, mh,
                ld) -> _SweepState:
    """A wide sweep's final state, converted to the plain layout (C-sized)
    for the reduced boundary system."""
    return _SweepState(None, wb.from_wide(w011, w0st), wl,
                       wb.from_wide(d11, dst), invd,
                       wb.from_wide(acc11, accst), accy0, mh, ld)


def _mahal_wide_cm_primal(r11, rst, o11, ost, y_cm, jitter):
    from .wide_cuda import forward_sweep_wide_cuda

    s = r11.shape[0]
    state = _wide_state(*forward_sweep_wide_cuda(r11, rst, o11, ost, y_cm,
                                                 jitter=jitter))
    o_last = wb.from_wide(o11[s - 1], ost[s - 1])
    w1 = sb.solve_lower(state.dj, state.invd, sb.transpose(o_last))
    r0 = wb.from_wide(r11[0], rst[0])
    red_diag, red_off, red_rhs = _reduced_system(r0[None], y_cm[:1], state,
                                                 w1)
    red_mh, red_ld = _mahal_and_logdet_em(red_diag, red_off, red_rhs,
                                          jitter, "cuda")
    return state.mh + red_mh, 2.0 * state.ld + red_ld


class _MahalWide(torch.autograd.Function):
    """(mahal, logdet) of natural-layout blocks on the wide route, with the
    analytic adjoint of `_MahalCm` in natural layout (the JAX
    ``_mahal_wide`` custom VJP, partitioned.py:555-621).  The residuals
    are the WIDE chunk-major inputs, so the backward reuses the forward's
    relayout; it runs the fused wide solve + selected inversion on them
    (`_solve_inverse_wide_cm`: kernels 21 and 22)."""

    @staticmethod
    def forward(ctx, diag, off, y, s, jitter):
        wide = _chunk_layout_wide(diag, off, y, s)[:5]
        ctx.save_for_backward(*wide)
        ctx.jitter, ctx.n = jitter, diag.shape[0]
        return _mahal_wide_cm_primal(*wide, jitter)

    @staticmethod
    def backward(ctx, gm, gl):
        n = ctx.n
        x, sig_diag, sig_off = _solve_inverse_wide_cm(*ctx.saved_tensors,
                                                      ctx.jitter)
        x, sig_diag, sig_off = x[:n], sig_diag[:n], sig_off[: n - 1]
        xo = x[:, :, None] * x[:, None, :]
        xo_off = x[1:, :, None] * x[:-1, None, :]  # x_{i+1} x_i^T
        g_diag = gl * sig_diag - gm * xo
        g_off = 2.0 * (gl * sig_off - gm * xo_off)
        g_y = 2.0 * gm * x
        return g_diag, g_off, g_y, None, None


def _solve_inverse_wide_cm(r11, rst, o11, ost, y_cm, jitter):
    """Fused (x = J^{-1} y, selected inverse) on WIDE chunk-major inputs:
    one wide collect sweep (kernel 21: hats + pinv) and one wide
    descending pass for both upward walks (kernel 22).  Returns padded
    natural-order (x [C*s, d], sig_diag [C*s, d, d], sig_off [C*s, d, d]
    with row i = Sigma_{i+1, i}) -- the contract of
    `_solve_inverse_from_cm`."""
    from .wide_cuda import (backward_solve_takahashi_wide_cuda,
                            forward_sweep_solveinv_wide_cuda)

    s, c = r11.shape[0], r11.shape[-1]
    d = 8 + rst.shape[1] // 3
    outs = forward_sweep_solveinv_wide_cuda(r11, rst, o11, ost, y_cm,
                                            jitter=jitter)
    d11, dst, invd = outs[6:9]
    # the right coupling W1 = D^{-1} O_{s-1}^T and its hat, in wide form;
    # the inverse pivots split as the wide factor's two panels
    dw = (d11, dst, invd[:8, None], invd[8:, None])
    w1_w = wb.wsolve_lower(*dw, *wb.wtranspose(o11[s - 1], ost[s - 1]))
    hw1_w = wb.wsolve_lower_t(*dw, *w1_w)
    state = _wide_state(*outs[:11])
    r0 = wb.from_wide(r11[0], rst[0])
    red_diag, red_off, red_rhs = _reduced_system(
        r0[None], y_cm[:1], state, wb.from_wide(*w1_w))
    xb, p00, p10 = _solve_inverse_em(red_diag, red_off, red_rhs, jitter,
                                     "cuda")
    p11 = sb.shift_up(p00)
    p01 = sb.transpose(p10)
    xb_next = sb.shift_up(xb)
    (x_rows, dg, of, u0f,
     u1f) = backward_solve_takahashi_wide_cuda(
        *outs[11:], *[t.contiguous() for t in (*hw1_w, xb, xb_next)],
        *[wb.to_wide(p.contiguous()) for p in (p00, p01, p10, p11)])
    diag_int = _from_wide_stack(*dg)
    off_rows = _from_wide_stack(*of)
    off_edge_left = -(sb.matmul(wb.from_wide(*u0f), p00)
                      + sb.matmul(wb.from_wide(*u1f), p10))
    diag_cm = torch.cat([p00[None], diag_int], dim=0)
    off_cm = torch.cat([off_edge_left[None], off_rows], dim=0)
    sig_diag = diag_cm.permute(3, 0, 1, 2).reshape(-1, d, d)
    sig_off = off_cm.permute(3, 0, 1, 2).reshape(-1, d, d)
    x_cm = torch.cat([xb[None], x_rows], dim=0)
    return x_cm.permute(2, 0, 1).reshape(c * s, d), sig_diag, sig_off


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


def _back_substitute(state, w1, hat_cs, hat_w0s, hat_ws, xb, c,
                     backend="torch"):
    """Chain back-substitution shared by the solve entries: the hat
    factors + the reduced boundary solution xb [d, C] -> the padded
    natural-order solution [C*s, d].  ``backend="cuda"`` runs the
    descending walk as the back-substitution kernel, which reads the
    whole stack; the plain walk recomputes the last row's hats from the
    live final state instead (the same values)."""
    s = hat_cs.shape[0] + 1
    xb_next = sb.shift_up(xb)  # next chunk's boundary (0 for last)
    hat_w1 = sb.solve_lower_t(state.dj, state.invd, w1)
    if backend == "cuda":
        from .sweep_cuda import backward_substitute_cuda

        interior = backward_substitute_cuda(
            hat_cs, hat_w0s, hat_ws,
            *[a.contiguous() for a in (hat_w1, xb, xb_next)])
    else:
        # last interior row j = s-1 (carries the W1 term, no x_{j+1})
        hat_w0_l = sb.solve_lower_t(state.dj, state.invd, state.w0)
        hat_w_l = sb.solve_lower_t_vec(state.dj, state.invd, state.w)
        x = (hat_w_l - sb.matvec(hat_w0_l, xb)
             - sb.matvec(hat_w1, xb_next))
        rows = [x]
        for t in range(s - 3, -1, -1):
            x = (hat_ws[t] - sb.matvec(hat_w0s[t], xb)
                 - sb.matvec(hat_cs[t], x))
            rows.append(x)
        interior = torch.stack(rows[::-1], dim=0)  # [s-1, d, C]
    x_cm = torch.cat([xb[None], interior], dim=0)
    d = xb.shape[0]
    return x_cm.permute(2, 0, 1).reshape(c * s, d)


def _sigma_bb_ut(p00, p01, p10, p11, u0, u1):
    """(Sigma_BB U^T) rows: a0 = row b_c, a1 = row b_{c+1}."""
    mm = sb.matmul
    return (mm(p00, u0, tb=True) + mm(p01, u1, tb=True),
            mm(p10, u0, tb=True) + mm(p11, u1, tb=True))


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
    # seed at j = s-1: phi / u0 are the stacks' last rows
    phi, u0, u1 = pinv_s[-1], hw0_s[-1], hat_w1
    a0, a1 = _sigma_bb_ut(p00, p01, p10, p11, u0, u1)
    diags = [phi + mm(u0, a0) + mm(u1, a1)]
    offs = [-a1]
    for t in range(hc_s.shape[0] - 2, -1, -1):
        hc_j = hc_s[t]
        phi_off = -mm(phi, hc_j, tb=True)
        phi_j = pinv_s[t] + mm(mm(hc_j, phi), hc_j, tb=True)
        u0_j = hw0_s[t] - mm(hc_j, u0)
        u1_j = -mm(hc_j, u1)
        a0, a1 = _sigma_bb_ut(p00, p01, p10, p11, u0_j, u1_j)
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
    x_nat, sd_nat, so_nat = _solve_inverse_from_cm(R_cm, O_cm, y_cm, jitter,
                                                   backend)
    return (sb.vec_to_em(x_nat[:n]), sb.to_em(sd_nat[:n]),
            sb.to_em(so_nat[:n]))


def _solve_inverse_from_cm(R_cm, O_cm, y_cm, jitter, backend="torch"):
    """Fused (x = J^{-1} y, selected inverse of J) on chunk-major inputs
    from ONE forward collect sweep; returns padded natural-order
    (x [C*s, d], sig_diag [C*s, d, d], sig_off [C*s, d, d] with row i =
    Sigma_{i+1, i}).  ``backend="cuda"`` runs the sweep as the
    solve+inverse collect kernel and both upward walks as one descending
    kernel, on the wide layout at 8 < d < 16 (`_solve_inverse_wide_cm`:
    kernels 21 and 22, as the JAX ``_solve_wide_bwd`` and
    ``_mahal_wide_bwd`` do); "torch" runs the plain sweep and walks."""
    s, d = R_cm.shape[0], R_cm.shape[1]
    c = R_cm.shape[-1]
    if _is_wide(d, backend):
        return _solve_inverse_wide_cm(*_to_wide_stack(R_cm),
                                      *_to_wide_stack(O_cm), y_cm, jitter)
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


# ---------------------------------------------------------------------------
# The solve: J^{-1} y and log|J| from one forward sweep that streams the hat
# factors (`_collect_solve`) and one descending back-substitution.  On the
# card both passes are kernels (the collect sweep and the
# back-substitution of ops/sweep_cuda.py, runtime-d instances at
# 8 < d < 16), at every ladder level.
# ---------------------------------------------------------------------------


def _hat_sweep(R_cm, O_cm, y_cm, jitter, backend, collect):
    """The forward sweep streaming the hat factors: (final state, W1,
    (hat_cs, hat_w0s, hat_ws[, ld_rows])) for ``collect`` "solve" (or
    "solve_ldrows", which adds the per-row pivot log-dets).  "cuda" runs
    the collect kernel, which streams the log-dets either way."""
    if backend == "cuda":
        from .sweep_cuda import forward_sweep_collect_cuda

        s = R_cm.shape[0]
        (acc00, accy0, w0l, wl, dl, invdl, mh, ld, hc_s, hw0_s, hw_s,
         ld_int) = forward_sweep_collect_cuda(R_cm, O_cm, y_cm,
                                              jitter=jitter)
        state = _SweepState(None, w0l, wl, dl, invdl, acc00, accy0, mh, ld)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(O_cm[s - 1]))
        stacks = (hc_s, hw0_s, hw_s)
        if collect == "solve_ldrows":
            stacks += (ld_int,)
        return state, w1, stacks
    return _forward_sweep(R_cm, O_cm, y_cm, jitter, collect)


def _solve_em(diag_em, off_em, y_em, jitter, backend="torch"):
    """(J^{-1} y element-major [d, n], log|J|) on element-major inputs
    (off_em valid to n-2): the reduced boundary ladder's native format."""
    d, _, n = diag_em.shape
    s = default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(sb.from_em(diag_em), sb.from_em(off_em)[: n - 1],
                           jitter=jitter)
        x = cr.solve(dec, sb.vec_from_em(y_em))
        return sb.vec_to_em(x), cr.logdet(dec)
    R_cm, O_cm, y_cm, _ = _chunk_layout_em(diag_em, off_em, y_em, s)
    x_nat, ld = _solve_from_cm(R_cm, O_cm, y_cm, jitter, backend)
    return sb.vec_to_em(x_nat[:n]), ld


def _solve_impl(diag, off, y, s, jitter, backend="torch"):
    """(J^{-1} y, log|J|) on natural-order inputs: the log-det falls out of
    the same forward sweep."""
    n = y.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(diag, off, jitter=jitter)
        return cr.solve(dec, y), cr.logdet(dec)
    R_cm, O_cm, y_cm, _ = _chunk_layout(diag, off, y, s)
    x_nat, ld = _solve_from_cm(R_cm, O_cm, y_cm, jitter, backend)
    return x_nat[:n], ld


def _solve_from_cm(R_cm, O_cm, y_cm, jitter, backend="torch"):
    """Solve + logdet on chunk-major inputs; returns the full padded
    natural-order solution [C*s, d] and log|J|.  The forward sweep
    stores the hat factors, so the back-substitution is pure
    multiply-add: x_j = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}."""
    c = R_cm.shape[-1]
    state, w1, (hat_cs, hat_w0s, hat_ws) = _hat_sweep(
        R_cm, O_cm, y_cm, jitter, backend, "solve")
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    x_b_em, red_ld = _solve_em(red_diag, red_off, red_rhs, jitter, backend)
    x_nat = _back_substitute(state, w1, hat_cs, hat_w0s, hat_ws, x_b_em, c,
                             backend)
    return x_nat, 2.0 * state.ld + red_ld


def _solve_adjoint(R_cm, O_cm, x_nat, gx, w_rows, jitter, backend):
    """The analytic adjoint shared by the solve entries: with u = J^{-1} gx
    and Sigma = J^{-1} (selected blocks) from ONE fused solve + selected
    inversion,

      g_diag_i = w_i Sigma_ii - u_i x_i^T
      g_off_i  = 2 w_i Sigma_{i+1,i} - u_{i+1} x_i^T - x_{i+1} u_i^T
      g_y      = u

    where ``w_rows`` is the log-det cotangent per natural row ([C*s, 1, 1],
    or a scalar).  Returns chunk-major (g_R, g_O, g_y)."""
    s, d, _, c = R_cm.shape
    gx_cm = gx.reshape(c, s, d).permute(1, 2, 0).contiguous()
    u_nat, sig_diag, sig_off = _solve_inverse_from_cm(R_cm, O_cm, gx_cm,
                                                      jitter, backend)
    zrow = x_nat.new_zeros((1, d))
    x_next = torch.cat([x_nat[1:], zrow], dim=0)
    u_next = torch.cat([u_nat[1:], zrow], dim=0)
    g_diag = w_rows * sig_diag - u_nat[:, :, None] * x_nat[:, None, :]
    g_off = (2.0 * w_rows * sig_off
             - u_next[:, :, None] * x_nat[:, None, :]
             - x_next[:, :, None] * u_nat[:, None, :])
    g_R = g_diag.reshape(c, s, d, d).permute(1, 2, 3, 0)
    g_O = g_off.reshape(c, s, d, d).permute(1, 2, 3, 0)
    g_y = u_nat.reshape(c, s, d).permute(1, 2, 0)
    return g_R, g_O, g_y


class _SolveCm(torch.autograd.Function):
    """(x, log|J|) = (J^{-1} y, log|J|) with the analytic adjoint of the
    JAX ``_solve_cm`` custom VJP (`_solve_cm_bwd`, `_solve_adjoint` with
    the scalar log-det cotangent); the residuals are the inputs and x."""

    @staticmethod
    def forward(ctx, R_cm, O_cm, y_cm, jitter, backend):
        x_nat, ld = _solve_from_cm(R_cm, O_cm, y_cm, jitter, backend)
        ctx.save_for_backward(R_cm, O_cm, x_nat)
        ctx.jitter, ctx.backend = jitter, backend
        return x_nat, ld

    @staticmethod
    def backward(ctx, gx, gl):
        R_cm, O_cm, x_nat = ctx.saved_tensors
        return _solve_adjoint(R_cm, O_cm, x_nat, gx, gl, ctx.jitter,
                              ctx.backend) + (None, None)


def solve_cm(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor, jitter: float = 0.0,
             backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """(J^{-1} y [C*s, d] padded natural order, log|J|) on chunk-major
    inputs (see `mahal_and_logdet_cm`).  ``backend``: "torch", "cuda"
    (the collect and back-substitution kernels at every ladder level) or
    "auto" (cuda for CUDA tensors; the JAX counterpart defaults to its
    plain backend).  Differentiable on every backend through the
    analytic adjoint (`_SolveCm`)."""
    return _SolveCm.apply(R_cm, O_cm, y_cm, jitter,
                          resolve_backend(backend, R_cm))


def solve_and_logdet(diag: Tensor, off: Tensor, y: Tensor,
                     s: Optional[int] = None, jitter: float = 0.0,
                     backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """(J^{-1} y, log|J|) in one forward sweep + back-substitution (the
    JAX package's headline benchmark op).  diag [N, d, d], off
    [N-1, d, d], y [N, d]."""
    n = y.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(diag, off, jitter=jitter)
        return cr.solve(dec, y), cr.logdet(dec)
    R_cm, O_cm, y_cm, _ = _chunk_layout(diag, off, y, s)
    x_pad, ld = solve_cm(R_cm, O_cm, y_cm, jitter, backend)
    return x_pad[:n], ld


def solve(diag: Tensor, off: Tensor, y: Tensor, s: Optional[int] = None,
          jitter: float = 0.0, backend: str = "auto") -> Tensor:
    """J^{-1} y: recursive partitioned elimination + chain
    back-substitution."""
    return solve_and_logdet(diag, off, y, s=s, jitter=jitter,
                            backend=backend)[0]


# ---------------------------------------------------------------------------
# Per-row pivot log-determinants.  Every pivot of the partitioned
# elimination belongs to exactly one block row, so log|J| decomposes as a
# per-row vector with sum == logdet.  For a system that is block-diagonal
# over contiguous row segments, segment sums of the rows are each
# segment's exact log-determinant (`logdet_per_segment`); for a coupled
# system only the total is meaningful.
# ---------------------------------------------------------------------------


def _ld_rows_seq(diag, off, jitter):
    """Terminal per-row sweep: sequential block Cholesky over natural
    [n, d, d] rows; ld_rows [n] with ld_rows[i] = 2 sum log diag L_i."""
    n, d, _ = diag.shape
    off_prev = torch.cat([diag.new_zeros((1, d, d)), off[: n - 1]], dim=0)
    l_prev, invd_prev = sb.eye_em(d, diag), diag.new_ones((d, 1))
    lds = []
    for i in range(n):
        w = sb.solve_lower(l_prev, invd_prev,
                           sb.transpose(sb.to_em(off_prev[i][None])))
        p = sb.to_em(diag[i][None]) - sb.matmul(w, w, ta=True)
        l_prev, invd_prev = sb.cholesky(p, jitter=jitter)
        lds.append(2.0 * sb.chol_log_diag_rows(l_prev)[0])
    return torch.stack(lds)


def _ld_rows_cm_impl(R_cm, O_cm, jitter, backend="torch"):
    """Chunk-major per-row pivot log-dets [s, C]: rows j >= 1 from the
    interior elimination sweep (the forward-sweep kernel's per-row output
    on "cuda"), row j = 0 of chunk c from the reduced boundary system's
    own recursion (reduced row c IS natural row c*s)."""
    s, d, _, c = R_cm.shape
    zy = R_cm.new_zeros((s, d, c))
    if backend == "cuda":
        from .sweep_cuda import forward_sweep_cuda

        (acc00, accy0, w0l, wl, dl, invdl, _, _,
         ld_int) = forward_sweep_cuda(R_cm, O_cm, zy, jitter=jitter)
        zero = R_cm.new_zeros(())
        state = _SweepState(None, w0l, wl, dl, invdl, acc00, accy0, zero,
                            zero)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(O_cm[s - 1]))
    else:
        state, w1, ld_int = _forward_sweep(R_cm, O_cm, zy, jitter,
                                           collect="ldrows")
    red_diag, red_off, _ = _reduced_system(R_cm, zy, state, w1)
    red_rows = _logdet_rows_impl(sb.from_em(red_diag),
                                 sb.from_em(red_off)[: c - 1], None, jitter,
                                 backend)
    return torch.cat([red_rows[None], ld_int], dim=0)


def _logdet_rows_impl(diag, off, s, jitter, backend="torch"):
    n = diag.shape[0]
    s_ = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s_):
        return _ld_rows_seq(diag, off, jitter)
    R_cm, O_cm, _, c = _chunk_layout(diag, off, None, s_)
    rows_cm = _ld_rows_cm_impl(R_cm, O_cm, jitter, backend)
    return rows_cm.transpose(0, 1).reshape(c * s_)[:n]


def logdet_rows(diag: Tensor, off: Tensor, s: Optional[int] = None,
                jitter: float = 0.0) -> Tensor:
    """Per-row pivot log-determinant partials [n] (sum == logdet), on the
    kernels for CUDA tensors.  Differentiable by autograd through the
    plain sweeps; for the analytic adjoint use `logdet_per_segment` /
    `logdet_rows_cm`."""
    return _logdet_rows_impl(diag, off, s, jitter,
                             resolve_backend("auto", diag))


def _rows_cotangent_guard(w, O_cm, c, s):
    """0.0 when the per-row cotangent ``w`` (natural order, [c*s]) is
    constant across every nonzero coupling of J, NaN otherwise: the
    validity domain of the per-row adjoints (segment-sum consumers), so a
    misuse poisons the gradient loudly instead of silently."""
    onorm = torch.sum(torch.abs(O_cm), dim=(1, 2)).transpose(0, 1).reshape(
        c * s)
    coupled = onorm[: c * s - 1] > 0
    bad = torch.any(coupled & (w[:-1] != w[1:]))
    return torch.where(bad, w.new_full((), math.nan), w.new_zeros(()))


def _row_weights(w_cm, O_cm):
    """Per-row log-det cotangent [s, C] -> natural order [C*s, 1, 1], with
    the validity guard added."""
    s, c = w_cm.shape
    w = w_cm.transpose(0, 1).reshape(c * s)
    w = w + _rows_cotangent_guard(w, O_cm, c, s)
    return w[:, None, None]


class _LdRowsCm(torch.autograd.Function):
    """Per-row pivot log-dets [s, C] with the segment-wise analytic adjoint
    of the JAX ``_ld_rows_cm`` custom VJP (`_ld_rows_cm_bwd`): for a
    cotangent w constant within each block-diagonal segment of J,
      d/dR_i = w_i Sigma_ii,   d/dO_i = 2 w_i Sigma_{i+1,i}
    from one selected inversion.  A cotangent outside that domain gives
    NaN (`_rows_cotangent_guard`)."""

    @staticmethod
    def forward(ctx, R_cm, O_cm, jitter, backend):
        ctx.save_for_backward(R_cm, O_cm)
        ctx.jitter, ctx.backend = jitter, backend
        return _ld_rows_cm_impl(R_cm, O_cm, jitter, backend)

    @staticmethod
    def backward(ctx, w_cm):
        R_cm, O_cm = ctx.saved_tensors
        s, d, _, c = R_cm.shape
        sig_diag, sig_off = _inverse_from_cm(R_cm, O_cm, ctx.jitter,
                                             ctx.backend)
        w = _row_weights(w_cm, O_cm)
        g_R = (w * sig_diag).reshape(c, s, d, d).permute(1, 2, 3, 0)
        g_O = (2.0 * w * sig_off).reshape(c, s, d, d).permute(1, 2, 3, 0)
        return g_R, g_O, None, None


def logdet_rows_cm(R_cm: Tensor, O_cm: Tensor, jitter: float = 0.0,
                   backend: str = "auto") -> Tensor:
    """Per-row pivot log-dets [s, C] on chunk-major inputs.  ``backend``
    selects the engine of both the forward sweep and the adjoint's
    selected inversion.  Gradient validity: see `_LdRowsCm`."""
    return _LdRowsCm.apply(R_cm, O_cm, jitter,
                           resolve_backend(backend, R_cm))


def logdet_per_segment(diag: Tensor, off: Tensor, seg_ids: Tensor,
                       num_segments: int, s: Optional[int] = None,
                       jitter: float = 0.0,
                       backend: str = "auto") -> Tensor:
    """Per-segment log-determinants [num_segments] of a block-tridiagonal
    system that is block-diagonal over contiguous row segments
    (``seg_ids`` sorted, off blocks crossing segment boundaries zero), in
    one streaming elimination."""
    n = diag.shape[0]
    s_ = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s_):
        rows = _ld_rows_seq(diag, off, jitter)
    else:
        R_cm, O_cm, _, c = _chunk_layout(diag, off, None, s_)
        rows_cm = _LdRowsCm.apply(R_cm, O_cm, jitter,
                                  resolve_backend(backend, R_cm))
        rows = rows_cm.transpose(0, 1).reshape(c * s_)[:n]
    return rows.new_zeros((num_segments,)).index_add(0, seg_ids.long(),
                                                     rows)


def _solve_ldr_impl(diag, off, y, s, jitter, backend="torch"):
    """Natural-layout recursion: (J^{-1} y [n, d], per-row pivot log-dets
    [n])."""
    n = y.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(diag, off, jitter=jitter)
        return cr.solve(dec, y), _ld_rows_seq(diag, off, jitter)
    R_cm, O_cm, y_cm, c = _chunk_layout(diag, off, y, s)
    x_nat, rows_cm = _solve_ldr_from_cm(R_cm, O_cm, y_cm, jitter, backend)
    rows = rows_cm.transpose(0, 1).reshape(c * s)
    return x_nat[:n], rows[:n]


def _solve_ldr_from_cm(R_cm, O_cm, y_cm, jitter, backend="torch"):
    """Chunk-major fused solve + per-row log-dets from one collect sweep:
    the padded natural-order solution [C*s, d] and rows [s, C] (row
    c*s + j at [j, c])."""
    c = R_cm.shape[-1]
    state, w1, (hat_cs, hat_w0s, hat_ws, ld_int) = _hat_sweep(
        R_cm, O_cm, y_cm, jitter, backend, "solve_ldrows")
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    x_b, red_rows = _solve_ldr_impl(
        sb.from_em(red_diag), sb.from_em(red_off)[: c - 1],
        sb.vec_from_em(red_rhs), None, jitter, backend)
    x_nat = _back_substitute(state, w1, hat_cs, hat_w0s, hat_ws,
                             sb.vec_to_em(x_b), c, backend)
    return x_nat, torch.cat([red_rows[None], ld_int], dim=0)


class _SolveLdrCm(torch.autograd.Function):
    """(x, rows) = (J^{-1} y, per-row pivot log-dets) with the JAX
    ``_solve_ldr_cm`` custom VJP's adjoint (`_solve_ldr_cm_bwd`): one
    fused solve + selected inversion shared by both parts; the per-row
    cotangent must be segment-constant (see `_LdRowsCm`)."""

    @staticmethod
    def forward(ctx, R_cm, O_cm, y_cm, jitter, backend):
        x_nat, rows_cm = _solve_ldr_from_cm(R_cm, O_cm, y_cm, jitter,
                                            backend)
        ctx.save_for_backward(R_cm, O_cm, x_nat)
        ctx.jitter, ctx.backend = jitter, backend
        return x_nat, rows_cm

    @staticmethod
    def backward(ctx, gx, w_cm):
        R_cm, O_cm, x_nat = ctx.saved_tensors
        return _solve_adjoint(R_cm, O_cm, x_nat, gx,
                              _row_weights(w_cm, O_cm), ctx.jitter,
                              ctx.backend) + (None, None)


def solve_and_ld_rows_cm(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                         jitter: float = 0.0,
                         backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """(J^{-1} y [C*s, d] padded natural order, per-row pivot log-dets
    [s, C]) from ONE forward sweep + one back-substitution (separate
    `solve_cm` + `logdet_rows_cm` calls pay two passes over J).
    Differentiable with a shared analytic adjoint (`_SolveLdrCm`)."""
    return _SolveLdrCm.apply(R_cm, O_cm, y_cm, jitter,
                             resolve_backend(backend, R_cm))


# ---------------------------------------------------------------------------
# Selected inversion: the diagonal and lag-1 off-diagonal blocks of J^{-1}.
# With J = [[A, Bc], [Bc^T, S]] (chunk interiors / boundaries) and Sigma_BB
# the selected inverse of the reduced boundary system:
#
#   Sigma_II = A^{-1} + U Sigma_BB U^T,    U = A^{-1} Bc = L_A^{-T} W,
#   Sigma_IB = -U Sigma_BB,
#
# with W = [W0, W1] the sweep's coupling solves.  A^{-1}'s tridiagonal
# blocks come from the Takahashi recursion along each chain (a descending
# walk), U by back-substitution of W.  One forward sweep and one descending
# walk per ladder level; on the card both are kernels (the raw-factor sweep
# and the Takahashi recursion of ops/sweep_cuda.py, runtime-d instances at
# 8 < d < 16).
# ---------------------------------------------------------------------------


def _inverse_impl(diag, off, s, jitter, backend="torch"):
    """Recursive partitioned selected inversion on natural-order blocks:
    (Sigma_ii [n, d, d], Sigma_{i+1,i} [n-1, d, d])."""
    n = diag.shape[0]
    s = s or default_chunk_len(n)
    if n < max(_TERMINAL, 2 * s):
        dec = cr.decompose(diag, off, jitter=jitter)
        return cr.inverse_blocks(dec)
    R_cm, O_cm, _, _ = _chunk_layout(diag, off, None, s)
    diag_nat, off_nat = _inverse_from_cm(R_cm, O_cm, jitter, backend)
    return diag_nat[:n], off_nat[: n - 1]


def _boundary_blocks(red_diag, red_off, c, jitter, backend):
    """Sigma_BB of the reduced system as the four per-chunk blocks
    (p00, p01, p10, p11) [d, d, C]: Sigma at (b_c, b_c), (b_c, b_{c+1}),
    (b_{c+1}, b_c) and (b_{c+1}, b_{c+1}); zero past the last chunk."""
    d = red_diag.shape[0]
    bb_diag, bb_off = _inverse_impl(sb.from_em(red_diag),
                                    sb.from_em(red_off)[: c - 1], None,
                                    jitter, backend)
    p00 = sb.to_em(bb_diag)
    p10 = torch.cat([sb.to_em(bb_off), red_diag.new_zeros((d, d, 1))],
                    dim=-1)
    return p00, sb.transpose(p10), p10, sb.shift_up(p00)


def _inverse_from_cm(R_cm, O_cm, jitter, backend="torch"):
    """Selected inverse on chunk-major inputs; returns padded
    natural-order (diag [C*s, d, d], off [C*s, d, d] with row i =
    Sigma_{i+1, i}).  ``backend="cuda"`` with s >= 3 runs the raw-factor
    sweep and the Takahashi recursion as kernels (the counterpart of the
    JAX ``_inverse_from_cm_pallas``); the reduced boundary system recurses
    on the same backend, and the step s-1 seeds of the recursion and the
    per-chunk edge rows are tensor glue on either route."""
    mm = sb.matmul
    s, d, _, c = R_cm.shape
    kernels = backend == "cuda" and s >= 3
    if kernels:
        from .sweep_cuda import (forward_sweep_inverse_cuda,
                                 takahashi_backward_cuda)

        (acc00, w0l, dl, invdl, *stacks) = forward_sweep_inverse_cuda(
            R_cm, O_cm, jitter=jitter)
    else:
        state, _, stacks = _forward_sweep(
            R_cm, O_cm, R_cm.new_zeros((s, d, c)), jitter, collect="inverse")
        acc00, w0l, dl, invdl = state.acc00, state.w0, state.dj, state.invd
    w1 = sb.solve_lower(dl, invdl, sb.transpose(O_cm[s - 1]))
    red_diag = R_cm[0] - acc00 - sb.shift_down(mm(w1, w1, ta=True))
    red_off = -mm(w1, w0l, ta=True)  # J[b_{c+1}, b_c]
    p00, p01, p10, p11 = _boundary_blocks(red_diag, red_off, c, jitter,
                                          backend)

    # seeds at j = s-1, from the last step's factors
    di_last = sb.tri_lower_inverse(dl, invdl)
    phi = mm(di_last, di_last, ta=True)
    u0 = sb.solve_lower_t(dl, invdl, w0l)
    u1 = sb.solve_lower_t(dl, invdl, w1)
    a0, a1 = _sigma_bb_ut(p00, p01, p10, p11, u0, u1)
    diag_last = phi + mm(u0, a0) + mm(u1, a1)
    # right-edge off block: Sigma[(c+1)s, (c+1)s-1] = -(P10 u0^T + P11 u1^T)
    off_edge_right = -(mm(p10, u0, tb=True) + mm(p11, u1, tb=True))
    if kernels:
        diag_mid, off_mid, u0, u1 = takahashi_backward_cuda(
            *stacks, *[a.contiguous() for a in (p00, p01, p10, p11, phi, u0,
                                                u1, a0, a1)])
    else:
        ds, invds, cs_, w0s = stacks
        diags, offs = [], []
        for t in range(s - 3, -1, -1):
            d_j, invd_j, c_j = ds[t], invds[t], cs_[t]
            di = sb.tri_lower_inverse(d_j, invd_j)
            cd = mm(c_j, di)
            phi_off = -mm(phi, cd)  # Phi_{j+1, j}
            phi_j = mm(di, di, ta=True) + mm(mm(cd, phi, ta=True), cd)
            u0_j = sb.solve_lower_t(d_j, invd_j,
                                    w0s[t] - mm(c_j, u0, ta=True))
            u1_j = -sb.solve_lower_t(d_j, invd_j, mm(c_j, u1, ta=True))
            a0, a1 = _sigma_bb_ut(p00, p01, p10, p11, u0_j, u1_j)
            diags.append(phi_j + mm(u0_j, a0) + mm(u1_j, a1))
            # off pair (j, j+1): Sigma[cs+j+1, cs+j]
            offs.append(phi_off + mm(u0, a0) + mm(u1, a1))
            phi, u0, u1 = phi_j, u0_j, u1_j
        diag_mid = torch.stack(diags[::-1]) if diags else dl.new_zeros(
            (0, d, d, c))
        off_mid = torch.stack(offs[::-1]) if offs else diag_mid
    # left-edge off block: Sigma[cs+1, cs] = -(u0_1 P00 + u1_1 P10)
    off_edge_left = -(mm(u0, p00) + mm(u1, p10))
    diag_cm = torch.cat([p00[None], diag_mid, diag_last[None]], dim=0)
    off_cm = torch.cat([off_edge_left[None], off_mid, off_edge_right[None]],
                       dim=0)
    return (diag_cm.permute(3, 0, 1, 2).reshape(-1, d, d),
            off_cm.permute(3, 0, 1, 2).reshape(-1, d, d))


def inverse_blocks_cm(R_cm: Tensor, O_cm: Tensor, jitter: float = 0.0,
                      backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Selected inverse on chunk-major inputs; padded natural order
    ([C*s, d, d], [C*s, d, d]; the caller slices to [:n] / [:n-1]).
    ``backend``: "torch", "cuda" (the raw-factor sweep and Takahashi
    kernels at every ladder level) or "auto" (cuda for CUDA tensors)."""
    return _inverse_from_cm(R_cm, O_cm, jitter,
                            resolve_backend(backend, R_cm))


def inverse_blocks(diag: Tensor, off: Tensor, s: Optional[int] = None,
                   jitter: float = 0.0,
                   backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Diagonal and lower off-diagonal blocks of J^{-1} (selected
    inversion) via recursive partitioned elimination: (Sigma_ii
    [N, d, d], Sigma_{i+1,i} [N-1, d, d]).  Matches cr.inverse_blocks."""
    return _inverse_impl(diag, off, s, jitter,
                         resolve_backend(backend, diag))
