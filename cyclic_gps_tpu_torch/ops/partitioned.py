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
``"cuda"`` runs the hand-written forward-sweep kernel
(ops/sweep_cuda.py); ``"auto"`` picks ``"cuda"`` for CUDA tensors.
Every sweep of the reduced-system ladder dispatches the same way; only
the terminal cyclic reduction stays plain tensor code.
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


def _collect_ldrows(state: _SweepState):
    """Per-step per-chunk pivot log-determinants 2 log|D_j| ([C] per
    step) -- the per-row decomposition of the sweep's logdet."""
    return 2.0 * sb.chol_log_diag_rows(state.dj)


_COLLECTORS = {"ldrows": _collect_ldrows}


def _forward_sweep(R_cm, O_cm, y_cm, jitter, collect):
    """Eliminate all chunk interiors (j = 1 .. s-1).

    ``collect`` is None (fused mahal/logdet: nothing stored) or
    "ldrows" (per-step pivot log-dets).  Returns (final state, W1,
    stacked [s-1, C] | None).
    """
    s = R_cm.shape[0]
    collector = _COLLECTORS[collect] if collect else None
    state = _step(None, R_cm[1], O_cm[1], y_cm[1], O_cm[0], jitter)
    outs = [collector(state)] if collector else None
    for j in range(2, s):
        state = _step(state, R_cm[j], O_cm[j], y_cm[j], None, jitter)
        if collector:
            outs.append(collector(state))
    stacked = torch.stack(outs, dim=0) if collector else None
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


def mahal_and_logdet_cm(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                        jitter: float = 0.0,
                        backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Fused (y^T J^{-1} y, log|J|) on ALREADY chunk-major inputs
    (R_cm/O_cm [s, d, d, C], y_cm [s, d, C], trailing-zero O invariant,
    identity/zero padding for any tail).

    ``backend``: "torch" (plain sweep), "cuda" (the forward-sweep kernel,
    for the top level and every sweep of the reduced ladder) or "auto"
    (cuda for CUDA tensors).  The JAX counterpart defaults to its plain
    backend; here "auto" is the default so that a CUDA caller never runs
    the plain sweep without asking for it."""
    backend = resolve_backend(backend, R_cm)
    state, w1 = _forward_state(R_cm, O_cm, y_cm, jitter, backend)
    red_diag, red_off, red_rhs = _reduced_system(R_cm, y_cm, state, w1)
    red_mh, red_ld = _mahal_and_logdet_em(red_diag, red_off, red_rhs,
                                          jitter, backend)
    return state.mh + red_mh, 2.0 * state.ld + red_ld
