"""LEG gap emission as hand-written CUDA kernels, with plain twins.

Counterpart of ``cyclic_gps_tpu/ops/expm_pallas.py``.  The wrappers
launch ``csrc/gap_emission.cu`` and ``csrc/gap_adjoint.cu``:

* `transition_and_noise_cuda` replaces expm_pallas.py:297
  transition_and_noise_pallas;
* `k_system_cuda` replaces expm_pallas.py:530 k_system_pallas;
* `gap_mahal_sweep_cuda` replaces expm_pallas.py:769
  gap_mahal_sweep_pallas;
* `k_system_adjoint_cuda` replaces expm_pallas.py:1046
  k_system_adjoint_pallas, the analytic adjoint of the K-system emission.

`transition_and_noise_diff` is the differentiable (e, Q) kernel: its
backward replays `tn_replay_structured` (the kernel's structured Pade-7
written as plain differentiable tensor code) by autograd, the
counterpart of the JAX package's ``leg._tn_pallas_diff``.  The K-system
kernel's backward is `k_system_adjoint_cuda`, wired up by
``models/leg.py``.  Every raw wrapper refuses inputs that require grad
under grad mode (`_build.check_no_grad`): its outputs carry no
``grad_fn``.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
(``*_plain``, written with tensor ops) for CPU tensors.  The twins port
the TPU kernels' math: the structured Pade-7 of the Van Loan augmented
matrix (`_pade7_vanloan`, with the unpivoted `_lu_solve_k`), the hybrid
(e, Q) construction with augmented-norm scaling and per-lane squaring
(`_tn_math`), the push-through Q1 terms (`_gap_row_terms`), and, for the
fused sweep, the elimination cell of ops/sweep_cuda.py (the TPU
``_fused_elim_cell`` is the forward-sweep step on blocks built in place).

Unlike the TPU kernels, the CUDA kernels take the true chunk count C: no
lane-tile padding goes in or comes out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import smallblock as sb
from .sweep_cuda import _chol, forward_sweep_plain

Tensor = torch.Tensor

# degree-7 diagonal Pade coefficients of exp
_PADE7 = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0,
          56.0, 1.0)
# single-precision Pade-7 accuracy radius theta_7 (Al-Mohy & Higham 2009)
_THETA7 = 3.92
_MAXSQ = 40  # cap on the per-lane squaring count
# Van Loan squaring rounds a cancellation-regime gap can need: such a gap
# has dt ||G/2||_inf < 1 and the augmented norm is at most (2 + r) ||G/2||,
# so it needs at most ceil(log2((2 + r) / theta_7)) rounds -- 8 for every
# r up to ~1000 (expm_pallas.py:360-392, :886-888)
_NSQ_VL = 8
_ADJOINT_GAPS = 128  # gaps per thread block of the adjoint (K5_GAPS)


def _lu_solve_k(a: Tensor, b: Tensor) -> Tensor:
    """A X = B by unpivoted Gaussian elimination, a [d, d, C], b [d, e, C]
    (the Pade denominator: well-conditioned by construction).  Multiplies
    by the pivot reciprocals, as the kernel does."""
    d = a.shape[0]
    m = [a[i] for i in range(d)]  # rows [d, C]
    rhs = [b[i] for i in range(d)]  # rows [e, C]
    pinvs = []
    for j in range(d):
        piv_inv = 1.0 / m[j][j]
        pinvs.append(piv_inv)
        for i in range(j + 1, d):
            f = m[i][j] * piv_inv
            m[i] = m[i] - f[None, :] * m[j]
            rhs[i] = rhs[i] - f[None, :] * rhs[j]
    x = [None] * d
    for i in reversed(range(d)):
        acc = rhs[i]
        for k in range(i + 1, d):
            acc = acc - m[i][k][None, :] * x[k]
        x[i] = acc * pinvs[i][None, :]
    return torch.stack(x, dim=0)


def _pade7_vanloan_fwd(a: Tensor, sm: Tensor, eye: Tensor):
    """Structured blockwise Pade-7 of the scaled Van Loan augmented
    matrix M = [[a, sm], [0, -a^T]]: returns (F1, G1, F3) with
    X = (V - U)^{-1}(V + U) = [[F1, G1], [0, F3]], and every intermediate
    the hand-written adjoint needs (`_pade7_vanloan_bwd`).  Every even
    power of M has bottom-right block (A^k)^T, so the whole evaluation
    runs on r x r blocks."""
    mm = sb.matmul
    r = a.shape[0]
    a2 = mm(a, a)
    s2 = mm(a, sm) - mm(sm, a, tb=True)          # a sm + sm (-a^T)
    a4 = mm(a2, a2)
    s4 = mm(a2, s2) + mm(s2, a2, tb=True)
    a6 = mm(a2, a4)
    s6 = mm(a2, s4) + mm(s2, a4, tb=True)
    b = _PADE7
    p_a = b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye
    p_s = b[7] * s6 + b[5] * s4 + b[3] * s2
    u_tl = mm(a, p_a)                             # odd polynomial, top
    u_tr = mm(a, p_s) + mm(sm, p_a, tb=True)      # a p_s + sm p_a^T
    v_tl = b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye
    v_tr = b[6] * s6 + b[4] * s4 + b[2] * s2
    nu = v_tl + u_tl
    de = v_tl - u_tl
    # bottom-right blocks of V -/+ U are Nu^T / De^T
    f3 = _lu_solve_k(sb.transpose(nu), sb.transpose(de))
    rhs_g = (v_tr + u_tr) - mm(v_tr - u_tr, f3)
    x = _lu_solve_k(de, torch.cat([nu, rhs_g], dim=1))
    saved = (a, sm, a2, s2, a4, s4, p_a, p_s, v_tr, u_tr, nu, de, f3, x)
    return x[:, :r, :], x[:, r:, :], f3, saved


def _pade7_vanloan(a: Tensor, sm: Tensor, eye: Tensor):
    """(F1, G1, F3) of `_pade7_vanloan_fwd`."""
    return _pade7_vanloan_fwd(a, sm, eye)[:3]


def _pade7_vanloan_bwd(saved, c_f1: Tensor, c_g1: Tensor, c_f3: Tensor):
    """Hand-written adjoint of `_pade7_vanloan`: the cotangents (c_a, c_sm)
    of the scaled blocks.  Solve adjoints use the X = A^{-1} B rules
    (c_B = A^{-T} c_X, c_A = -c_B X^T); the product chain reverses term by
    term (expm_pallas.py:163)."""
    mm = sb.matmul
    tr = sb.transpose
    (a, sm, a2, s2, a4, s4, p_a, p_s, v_tr, u_tr, nu, de, f3, x) = saved
    r = a.shape[0]
    b = _PADE7

    # x = de^{-1} [nu | rhs_g]
    c_b2 = _lu_solve_k(tr(de), torch.cat([c_f1, c_g1], dim=1))
    c_de = -mm(c_b2, x, tb=True)
    c_nu = c_b2[:, :r, :]
    c_rhsg = c_b2[:, r:, :]

    # rhs_g = (v_tr + u_tr) - (v_tr - u_tr) f3
    c_m = -mm(c_rhsg, f3, tb=True)
    c_vtr = c_rhsg + c_m
    c_utr = c_rhsg - c_m
    c_f3 = c_f3 - mm(v_tr - u_tr, c_rhsg, ta=True)

    # f3 = nu^{-T} de^T
    c_bw = _lu_solve_k(nu, c_f3)
    c_de = c_de + tr(c_bw)
    c_nu = c_nu - tr(mm(c_bw, f3, tb=True))

    # nu = v_tl + u_tl, de = v_tl - u_tl
    c_vtl = c_nu + c_de
    c_utl = c_nu - c_de

    # u_tl = a p_a;  u_tr = a p_s + sm p_a^T
    c_a = mm(c_utl, p_a, tb=True) + mm(c_utr, p_s, tb=True)
    c_pa = mm(a, c_utl, ta=True) + mm(c_utr, sm, ta=True)
    c_ps = mm(a, c_utr, ta=True)
    c_sm = mm(c_utr, p_a)

    # polynomial coefficients
    c_a6 = b[7] * c_pa + b[6] * c_vtl
    c_a4 = b[5] * c_pa + b[4] * c_vtl
    c_a2 = b[3] * c_pa + b[2] * c_vtl
    c_s6 = b[7] * c_ps + b[6] * c_vtr
    c_s4 = b[5] * c_ps + b[4] * c_vtr
    c_s2 = b[3] * c_ps + b[2] * c_vtr

    # s6 = a2 s4 + s2 a4^T
    c_a2 = c_a2 + mm(c_s6, s4, tb=True)
    c_s4 = c_s4 + mm(a2, c_s6, ta=True)
    c_s2 = c_s2 + mm(c_s6, a4)
    c_a4 = c_a4 + mm(c_s6, s2, ta=True)
    # a6 = a2 a4
    c_a2 = c_a2 + mm(c_a6, a4, tb=True)
    c_a4 = c_a4 + mm(a2, c_a6, ta=True)
    # s4 = a2 s2 + s2 a2^T
    c_a2 = c_a2 + mm(c_s4, s2, tb=True) + mm(c_s4, s2, ta=True)
    c_s2 = c_s2 + mm(a2, c_s4, ta=True) + mm(c_s4, a2)
    # a4 = a2 a2
    c_a2 = c_a2 + mm(c_a4, a2, tb=True) + mm(a2, c_a4, ta=True)
    # s2 = a sm - sm a^T
    c_a = c_a + mm(c_s2, sm, tb=True) - mm(c_s2, sm, ta=True)
    c_sm = c_sm + mm(a, c_s2, ta=True) - mm(c_s2, a)
    # a2 = a a
    c_a = c_a + mm(c_a2, a, tb=True) + mm(a, c_a2, ta=True)
    return c_a, c_sm


def _generator_norms(g: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(sym = (G + G^T)/2, ||-G/2||_inf, inf-norm of the augmented Van
    Loan matrix [[A, S], [0, -A^T]]) as device tensors."""
    a_half = -0.5 * g
    sym = 0.5 * (g + g.T)
    half = torch.amax(torch.sum(torch.abs(a_half), dim=1))
    augn = torch.maximum(
        torch.amax(torch.sum(torch.abs(a_half) + torch.abs(sym), dim=1)),
        torch.amax(torch.sum(torch.abs(a_half), dim=0)),
    )
    return sym, half, augn


def _tn_math(g: Tensor, dt: Tensor) -> Tuple[Tensor, Tensor]:
    """dt [M] -> (e, q) [r, r, M]: e = expm(-dG/2) and Q1 = I - e e^T.

    Van Loan branch (cancellation-free Q) where dt ||G/2|| < 1, direct
    I - e e^T elsewhere; scaling from the augmented norm; each lane is
    squared back its own number of times (masked, up to the batch
    maximum, which is read to the host once)."""
    r = g.shape[0]
    dtype = g.dtype
    sym, half, augn = _generator_norms(g)
    eye = sb.eye_em(r, g)
    small = (dt * half < 1.0).to(dtype)[None, None, :]
    s = torch.ceil(torch.log2(torch.clamp(dt * augn / _THETA7, min=1.0)))
    s = torch.clamp(s, 0.0, float(_MAXSQ))
    scale = (dt * torch.exp2(-s))[None, None, :]
    a = g[:, :, None] * (-0.5) * scale
    sm = sym[:, :, None] * scale

    f1, g1, f3 = _pade7_vanloan(a, sm, eye)

    smax = int(torch.amax(s)) if s.numel() else 0
    for k in range(smax):
        do = (s > k).to(dtype)[None, None, :]
        doq = do * small
        f1n = sb.matmul(f1, f1)
        g1n = sb.matmul(f1, g1) + sb.matmul(g1, f3)
        f3n = sb.matmul(f3, f3)
        f1 = do * f1n + (1.0 - do) * f1
        g1 = doq * g1n + (1.0 - doq) * g1
        f3 = doq * f3n + (1.0 - doq) * f3

    q_vl = sb.matmul(g1, f1, tb=True)
    q_dir = eye - sb.matmul(f1, f1, tb=True)
    q = small * q_vl + (1.0 - small) * q_dir
    q = 0.5 * (q + sb.transpose(q))
    return f1, q


def _gap_row_terms(g: Tensor, dt: Tensor, gv: Tensor):
    """Gap terms dt [M] -> (d_left, d_right, off [r, r, M], per-gap
    log|Q1| [M]), valid-masked by gv (invalid gaps give exact zeros):

      off = -Q1^{-1} e,  d_left = Q1^{-1} - I,  d_right = e^T Q1^{-1} e
    """
    e, q = _tn_math(g, dt)
    eye = sb.eye_em(g.shape[0], g)
    gv3 = gv[None, None, :]
    L, invd, ldl = _chol(q)
    q1_inv_e = sb.solve_lower_t(L, invd, sb.solve_lower(L, invd, e))
    li = sb.solve_lower(L, invd, eye.expand_as(e))
    d_left = (sb.matmul(li, li, ta=True) - eye) * gv3
    d_right = sb.matmul(e, q1_inv_e, ta=True) * gv3
    off = -q1_inv_e * gv3
    return d_left, d_right, off, 2.0 * ldl * gv


def tn_replay_structured(g: Tensor, diffs: Tensor):
    """(e, q) element-major [r, r, M] by the kernel's structured Pade-7,
    as plain differentiable tensor code: the backward of the (e, Q)
    kernel replays it by autograd (`transition_and_noise_diff`).

    Two changes make it differentiable: the squaring loop is a fixed
    masked loop of `_NSQ_VL` rounds on gaps clamped into the Van Loan
    range (the clamped gap needs at most that many, see `_NSQ_VL`), and
    the true-gap transition of the direct branch comes from `expm_em`
    (Pade-13, with its Frechet VJP).  Values match the kernel to float32
    backward error."""
    from .expm_em import expm_em

    r = g.shape[0]
    dtype = g.dtype
    a0 = -0.5 * g
    s0 = 0.5 * (g + g.T)
    half = torch.amax(torch.sum(torch.abs(a0), dim=1))
    augn = torch.maximum(
        torch.amax(torch.sum(torch.abs(a0) + torch.abs(s0), dim=1)),
        torch.amax(torch.sum(torch.abs(a0), dim=0)),
    )
    small = diffs * half < 1.0
    smallf = small.to(dtype)[None, None, :]
    d_vl = torch.where(small, diffs, 1.0 / half)
    s_cnt = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(d_vl * augn / _THETA7, min=1.0))),
        0.0, float(_NSQ_VL))
    scale = (d_vl * torch.exp2(-s_cnt))[None, None, :]
    eye = sb.eye_em(r, g)
    f1, g1, f3 = _pade7_vanloan(a0[:, :, None] * scale,
                                s0[:, :, None] * scale, eye)
    for k in range(_NSQ_VL):
        do = (s_cnt > float(k)).to(dtype)[None, None, :]
        f1n = sb.matmul(f1, f1)
        g1n = sb.matmul(f1, g1) + sb.matmul(g1, f3)
        f3n = sb.matmul(f3, f3)
        f1 = do * f1n + (1.0 - do) * f1
        g1 = do * g1n + (1.0 - do) * g1
        f3 = do * f3n + (1.0 - do) * f3
    q_vl = sb.matmul(g1, f1, tb=True)

    # direct branch at the true gaps: a decaying expm, no cancellation
    e_dir = expm_em(a0[:, :, None] * diffs[None, None, :])
    q_dir = eye - sb.matmul(e_dir, e_dir, tb=True)
    e = smallf * f1 + (1.0 - smallf) * e_dir
    q = smallf * q_vl + (1.0 - smallf) * q_dir
    return e, 0.5 * (q + sb.transpose(q))


def _tn_adjoint(g: Tensor, dt: Tensor, gv: Tensor, c_off: Tensor,
                c_dl: Tensor, c_dr: Tensor, c_lq: Tensor):
    """Adjoint of the gap emission for M gaps (the TPU ``_tn_adj_cell``):
    per-gap cotangents of (off, d_left, d_right [r, r, M], log|Q1| [M])
    -> (c_dt [M], c_g [r, r, M], c_sym [r, r, M]), valid-masked by gv.

    The forward is recomputed storing every squaring round's input;
    then the q1-terms adjoint (solves against chol(Q1)), the reverse of
    the masked squaring, and the structured Pade-7 adjoint."""
    mm = sb.matmul
    tr = sb.transpose
    r = g.shape[0]
    dtype = g.dtype
    sym, half, augn = _generator_norms(g)
    eye = sb.eye_em(r, g)
    gv3 = gv[None, None, :]

    # ---- forward recompute, storing the squaring rounds' inputs ----
    small = (dt * half < 1.0).to(dtype)[None, None, :]
    s = torch.ceil(torch.log2(torch.clamp(dt * augn / _THETA7, min=1.0)))
    s = torch.clamp(s, 0.0, float(_MAXSQ))
    scale = (dt * torch.exp2(-s))[None, None, :]
    f1, g1, f3, saved = _pade7_vanloan_fwd(g[:, :, None] * (-0.5) * scale,
                                           sym[:, :, None] * scale, eye)
    smax = int(torch.amax(s)) if s.numel() else 0
    rounds = []
    for k in range(smax):
        rounds.append((f1, g1, f3))
        do = (s > k).to(dtype)[None, None, :]
        doq = do * small
        f1n = mm(f1, f1)
        g1n = mm(f1, g1) + mm(g1, f3)
        f3n = mm(f3, f3)
        f1 = do * f1n + (1.0 - do) * f1
        g1 = doq * g1n + (1.0 - doq) * g1
        f3 = doq * f3n + (1.0 - doq) * f3
    e = f1
    q = small * mm(g1, f1, tb=True) + (1.0 - small) * (eye - mm(f1, f1,
                                                               tb=True))
    q = 0.5 * (q + tr(q))

    # ---- q1-terms adjoint: (c_off, c_dl, c_dr, c_lq) -> (c_e, c_q) ----
    L, invd, _ = _chol(q)

    def msolve(x):  # Q1^{-1} x through the Cholesky
        return sb.solve_lower_t(L, invd, sb.solve_lower(L, invd, x))

    co = c_off * gv3
    cdl = c_dl * gv3
    cdr = c_dr * gv3
    clq = (c_lq * gv)[None, None, :]
    q1_inv_e = msolve(e)
    # off = -M e, d_left = M - I, d_right = e^T M e, lq = log|Q1|
    c_m = cdl + mm(mm(e, cdr), e, tb=True) - mm(co, e, tb=True)
    c_q = -tr(msolve(tr(msolve(c_m))))  # -M c_m M
    c_q = c_q + clq * msolve(eye.expand_as(e))  # d log|Q1| = tr(Q1^-1 dQ1)
    c_e = -msolve(co) + mm(q1_inv_e, cdr + tr(cdr))

    # ---- q-branch adjoint ----
    c_qs = 0.5 * (c_q + tr(c_q))
    c_qvl = small * c_qs
    c_qdir = (1.0 - small) * c_qs
    c_g1 = mm(c_qvl, f1)
    c_f1 = (c_e + mm(c_qvl, g1, ta=True) - mm(c_qdir, f1)
            - mm(c_qdir, f1, ta=True))
    c_f3 = torch.zeros_like(c_e)

    # ---- reverse masked squaring ----
    for k in reversed(range(smax)):
        f1k, g1k, f3k = rounds[k]
        do = (s > k).to(dtype)[None, None, :]
        doq = do * small
        # f1' = f1^2 ; g1' = f1 g1 + g1 f3 ; f3' = f3^2 (masked)
        c_f1, c_g1, c_f3 = (
            do * (mm(c_f1, f1k, tb=True) + mm(f1k, c_f1, ta=True))
            + (1.0 - do) * c_f1 + doq * mm(c_g1, g1k, tb=True),
            doq * (mm(f1k, c_g1, ta=True) + mm(c_g1, f3k, tb=True))
            + (1.0 - doq) * c_g1,
            doq * (mm(g1k, c_g1, ta=True) + mm(c_f3, f3k, tb=True)
                   + mm(f3k, c_f3, ta=True)) + (1.0 - doq) * c_f3,
        )

    # ---- Pade-7 adjoint -> scaled-block cotangents ----
    c_a, c_sm = _pade7_vanloan_bwd(saved, c_f1, c_g1, c_f3)
    c_scale = torch.sum(c_a * (g[:, :, None] * -0.5) + c_sm * sym[:, :, None],
                        dim=(0, 1))
    c_dt = c_scale * torch.exp2(-s) * gv
    return c_dt, c_a * (-0.5) * scale, c_sm * scale


def k_system_adjoint_plain(g: Tensor, dt_cm: Tensor, gv_cm: Tensor,
                           c_off_cm: Tensor, c_dl_cm: Tensor,
                           c_dr_cm: Tensor, c_lq_cm: Tensor):
    """Plain twin of the K-system adjoint kernel (see
    `k_system_adjoint_cuda`)."""
    s, c = dt_cm.shape
    r = g.shape[0]

    def em(x):  # [s, r, r, C] -> [r, r, s*C] (gap j*C + c)
        return x.permute(1, 2, 0, 3).reshape(r, r, s * c)

    c_dt, c_g, c_sym = _tn_adjoint(
        g, dt_cm.reshape(-1), gv_cm.reshape(-1), em(c_off_cm), em(c_dl_cm),
        em(c_dr_cm), c_lq_cm.reshape(-1))
    return torch.sum(c_g, dim=-1), torch.sum(c_sym, dim=-1), c_dt.reshape(s, c)


def transition_and_noise_plain(g: Tensor, diffs: Tensor):
    """Plain twin of the (e, Q) kernel: (e [r, r, M], q [r, r, M])."""
    return _tn_math(g, diffs)


def k_system_plain(g: Tensor, boost: Tensor, dt_cm: Tensor, gv_cm: Tensor,
                   real_cm: Tensor, wrap_em: Tensor):
    """Plain twin of the K-system kernel (see `k_system_cuda`)."""
    s, c = dt_cm.shape
    r = g.shape[0]
    d_left, d_right, off, lq = _gap_row_terms(g, dt_cm.reshape(-1),
                                              gv_cm.reshape(-1))

    def cm(x):  # [r, r, s*C] (step-major) -> [s, r, r, C]
        return x.reshape(r, r, s, c).permute(2, 0, 1, 3)

    d_left_prev = torch.cat([wrap_em[None], cm(d_left)[:-1]], dim=0)
    eye = torch.eye(r, dtype=g.dtype, device=g.device)[None, :, :, None]
    k_cm = (eye + d_left_prev + cm(d_right)
            + boost[None, :, :, None] * real_cm[:, None, None, :])
    return k_cm, cm(off), lq.reshape(s, c)


def gap_mahal_sweep_plain(g: Tensor, boost: Tensor, dt_cm: Tensor,
                          gv_cm: Tensor, real_cm: Tensor, wrap_em: Tensor,
                          y_cm: Tensor):
    """Plain twin of the fused gaps -> sweep kernel: the K system of
    `k_system_plain` eliminated by the forward-sweep twin (the fused
    kernel builds exactly these rows and runs exactly this step)."""
    s = dt_cm.shape[0]
    k_cm, off_cm, lq = k_system_plain(g, boost, dt_cm, gv_cm, real_cm,
                                      wrap_em)
    (acc00, accy0, w0l, wl, dl, invdl, mh, ld,
     _) = forward_sweep_plain(k_cm, off_cm, y_cm)
    return (acc00, accy0, w0l, wl, dl, invdl, mh, ld, torch.sum(lq),
            k_cm[0], off_cm[s - 1])


def _check_generator(name: str, g: Tensor, boost: Tensor = None) -> int:
    r = g.shape[0]
    _build.check_shape(name, "g", g, (r, r))
    if boost is not None:
        _build.check_shape(name, "boost", boost, (r, r))
    _build.check_rank(r, name)
    return r


# Kernel 2's design by the gap count M: up to TN_ROWS_MAX_M gaps R lanes
# build a gap, a row each (csrc/gap_emission.cu's
# transition_and_noise_rows_kernel), above it one thread does
# (transition_and_noise_thread_kernel).  On the H100 at rank 5 the rows
# design is faster up to 4,096 gaps (5.3-6.2 against 6.1-6.8 µs a launch),
# a tie at 7,813 and slower from 12,000 on, where one thread a gap has
# warps enough to hide its chain (PERF.md §6).  chip_smoke.py's [tn-pick]
# times both designs on both sides of the bound and fails where this picks
# the slower.
TN_ROWS_MAX_M = 4096
_TN_SYMBOL = {"thread": "cgt_transition_and_noise_f32",
              "rows": "cgt_transition_and_noise_rows_f32"}


def _tn_design(m: int) -> str:
    """Kernel 2's design at ``m`` gaps: "rows" or "thread"."""
    return "rows" if m <= TN_ROWS_MAX_M else "thread"


def _tn_launch(design: str, g: Tensor, diffs: Tensor):
    """Launch kernel 2's ``design`` on CUDA float32 g [r, r] and diffs [M]
    (M > 0) and return (e, q), counting nothing."""
    r, m = g.shape[0], diffs.shape[0]
    e = diffs.new_empty((r, r, m))
    q = diffs.new_empty((r, r, m))
    lib = _build.load()
    with torch.cuda.device(diffs.device):
        err = getattr(lib, _TN_SYMBOL[design])(
            g.data_ptr(), diffs.data_ptr(), r, m, e.data_ptr(), q.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "transition_and_noise_cuda")
    return e, q


def transition_and_noise_cuda(g: Tensor, diffs: Tensor):
    """Fused (e, Q) construction per gap: g [r, r], diffs [M] float32 ->
    element-major (e [r, r, M], q [r, r, M]), e = expm(-dG/2) and
    Q = I - e e^T formed without cancellation (leg.transition_and_noise_em
    values).

    CUDA tensors launch ``csrc/gap_emission.cu`` on the current stream, the
    design `_tn_design` picks by M (R lanes a gap, a row each, up to
    TN_ROWS_MAX_M gaps; one thread a gap above);
    ``transition_and_noise_cuda.launches`` counts the launches,
    ``.launches_rows`` and ``.launches_thread`` those of each design.  CPU tensors run `transition_and_noise_plain`.
    """
    name = "transition_and_noise_cuda"
    _build.check_no_grad(name, g, diffs)
    if not diffs.is_cuda:
        return transition_and_noise_plain(g, diffs)
    _build.check_tensors(name, (torch.float32,), g=g, diffs=diffs)
    r = _check_generator(name, g)
    (m,) = diffs.shape
    if m == 0:
        return diffs.new_empty((r, r, 0)), diffs.new_empty((r, r, 0))
    design = _tn_design(m)
    e, q = _tn_launch(design, g, diffs)
    transition_and_noise_cuda.launches += 1
    if design == "rows":
        transition_and_noise_cuda.launches_rows += 1
    else:
        transition_and_noise_cuda.launches_thread += 1
    return e, q


transition_and_noise_cuda.launches = 0
transition_and_noise_cuda.launches_rows = 0
transition_and_noise_cuda.launches_thread = 0


def k_system_cuda(g: Tensor, boost: Tensor, dt_cm: Tensor, gv_cm: Tensor,
                  real_cm: Tensor, wrap_em: Tensor):
    """Fused chunk-major K-system emission.

    dt_cm/gv_cm/real_cm [s, C]: per-(step, chunk) gaps / gap validity /
    point validity; wrap_em [r, r, C]: d_left of gap c*s - 1 (valid-masked
    and lane-shifted, zeros for c = 0).  Returns (k_cm [s, r, r, C],
    off_cm [s, r, r, C], lq_cm [s, C]): K's diagonal blocks, its
    off-diagonal blocks and the valid-masked per-gap log|Q1| (the prior
    log-determinant is -sum(lq_cm)).  float32.

    CUDA tensors launch ``csrc/gap_emission.cu``'s tiled kernel (one
    thread per gap, thread blocks of 32 chunk lanes by 7 rows plus a row
    that builds the gap above the tile; ``k_system_cuda.launches`` counts
    the launches and ``.launches_tiled`` those of that design); CPU
    tensors run `k_system_plain`.
    """
    name = "k_system_cuda"
    _build.check_no_grad(name, g, boost, dt_cm, gv_cm, real_cm, wrap_em)
    if not dt_cm.is_cuda:
        return k_system_plain(g, boost, dt_cm, gv_cm, real_cm, wrap_em)
    _build.check_tensors(name, (torch.float32,), g=g, boost=boost,
                         dt_cm=dt_cm, gv_cm=gv_cm, real_cm=real_cm,
                         wrap_em=wrap_em)
    r = _check_generator(name, g, boost)
    s, c = dt_cm.shape
    _build.check_shape(name, "gv_cm", gv_cm, (s, c))
    _build.check_shape(name, "real_cm", real_cm, (s, c))
    _build.check_shape(name, "wrap_em", wrap_em, (r, r, c))
    k_cm = dt_cm.new_empty((s, r, r, c))
    off_cm = dt_cm.new_empty((s, r, r, c))
    lq_cm = dt_cm.new_empty((s, c))
    lib = _build.load()
    with torch.cuda.device(dt_cm.device):
        err = lib.cgt_k_system_f32(
            g.data_ptr(), boost.data_ptr(), dt_cm.data_ptr(),
            gv_cm.data_ptr(), real_cm.data_ptr(), wrap_em.data_ptr(),
            r, s, c, k_cm.data_ptr(), off_cm.data_ptr(), lq_cm.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    k_system_cuda.launches += 1
    k_system_cuda.launches_tiled += 1
    return k_cm, off_cm, lq_cm


k_system_cuda.launches = 0
k_system_cuda.launches_tiled = 0


def gap_mahal_sweep_cuda(g: Tensor, boost: Tensor, dt_cm: Tensor,
                         gv_cm: Tensor, real_cm: Tensor, wrap_em: Tensor,
                         y_cm: Tensor):
    """Fused gaps -> forward-eliminated likelihood sweep (K never stored).

    Inputs as `k_system_cuda`, plus y_cm [s, r, C], the right-hand side v
    in chunk-major order (s >= 2).  Returns (acc00, accy0, w0_last,
    w_last, d_last, invd_last, mh, ld, lq_sum, k0 [r, r, C],
    o_last [r, r, C]): the sweep state, the row-0 boundary blocks and the
    right coupling (gap s-1) for the reduced system, and the valid-masked
    total log|Q1|.  float32.

    CUDA tensors launch ``csrc/gap_emission.cu``'s tiled kernel (32
    chunk lanes a thread block: three warps build the gaps' emission
    terms three rows a tile while one warp eliminates the previous tile;
    ``gap_mahal_sweep_cuda.launches`` counts the launches and
    ``.launches_tiled`` those of that design); CPU tensors run
    `gap_mahal_sweep_plain`.
    """
    name = "gap_mahal_sweep_cuda"
    _build.check_no_grad(name, g, boost, dt_cm, gv_cm, real_cm, wrap_em,
                         y_cm)
    if not dt_cm.is_cuda:
        return gap_mahal_sweep_plain(g, boost, dt_cm, gv_cm, real_cm,
                                     wrap_em, y_cm)
    _build.check_tensors(name, (torch.float32,), g=g, boost=boost,
                         dt_cm=dt_cm, gv_cm=gv_cm, real_cm=real_cm,
                         wrap_em=wrap_em, y_cm=y_cm)
    r = _check_generator(name, g, boost)
    s, c = dt_cm.shape
    _build.check_shape(name, "gv_cm", gv_cm, (s, c))
    _build.check_shape(name, "real_cm", real_cm, (s, c))
    _build.check_shape(name, "wrap_em", wrap_em, (r, r, c))
    _build.check_shape(name, "y_cm", y_cm, (s, r, c))
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
    outs = [dt_cm.new_empty(shape) for shape in
            [(r, r, c), (r, c), (r, r, c), (r, c), (r, r, c), (r, c),
             (c,), (c,), (c,), (r, r, c), (r, r, c)]]
    lib = _build.load()
    with torch.cuda.device(dt_cm.device):
        err = lib.cgt_gap_mahal_sweep_f32(
            g.data_ptr(), boost.data_ptr(), dt_cm.data_ptr(),
            gv_cm.data_ptr(), real_cm.data_ptr(), wrap_em.data_ptr(),
            y_cm.data_ptr(), r, s, c, *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    gap_mahal_sweep_cuda.launches += 1
    gap_mahal_sweep_cuda.launches_tiled += 1
    acc00, accy0, w0l, wl, dl, invdl, mh, ld, lq, k0, olast = outs
    return (acc00, accy0, w0l, wl, dl, invdl, torch.sum(mh), torch.sum(ld),
            torch.sum(lq), k0, olast)


gap_mahal_sweep_cuda.launches = 0
gap_mahal_sweep_cuda.launches_tiled = 0


def k_system_adjoint_cuda(g: Tensor, dt_cm: Tensor, gv_cm: Tensor,
                          c_off_cm: Tensor, c_dl_cm: Tensor,
                          c_dr_cm: Tensor, c_lq_cm: Tensor):
    """Analytic adjoint of the gap emission behind `k_system_cuda`.

    dt_cm/gv_cm [s, C]: gaps and gap validity; per-GAP cotangents
    c_off_cm/c_dl_cm/c_dr_cm [s, r, r, C] and c_lq_cm [s, C] (the caller
    maps K-row cotangents to gap cotangents).  Returns (c_g [r, r],
    c_sym [r, r], both summed over gaps, and c_dt [s, C]); the caller
    forms the generator gradient c_g + sym(c_sym) and pulls c_dt through
    the gap geometry.  float32.

    CUDA tensors launch ``csrc/gap_adjoint.cu`` (one thread per gap, each
    thread block's 128 gaps sorted by branch and squaring rounds first;
    ``k_system_adjoint_cuda.launches`` counts the launches and
    ``.launches_sorted`` those of that design); the kernel writes one
    partial sum of c_g and c_sym per thread block, summed here (no
    atomics, so the result is deterministic).  CPU tensors run
    `k_system_adjoint_plain`.
    """
    name = "k_system_adjoint_cuda"
    args = (g, dt_cm, gv_cm, c_off_cm, c_dl_cm, c_dr_cm, c_lq_cm)
    _build.check_no_grad(name, *args)
    if not dt_cm.is_cuda:
        return k_system_adjoint_plain(*args)
    keys = ("g", "dt_cm", "gv_cm", "c_off_cm", "c_dl_cm", "c_dr_cm",
            "c_lq_cm")
    _build.check_tensors(name, (torch.float32,), **dict(zip(keys, args)))
    r = _check_generator(name, g)
    s, c = dt_cm.shape
    for key, t in zip(keys[2:], args[2:]):
        _build.check_shape(name, key, t,
                           (s, c) if t.dim() == 2 else (s, r, r, c))
    nblocks = -(-(s * c) // _ADJOINT_GAPS)
    c_dt = dt_cm.new_empty((s, c))
    c_g = dt_cm.new_empty((nblocks, r, r))
    c_sym = dt_cm.new_empty((nblocks, r, r))
    lib = _build.load()
    with torch.cuda.device(dt_cm.device):
        err = lib.cgt_k_system_adjoint_f32(
            *[a.data_ptr() for a in args], r, s, c, c_dt.data_ptr(),
            c_g.data_ptr(), c_sym.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    k_system_adjoint_cuda.launches += 1
    k_system_adjoint_cuda.launches_sorted += 1
    return torch.sum(c_g, dim=0), torch.sum(c_sym, dim=0), c_dt


k_system_adjoint_cuda.launches = 0
k_system_adjoint_cuda.launches_sorted = 0


class _TnDiff(torch.autograd.Function):
    """The (e, Q) kernel under autograd: the backward replays
    `tn_replay_structured` (the JAX ``leg._tn_pallas_diff``)."""

    @staticmethod
    def forward(ctx, g, diffs):
        ctx.save_for_backward(g, diffs)
        return transition_and_noise_cuda(g, diffs)

    @staticmethod
    def backward(ctx, c_e, c_q):
        g, diffs = ctx.saved_tensors
        with torch.enable_grad():
            g_ = g.detach().requires_grad_()
            d_ = diffs.detach().requires_grad_()
            e, q = tn_replay_structured(g_, d_)
            return torch.autograd.grad((e, q), (g_, d_), (c_e, c_q))


def transition_and_noise_diff(g: Tensor, diffs: Tensor):
    """`transition_and_noise_cuda` with a gradient: the kernel forward,
    the structured Pade-7 replay backward."""
    return _TnDiff.apply(g.contiguous(), diffs.contiguous())
