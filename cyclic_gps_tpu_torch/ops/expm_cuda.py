"""LEG gap emission as hand-written CUDA kernels, with plain twins.

Counterpart of ``cyclic_gps_tpu/ops/expm_pallas.py`` (forward values).
The wrappers launch ``csrc/gap_emission.cu``:

* `transition_and_noise_cuda` replaces expm_pallas.py:297
  transition_and_noise_pallas;
* `k_system_cuda` replaces expm_pallas.py:530 k_system_pallas;
* `gap_mahal_sweep_cuda` replaces expm_pallas.py:769
  gap_mahal_sweep_pallas.

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


def _pade7_vanloan(a: Tensor, sm: Tensor, eye: Tensor):
    """Structured blockwise Pade-7 of the scaled Van Loan augmented
    matrix M = [[a, sm], [0, -a^T]]: returns (F1, G1, F3) with
    X = (V - U)^{-1}(V + U) = [[F1, G1], [0, F3]].  Every even power of M
    has bottom-right block (A^k)^T, so the whole evaluation runs on r x r
    blocks."""
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
    return x[:, :r, :], x[:, r:, :], f3


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


def transition_and_noise_cuda(g: Tensor, diffs: Tensor):
    """Fused (e, Q) construction per gap: g [r, r], diffs [M] float32 ->
    element-major (e [r, r, M], q [r, r, M]), e = expm(-dG/2) and
    Q = I - e e^T formed without cancellation (leg.transition_and_noise_em
    values).

    CUDA tensors launch ``csrc/gap_emission.cu`` on the current stream
    (``transition_and_noise_cuda.launches`` counts the launches); CPU
    tensors run `transition_and_noise_plain`.
    """
    if not diffs.is_cuda:
        return transition_and_noise_plain(g, diffs)
    name = "transition_and_noise_cuda"
    _build.check_tensors(name, (torch.float32,), g=g, diffs=diffs)
    r = _check_generator(name, g)
    (m,) = diffs.shape
    e = diffs.new_empty((r, r, m))
    q = diffs.new_empty((r, r, m))
    if m == 0:
        return e, q
    lib = _build.load()
    with torch.cuda.device(diffs.device):
        err = lib.cgt_transition_and_noise_f32(
            g.data_ptr(), diffs.data_ptr(), r, m, e.data_ptr(), q.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    transition_and_noise_cuda.launches += 1
    return e, q


transition_and_noise_cuda.launches = 0


def k_system_cuda(g: Tensor, boost: Tensor, dt_cm: Tensor, gv_cm: Tensor,
                  real_cm: Tensor, wrap_em: Tensor):
    """Fused chunk-major K-system emission.

    dt_cm/gv_cm/real_cm [s, C]: per-(step, chunk) gaps / gap validity /
    point validity; wrap_em [r, r, C]: d_left of gap c*s - 1 (valid-masked
    and lane-shifted, zeros for c = 0).  Returns (k_cm [s, r, r, C],
    off_cm [s, r, r, C], lq_cm [s, C]): K's diagonal blocks, its
    off-diagonal blocks and the valid-masked per-gap log|Q1| (the prior
    log-determinant is -sum(lq_cm)).  float32.

    CUDA tensors launch ``csrc/gap_emission.cu``
    (``k_system_cuda.launches``); CPU tensors run `k_system_plain`.
    """
    if not dt_cm.is_cuda:
        return k_system_plain(g, boost, dt_cm, gv_cm, real_cm, wrap_em)
    name = "k_system_cuda"
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
    return k_cm, off_cm, lq_cm


k_system_cuda.launches = 0


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

    CUDA tensors launch ``csrc/gap_emission.cu``
    (``gap_mahal_sweep_cuda.launches``); CPU tensors run
    `gap_mahal_sweep_plain`.
    """
    if not dt_cm.is_cuda:
        return gap_mahal_sweep_plain(g, boost, dt_cm, gv_cm, real_cm,
                                     wrap_em, y_cm)
    name = "gap_mahal_sweep_cuda"
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
    acc00, accy0, w0l, wl, dl, invdl, mh, ld, lq, k0, olast = outs
    return (acc00, accy0, w0l, wl, dl, invdl, torch.sum(mh), torch.sum(ld),
            torch.sum(lq), k0, olast)


gap_mahal_sweep_cuda.launches = 0
