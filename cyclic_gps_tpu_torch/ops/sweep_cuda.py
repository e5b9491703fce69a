"""Sweeps of the partitioned engine as hand-written CUDA kernels.

Counterparts of ``cyclic_gps_tpu/ops/pallas_sweep.py``:

* `forward_sweep_cuda` (``csrc/forward_sweep.cu``) replaces :248
  forward_sweep_pallas, the likelihood's elimination sweep;
* `forward_sweep_solveinv_cuda` (``csrc/backward_sweep.cu``) replaces
  :772 forward_sweep_solveinv_pallas, the same sweep streaming the hat
  stacks every analytic VJP's backward consumes;
* `backward_solve_takahashi_cuda` (``csrc/backward_sweep.cu``) replaces
  :918 backward_solve_takahashi_pallas, the descending pass running the
  back-substitution and the hat-form Takahashi recursion together.

Each wrapper launches its kernel for CUDA tensors; for CPU tensors it runs
its plain twin (``*_plain``), which computes the same function with tensor
ops.  The twins follow the TPU kernels' Cholesky (``_chol``: rsqrt pivots,
no pivot floor), so kernel and twin agree to rounding; the plain engine
``partitioned._forward_sweep`` floors f32 pivots instead
(``smallblock.cholesky``), which differs only for near-singular pivots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import smallblock as sb

Tensor = torch.Tensor


def _chol(a: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Lower Cholesky of [d, d, C] as the TPU kernels take it: rsqrt
    pivots and no floor.  Returns (L, inv_diag [d, C], per-lane half
    log-determinant sum_j log L_jj [C])."""
    d = a.shape[0]
    x = a
    cols, invs = [], []
    ld = a.new_zeros(a.shape[-1])
    for j in range(d):
        piv = x[j, j]
        piv_inv = torch.rsqrt(piv)
        col = torch.cat([a.new_zeros((j, a.shape[-1])), x[j:, j] * piv_inv],
                        dim=0)
        cols.append(col)
        invs.append(piv_inv)
        ld = ld + 0.5 * torch.log(piv)
        if j + 1 < d:
            x = x - col[:, None, :] * col[None, :, :]
    return torch.stack(cols, dim=1), torch.stack(invs, dim=0), ld


def _plain_sweep(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor, jitter: float,
                 emit=None):
    """The kernels' elimination loop over steps j = 1..s-1 in tensor ops;
    ``emit(D, invd, w0, w, cprev)`` sees every step's factors."""
    s = R_cm.shape[0]
    d = R_cm.shape[1]
    eye = sb.eye_em(d, R_cm)
    ld_rows = []
    mh = R_cm.new_zeros(())
    ld = R_cm.new_zeros(())
    for j in range(1, s):
        p = R_cm[j] + jitter * eye
        if j > 1:
            p = p - sb.matmul(cprev, cprev, tb=True)
        D, invd, ldl = _chol(p)
        if j == 1:
            w0 = sb.solve_lower(D, invd, O_cm[0])
            w = sb.solve_lower_vec(D, invd, y_cm[j])
            acc00 = sb.matmul(w0, w0, ta=True)
            accy0 = sb.matvec(w0, w, ta=True)
        else:
            w0 = -sb.solve_lower(D, invd, sb.matmul(cprev, w0))
            w = sb.solve_lower_vec(D, invd, y_cm[j] - sb.matvec(cprev, w))
            acc00 = acc00 + sb.matmul(w0, w0, ta=True)
            accy0 = accy0 + sb.matvec(w0, w, ta=True)
        cprev = sb.transpose(sb.solve_lower(D, invd, sb.transpose(O_cm[j])))
        mh = mh + torch.sum(w * w)
        ld = ld + torch.sum(ldl)
        ld_rows.append(2.0 * ldl)
        if emit is not None:
            emit(D, invd, w0, w, cprev)
    return (acc00, accy0, w0, w, D, invd, mh, ld,
            torch.stack(ld_rows, dim=0))


def forward_sweep_plain(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                        jitter: float = 0.0):
    """Plain twin of the forward-sweep kernel (see `forward_sweep_cuda`)."""
    return _plain_sweep(R_cm, O_cm, y_cm, jitter)


def _check_sweep_inputs(name: str, R_cm: Tensor, O_cm: Tensor,
                        y_cm: Tensor):
    _build.check_tensors(name, (torch.float32, torch.float64),
                         R_cm=R_cm, O_cm=O_cm, y_cm=y_cm)
    s, d, _, c = R_cm.shape
    _build.check_shape(name, "R_cm", R_cm, (s, d, d, c))
    _build.check_shape(name, "O_cm", O_cm, (s, d, d, c))
    _build.check_shape(name, "y_cm", y_cm, (s, d, c))
    _build.check_rank(d, name)
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
    return s, d, c


def forward_sweep_cuda(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                       jitter: float = 0.0):
    """Fused forward sweep on chunk-major inputs (the function of
    partitioned._forward_sweep with collect=None).

    R_cm, O_cm [s, d, d, C], y_cm [s, d, C] (float32 or float64, s >= 2,
    d <= 8).  Returns (acc00 [d,d,C], accy0 [d,C], w0_last [d,d,C],
    w_last [d,C], d_last [d,d,C], invd_last [d,C], mh, ld, ld_rows
    [s-1, C]): everything the reduced system and W1 assembly need, plus
    the per-row pivot log-dets of steps j = 1..s-1.  ``jitter`` is added
    to every pivot block's diagonal.  The per-lane partial sums of mh and
    ld are summed outside the kernel.

    CUDA tensors launch ``csrc/forward_sweep.cu`` on the current stream
    (``forward_sweep_cuda.launches`` counts the launches); CPU tensors run
    `forward_sweep_plain`.
    """
    name = "forward_sweep_cuda"
    _build.check_no_grad(name, R_cm, O_cm, y_cm)
    if not R_cm.is_cuda:
        return forward_sweep_plain(R_cm, O_cm, y_cm, jitter)
    s, d, c = _check_sweep_inputs(name, R_cm, O_cm, y_cm)
    f32 = R_cm.dtype == torch.float32
    lib = _build.load()
    outs = [R_cm.new_empty(shape) for shape in
            [(d, d, c), (d, c), (d, d, c), (d, c), (d, d, c), (d, c),
             (c,), (c,), (s - 1, c)]]
    with torch.cuda.device(R_cm.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = lib.cgt_forward_sweep_f32 if f32 else lib.cgt_forward_sweep_f64
        err = fn(R_cm.data_ptr(), O_cm.data_ptr(), y_cm.data_ptr(),
                 float(jitter), s, d, c, *[o.data_ptr() for o in outs],
                 stream)
    _build.check_launch(err, name)
    forward_sweep_cuda.launches += 1
    acc00, accy0, w0l, wl, dl, invdl, mh, ld, ld_rows = outs
    return (acc00, accy0, w0l, wl, dl, invdl, torch.sum(mh), torch.sum(ld),
            ld_rows)


forward_sweep_cuda.launches = 0


def forward_sweep_solveinv_plain(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                                 jitter: float = 0.0):
    """Plain twin of the solve+inverse collect kernel (see
    `forward_sweep_solveinv_cuda`): the forward sweep of
    `forward_sweep_plain`, with the per-step hats built from the
    triangular inverse D^{-1}, as the TPU kernel's ``emit`` does."""
    hcs, hw0s, hws, pinvs = [], [], [], []
    eye = sb.eye_em(R_cm.shape[1], R_cm)

    def emit(D, invd, w0, w, cprev):
        di = sb.solve_lower(D, invd, eye.expand_as(D))
        hcs.append(sb.matmul(di, cprev, ta=True, tb=True))
        hw0s.append(sb.matmul(di, w0, ta=True))
        hws.append(sb.matvec(di, w, ta=True))
        pinvs.append(sb.matmul(di, di, ta=True))

    outs = _plain_sweep(R_cm, O_cm, y_cm, jitter, emit)
    st = torch.stack
    return outs[:8] + (st(hcs), st(hw0s), st(hws), st(pinvs), outs[8])


def forward_sweep_solveinv_cuda(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                                jitter: float = 0.0):
    """Forward sweep collecting the shared backward stacks (the function of
    partitioned._forward_sweep with collect="solve_inverse", on the TPU
    kernels' Cholesky).

    R_cm, O_cm [s, d, d, C], y_cm [s, d, C] (float32 or float64, s >= 2,
    d <= 8).  Returns the nine outputs of `forward_sweep_cuda` but with
    the per-row log-dets last: (acc00, accy0, w0_last, w_last, d_last,
    invd_last, mh, ld, hat_cs [s-1, d, d, C], hat_w0s [s-1, d, d, C],
    hat_ws [s-1, d, C], pinvs [s-1, d, d, C], ld_rows [s-1, C]), with
    stack row j-1 holding step j: hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0,
    hat_w = D^{-T} w and pinv = P^{-1} = D^{-T} D^{-1}.

    CUDA tensors launch ``csrc/backward_sweep.cu``
    (``forward_sweep_solveinv_cuda.launches``); CPU tensors run
    `forward_sweep_solveinv_plain`.
    """
    name = "forward_sweep_solveinv_cuda"
    _build.check_no_grad(name, R_cm, O_cm, y_cm)
    if not R_cm.is_cuda:
        return forward_sweep_solveinv_plain(R_cm, O_cm, y_cm, jitter)
    s, d, c = _check_sweep_inputs(name, R_cm, O_cm, y_cm)
    f32 = R_cm.dtype == torch.float32
    lib = _build.load()
    outs = [R_cm.new_empty(shape) for shape in
            [(d, d, c), (d, c), (d, d, c), (d, c), (d, d, c), (d, c),
             (c,), (c,), (s - 1, d, d, c), (s - 1, d, d, c), (s - 1, d, c),
             (s - 1, d, d, c), (s - 1, c)]]
    with torch.cuda.device(R_cm.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (lib.cgt_forward_sweep_solveinv_f32 if f32
              else lib.cgt_forward_sweep_solveinv_f64)
        err = fn(R_cm.data_ptr(), O_cm.data_ptr(), y_cm.data_ptr(),
                 float(jitter), s, d, c, *[o.data_ptr() for o in outs],
                 stream)
    _build.check_launch(err, name)
    forward_sweep_solveinv_cuda.launches += 1
    (acc00, accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0, hw, pinv,
     ld_rows) = outs
    return (acc00, accy0, w0l, wl, dl, invdl, torch.sum(mh), torch.sum(ld),
            hc, hw0, hw, pinv, ld_rows)


forward_sweep_solveinv_cuda.launches = 0


def backward_solve_takahashi_plain(hat_cs, hat_w0s, hat_ws, pinvs, hat_w1,
                                   xb, xb_next, p00, p01, p10, p11):
    """Plain twin of the fused descending kernel (see
    `backward_solve_takahashi_cuda`), written as its grid runs: one
    descending loop doing both walks per step."""
    sm1 = hat_cs.shape[0]
    mm = sb.matmul

    def sig_ut(u0, u1):
        a0 = mm(p00, u0, tb=True) + mm(p01, u1, tb=True)
        a1 = mm(p10, u0, tb=True) + mm(p11, u1, tb=True)
        return a0, a1

    xs, diags, offs = [None] * sm1, [None] * sm1, [None] * sm1
    for t in reversed(range(sm1)):
        hc_j, hw0_j, pinv_j = hat_cs[t], hat_w0s[t], pinvs[t]
        common = hat_ws[t] - sb.matvec(hw0_j, xb)
        if t == sm1 - 1:
            x = common - sb.matvec(hat_w1, xb_next)
            phi, u0, u1 = pinv_j, hw0_j, hat_w1
            a0, a1 = sig_ut(u0, u1)
            diags[t] = phi + mm(u0, a0) + mm(u1, a1)
            offs[t] = -a1
        else:
            x = common - sb.matvec(hc_j, x)
            phi_off = -mm(phi, hc_j, tb=True)
            phi_j = pinv_j + mm(mm(hc_j, phi), hc_j, tb=True)
            u0_j = hw0_j - mm(hc_j, u0)
            u1_j = -mm(hc_j, u1)
            a0, a1 = sig_ut(u0_j, u1_j)
            diags[t] = phi_j + mm(u0_j, a0) + mm(u1_j, a1)
            offs[t] = phi_off + mm(u0, a0) + mm(u1, a1)
            phi, u0, u1 = phi_j, u0_j, u1_j
        xs[t] = x
    st = torch.stack
    return st(xs), st(diags), st(offs), u0, u1


def backward_solve_takahashi_cuda(hat_cs: Tensor, hat_w0s: Tensor,
                                  hat_ws: Tensor, pinvs: Tensor,
                                  hat_w1: Tensor, xb: Tensor,
                                  xb_next: Tensor, p00: Tensor, p01: Tensor,
                                  p10: Tensor, p11: Tensor):
    """Fused back-substitution + hat-form Takahashi recursion over the
    stacks of `forward_sweep_solveinv_cuda` (steps s-1 .. 1, descending):

      x_j = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}
      (partitioned._takahashi_hat_walk for Sigma_jj and Sigma_{j+1,j})

    Stacks [s-1, d, d, C] (hat_ws [s-1, d, C]); hat_w1 = D_{s-1}^{-T} W1,
    p00/p01/p10/p11 [d, d, C] the reduced system's selected-inverse
    blocks, xb/xb_next [d, C] the boundary solution and its next-chunk
    shift.  Returns (x rows [s-1, d, C] steps 1..s-1, diag rows
    [s-1, d, d, C] = Sigma_jj, off rows [s-1, d, d, C] = Sigma_{j+1,j}
    (the last is the right-edge block), u0_final, u1_final [d, d, C]).
    float32 or float64.

    CUDA tensors launch ``csrc/backward_sweep.cu``
    (``backward_solve_takahashi_cuda.launches``); CPU tensors run
    `backward_solve_takahashi_plain`.
    """
    name = "backward_solve_takahashi_cuda"
    args = (hat_cs, hat_w0s, hat_ws, pinvs, hat_w1, xb, xb_next, p00, p01,
            p10, p11)
    _build.check_no_grad(name, *args)
    if not hat_cs.is_cuda:
        return backward_solve_takahashi_plain(*args)
    keys = ("hat_cs", "hat_w0s", "hat_ws", "pinvs", "hat_w1", "xb",
            "xb_next", "p00", "p01", "p10", "p11")
    _build.check_tensors(name, (torch.float32, torch.float64),
                         **dict(zip(keys, args)))
    sm1, d, _, c = hat_cs.shape
    _build.check_rank(d, name)
    mat, vec, step, stepv = (d, d, c), (d, c), (sm1, d, d, c), (sm1, d, c)
    for key, t, shape in zip(keys, args, (step, step, stepv, step, mat, vec,
                                          vec, mat, mat, mat, mat)):
        _build.check_shape(name, key, t, shape)
    outs = [hat_cs.new_empty(shape) for shape in (stepv, step, step, mat,
                                                  mat)]
    lib = _build.load()
    with torch.cuda.device(hat_cs.device):
        fn = (lib.cgt_backward_solve_takahashi_f32
              if hat_cs.dtype == torch.float32
              else lib.cgt_backward_solve_takahashi_f64)
        err = fn(*[a.data_ptr() for a in args], sm1 + 1, d, c,
                 *[o.data_ptr() for o in outs],
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    backward_solve_takahashi_cuda.launches += 1
    return tuple(outs)


backward_solve_takahashi_cuda.launches = 0
