"""Forward sweep of the partitioned engine as a hand-written CUDA kernel.

Counterpart of ``cyclic_gps_tpu/ops/pallas_sweep.py:248
forward_sweep_pallas``.  ``forward_sweep_cuda`` launches
``csrc/forward_sweep.cu`` for CUDA tensors; for CPU tensors it runs the
plain twin ``forward_sweep_plain``, which computes the same function with
tensor ops.  Both follow the TPU kernel's Cholesky (``_chol``: rsqrt
pivots, no pivot floor), so they agree with each other to rounding; the
plain engine ``partitioned._forward_sweep`` floors f32 pivots instead
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


def forward_sweep_plain(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                        jitter: float = 0.0):
    """Plain twin of the forward-sweep kernel (see `forward_sweep_cuda`)."""
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
    return (acc00, accy0, w0, w, D, invd, mh, ld,
            torch.stack(ld_rows, dim=0))


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
    if not R_cm.is_cuda:
        return forward_sweep_plain(R_cm, O_cm, y_cm, jitter)
    name = "forward_sweep_cuda"
    _build.check_tensors(name, (torch.float32, torch.float64),
                         R_cm=R_cm, O_cm=O_cm, y_cm=y_cm)
    s, d, _, c = R_cm.shape
    _build.check_shape(name, "R_cm", R_cm, (s, d, d, c))
    _build.check_shape(name, "O_cm", O_cm, (s, d, d, c))
    _build.check_shape(name, "y_cm", y_cm, (s, d, c))
    _build.check_rank(d, name)
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
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
