"""Sweeps of the partitioned engine as hand-written CUDA kernels.

Counterparts of ``cyclic_gps_tpu/ops/pallas_sweep.py``:

* `forward_sweep_cuda` (``csrc/forward_sweep.cu``) replaces :248
  forward_sweep_pallas, the likelihood's elimination sweep;
* `forward_sweep_solveinv_cuda` (``csrc/backward_sweep.cu``) replaces
  :772 forward_sweep_solveinv_pallas, the same sweep streaming the hat
  stacks every analytic VJP's backward consumes;
* `backward_solve_takahashi_cuda` (``csrc/backward_sweep.cu``) replaces
  :918 backward_solve_takahashi_pallas, the descending pass running the
  back-substitution and the hat-form Takahashi recursion together;
* `forward_sweep_collect_cuda` (``csrc/solve_sweep.cu``) replaces :400
  forward_sweep_collect_pallas, the solve's sweep streaming the hat
  back-substitution factors and the per-row pivot log-dets;
* `backward_substitute_cuda` (``csrc/solve_sweep.cu``) replaces :1006
  backward_substitute_pallas, the solve's descending back-substitution;
* `forward_sweep_inverse_cuda` (``csrc/inverse_sweep.cu``) replaces :534
  forward_sweep_inverse_pallas, the selected inversion's sweep streaming
  the raw factors (D, 1/diag D, C, W0);
* `takahashi_backward_cuda` (``csrc/inverse_sweep.cu``) replaces :648
  takahashi_backward_pallas, the descending raw-factor Takahashi
  recursion.

`forward_sweep_cuda` takes block sizes 9..15 through a runtime-d
instance (``csrc/rt_solve.cu``'s likelihood sweep).  The last four take
block sizes 1..8 as rank-templated instances and 9..15 as runtime-d
instances (``csrc/rt_solve.cu``, ``csrc/rt_inverse.cu``), which replace
``cyclic_gps_tpu/ops/pallas_wide.py``'s :366
forward_sweep_collect_wide_pallas, :496 backward_substitute_wide_pallas,
:641 forward_sweep_inverse_wide_pallas and :812
takahashi_backward_wide_pallas on the chunk-major layout; a wrapper counts
the two apart (``launches`` and ``launches_rt``); at 1..8 the collecting
sweep, the back-substitution, the inverse sweep and the Takahashi
recursion split each chunk lane's rows between a chain warp and warps that
stage rows or form outputs, counted on ``launches_split`` as well.  The
first three take block sizes 1..8 and 16 (celerite's boundary chain at
nblocks 8), 16 one warp per chunk lane (``launches`` counts every launch,
``launches_warp`` those at 16); at 1..8 the likelihood's sweep, the
solve+inverse sweep and the walk split each lane's rows as above
(``launches_split``).

The four elimination sweeps (the likelihood's, the solve+inverse, the
solve's and the inverse sweep: kernels 1, 6, 8 and 10) are one split
sweep, ``csrc/pipeline.cuh``'s ``elim_split``, with other outputs.  At the
instances where it loses to one thread per chunk lane
(``THREAD_F64``: float64, by rank and chunk count), their wrappers launch
the thread-per-lane kernel instead and count it on ``launches_thread``.

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
                        y_cm: Tensor, sizes=_build.RANKS):
    _build.check_tensors(name, (torch.float32, torch.float64),
                         R_cm=R_cm, O_cm=O_cm, y_cm=y_cm)
    s, d, _, c = R_cm.shape
    _build.check_shape(name, "R_cm", R_cm, (s, d, d, c))
    _build.check_shape(name, "O_cm", O_cm, (s, d, d, c))
    _build.check_shape(name, "y_cm", y_cm, (s, d, c))
    _build.check_rank(d, name, sizes)
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
    return s, d, c


def _solve_symbol(kernel: str, d: int) -> str:
    """The C entry of a kernel at block size ``d``: the rank-templated
    instance at 1..8 (and 16), the runtime-d one at 9..15."""
    return ("cgt_rt_" if _build.runtime_d(d) else "cgt_") + kernel


# The four elimination sweeps (kernels 1, 6, 8 and 10) run
# csrc/pipeline.cuh's split sweep at block sizes 1..8 but where it loses to
# one thread per chunk lane, on the H100 only at float64: (wrapper stem,
# rank) -> the least chunk count C that takes the thread-per-lane kernel
# (compiled at float64 ranks _build.THREAD_RANKS only).  At rank 8 ptxas
# puts the split sweep's state in local memory, and it loses at every C.
# At rank 7 a split block holds 16 lanes, one block an SM, so its time
# grows a wave of 132 x 16 = 2,112 lanes at a time while the thread
# kernel's stays nearly flat: 10 loses from its third wave on, 8 from its
# fifth, 1 and 6 at no C timed.  chip_smoke.py's [elim-pick] times both
# designs on both sides of these bounds and fails where this table picks
# the slower (PERF.md §6).
_WAVE = 132 * 16
THREAD_F64 = {("forward_sweep", 8): 1, ("forward_sweep_solveinv", 8): 1,
              ("forward_sweep_collect", 8): 1,
              ("forward_sweep_inverse", 8): 1,
              ("forward_sweep_collect", 7): 4 * _WAVE + 1,
              ("forward_sweep_inverse", 7): 2 * _WAVE + 1}


def _elim_design(stem: str, dtype, d: int, c: int):
    """The design of the elimination sweep ``stem`` (the stem of kernel
    1's, 6's, 8's or 10's wrapper) at block size ``d`` and ``c`` chunk
    lanes on the card: "thread" where THREAD_F64 says so, else "split" at
    1..8, None at 9..16 (one instance there)."""
    if d not in _build.RANKS:
        return None
    least = THREAD_F64.get((stem, d)) if dtype == torch.float64 else None
    return "thread" if least is not None and c >= least else "split"


def _elim_launch(stem: str, symbol: str, R_cm: Tensor, O_cm: Tensor,
                 y_cm, jitter: float):
    """Launch the elimination sweep ``stem``'s C entry ``symbol`` on
    outputs allocated here (kernel 10, ``y_cm`` None, has no right-hand
    side) and return them as its wrapper does: mh and ld summed over the
    lanes."""
    s, d, _, c = R_cm.shape
    last = [(d, d, c), (d, c), (d, d, c), (d, c), (d, d, c), (d, c), (c,),
            (c,)]
    hats = [(s - 1, d, d, c), (s - 1, d, d, c), (s - 1, d, c)]
    shapes = {"forward_sweep": last,
              "forward_sweep_solveinv": last + hats + [(s - 1, d, d, c)],
              "forward_sweep_collect": last + hats,
              "forward_sweep_inverse": [
                  (d, d, c), (d, d, c), (d, d, c), (d, c), (s - 1, d, d, c),
                  (s - 1, d, c), (s - 1, d, d, c), (s - 1, d, d, c)]}[stem]
    if y_cm is not None:
        shapes = shapes + [(s - 1, c)]  # ld_rows
    outs = [R_cm.new_empty(shape) for shape in shapes]
    ins = (R_cm, O_cm) if y_cm is None else (R_cm, O_cm, y_cm)
    with torch.cuda.device(R_cm.device):
        _launch(f"{stem}_cuda", symbol, R_cm.dtype, *ins, float(jitter), s,
                d, c, *outs)
    if y_cm is None:
        return tuple(outs)
    return (*outs[:6], torch.sum(outs[6]), torch.sum(outs[7]), *outs[8:])


def _elim_symbol(stem: str, dtype, d: int, c: int):
    """(C entry, design) of the elimination sweep ``stem`` (_elim_design)
    at block size ``d`` and ``c`` chunk lanes."""
    design = _elim_design(stem, dtype, d, c)
    if design == "thread":
        return f"cgt_{stem}_thread", design
    return _solve_symbol(stem, d), design


def _count_design(wrapper, design) -> None:
    """Count one launch of an elimination sweep at 1..8 on its design."""
    if design == "split":
        wrapper.launches_split += 1
    elif design == "thread":
        wrapper.launches_thread += 1


def _count_solve(wrapper, d: int) -> None:
    """Count one launch on ``wrapper``: ``launches`` for the rank-templated
    instance, ``launches_rt`` for the runtime-d one."""
    if _build.runtime_d(d):
        wrapper.launches_rt += 1
    else:
        wrapper.launches += 1


def _launch(name: str, symbol: str, dtype, *args) -> None:
    """Call the C entry ``symbol`` + ``_f32``/``_f64`` with ``args``
    (tensors become their data pointers) on the current stream, and raise
    if the launch failed."""
    lib = _build.load()
    fn = getattr(lib, symbol + ("_f32" if dtype == torch.float32
                                else "_f64"))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)


def forward_sweep_cuda(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                       jitter: float = 0.0):
    """Fused forward sweep on chunk-major inputs (the function of
    partitioned._forward_sweep with collect=None).

    R_cm, O_cm [s, d, d, C], y_cm [s, d, C] (float32 or float64, s >= 2,
    d in 1..16).  Returns (acc00 [d,d,C], accy0 [d,C], w0_last
    [d,d,C], w_last [d,C], d_last [d,d,C], invd_last [d,C], mh, ld, ld_rows
    [s-1, C]): everything the reduced system and W1 assembly need, plus
    the per-row pivot log-dets of steps j = 1..s-1.  ``jitter`` is added
    to every pivot block's diagonal.  The per-lane partial sums of mh and
    ld are summed outside the kernel.

    CUDA tensors launch ``csrc/forward_sweep.cu`` at d in 1..8 (the
    split sweep of ``csrc/pipeline.cuh``: lane groups of 32 chunk lanes,
    two a thread block where they fit, in each one warp running the
    elimination's carried part while three warps copy the rows in ahead
    of it with cp.async and form the row log-dets and the sums; one
    thread per chunk lane where ``THREAD_F64`` says so) and 16 (one warp
    per chunk lane)
    (``forward_sweep_cuda.launches`` counts both, ``.launches_split`` and
    ``.launches_thread`` those at 1..8 by design, ``.launches_warp`` those
    at 16) and ``csrc/rt_solve.cu``'s runtime-d sweep at d = 9..15
    (``.launches_rt``), on the current stream; CPU tensors run
    `forward_sweep_plain`.
    """
    name = "forward_sweep_cuda"
    _build.check_no_grad(name, R_cm, O_cm, y_cm)
    if not R_cm.is_cuda:
        return forward_sweep_plain(R_cm, O_cm, y_cm, jitter)
    s, d, c = _check_sweep_inputs(name, R_cm, O_cm, y_cm,
                                  _build.FORWARD_RANKS)
    symbol, design = _elim_symbol("forward_sweep", R_cm.dtype, d, c)
    out = _elim_launch("forward_sweep", symbol, R_cm, O_cm, y_cm, jitter)
    _count_solve(forward_sweep_cuda, d)
    _count_design(forward_sweep_cuda, design)
    if d == 16:
        forward_sweep_cuda.launches_warp += 1
    return out


forward_sweep_cuda.launches = 0
forward_sweep_cuda.launches_rt = 0
forward_sweep_cuda.launches_warp = 0
forward_sweep_cuda.launches_split = 0
forward_sweep_cuda.launches_thread = 0


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
    d in 1..8 or 16).  Returns the nine outputs of `forward_sweep_cuda` but
    with the per-row log-dets last: (acc00, accy0, w0_last, w_last, d_last,
    invd_last, mh, ld, hat_cs [s-1, d, d, C], hat_w0s [s-1, d, d, C],
    hat_ws [s-1, d, C], pinvs [s-1, d, d, C], ld_rows [s-1, C]), with
    stack row j-1 holding step j: hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0,
    hat_w = D^{-T} w and pinv = P^{-1} = D^{-T} D^{-1}.

    CUDA tensors launch ``csrc/backward_sweep.cu``: at d = 1..8 lane
    groups of 32 chunk lanes (fewer where shared memory is short; two a
    thread block where they fit), in each one warp running the
    elimination's carried part while three warps copy the rows in ahead
    of it with cp.async and form the hats, pinv, the row log-dets and the
    sums (``csrc/pipeline.cuh``'s ``elim_split``; one thread per chunk
    lane where ``THREAD_F64`` says so); one
    warp per chunk lane at d = 16
    (``forward_sweep_solveinv_cuda.launches`` counts every launch,
    ``.launches_split`` and ``.launches_thread`` those at 1..8 by design,
    ``.launches_warp`` those at 16); CPU tensors run
    `forward_sweep_solveinv_plain`.
    """
    name = "forward_sweep_solveinv_cuda"
    _build.check_no_grad(name, R_cm, O_cm, y_cm)
    if not R_cm.is_cuda:
        return forward_sweep_solveinv_plain(R_cm, O_cm, y_cm, jitter)
    s, d, c = _check_sweep_inputs(name, R_cm, O_cm, y_cm,
                                  _build.SWEEP_RANKS)
    symbol, design = _elim_symbol("forward_sweep_solveinv", R_cm.dtype, d,
                                  c)
    out = _elim_launch("forward_sweep_solveinv", symbol, R_cm, O_cm, y_cm,
                       jitter)
    forward_sweep_solveinv_cuda.launches += 1
    _count_design(forward_sweep_solveinv_cuda, design)
    if d == 16:
        forward_sweep_solveinv_cuda.launches_warp += 1
    return out


forward_sweep_solveinv_cuda.launches = 0
forward_sweep_solveinv_cuda.launches_split = 0
forward_sweep_solveinv_cuda.launches_thread = 0
forward_sweep_solveinv_cuda.launches_warp = 0


def _sig_ut(p00, p01, p10, p11, u0, u1):
    """(a0, a1) = Sigma_BB U^T: a0 = p00 u0^T + p01 u1^T, a1 = p10 u0^T +
    p11 u1^T (the boundary rows of the selected inverse applied to the
    chunk's coupling solves)."""
    mm = sb.matmul
    return (mm(p00, u0, tb=True) + mm(p01, u1, tb=True),
            mm(p10, u0, tb=True) + mm(p11, u1, tb=True))


def backward_solve_takahashi_plain(hat_cs, hat_w0s, hat_ws, pinvs, hat_w1,
                                   xb, xb_next, p00, p01, p10, p11):
    """Plain twin of the fused descending kernel (see
    `backward_solve_takahashi_cuda`), written as its grid runs: one
    descending loop doing both walks per step."""
    sm1 = hat_cs.shape[0]
    mm = sb.matmul
    xs, diags, offs = [None] * sm1, [None] * sm1, [None] * sm1
    for t in reversed(range(sm1)):
        hc_j, hw0_j, pinv_j = hat_cs[t], hat_w0s[t], pinvs[t]
        common = hat_ws[t] - sb.matvec(hw0_j, xb)
        if t == sm1 - 1:
            x = common - sb.matvec(hat_w1, xb_next)
            phi, u0, u1 = pinv_j, hw0_j, hat_w1
            a0, a1 = _sig_ut(p00, p01, p10, p11, u0, u1)
            diags[t] = phi + mm(u0, a0) + mm(u1, a1)
            offs[t] = -a1
        else:
            x = common - sb.matvec(hc_j, x)
            phi_off = -mm(phi, hc_j, tb=True)
            phi_j = pinv_j + mm(mm(hc_j, phi), hc_j, tb=True)
            u0_j = hw0_j - mm(hc_j, u0)
            u1_j = -mm(hc_j, u1)
            a0, a1 = _sig_ut(p00, p01, p10, p11, u0_j, u1_j)
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
    float32 or float64, d in 1..8 or 16.

    CUDA tensors launch ``csrc/backward_sweep.cu``: at d = 1..8 32 chunk
    lanes a thread block, one warp running the rows' serial chain (x, phi,
    u0, u1) while three warps form Sigma_jj and Sigma_{j+1,j} from what it
    parks in shared memory; one warp per chunk lane at d = 16
    (``backward_solve_takahashi_cuda.launches`` counts every launch,
    ``.launches_split`` those at 1..8, ``.launches_warp`` those at 16);
    CPU tensors run `backward_solve_takahashi_plain`.
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
    _build.check_rank(d, name, _build.SWEEP_RANKS)
    mat, vec, step, stepv = (d, d, c), (d, c), (sm1, d, d, c), (sm1, d, c)
    for key, t, shape in zip(keys, args, (step, step, stepv, step, mat, vec,
                                          vec, mat, mat, mat, mat)):
        _build.check_shape(name, key, t, shape)
    outs = [hat_cs.new_empty(shape) for shape in (stepv, step, step, mat,
                                                  mat)]
    with torch.cuda.device(hat_cs.device):
        _launch(name, "cgt_backward_solve_takahashi", hat_cs.dtype, *args,
                sm1 + 1, d, c, *outs)
    backward_solve_takahashi_cuda.launches += 1
    if d == 16:
        backward_solve_takahashi_cuda.launches_warp += 1
    else:
        backward_solve_takahashi_cuda.launches_split += 1
    return tuple(outs)


backward_solve_takahashi_cuda.launches = 0
backward_solve_takahashi_cuda.launches_split = 0
backward_solve_takahashi_cuda.launches_warp = 0



def forward_sweep_collect_plain(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                                jitter: float = 0.0):
    """Plain twin of the solve's collect kernel (see
    `forward_sweep_collect_cuda`): the forward sweep of
    `forward_sweep_plain`, with each step's hats by back substitution
    against D^T, as the TPU kernel writes them."""
    hcs, hw0s, hws = [], [], []

    def emit(D, invd, w0, w, cprev):
        hcs.append(sb.solve_lower_t(D, invd, sb.transpose(cprev)))
        hw0s.append(sb.solve_lower_t(D, invd, w0))
        hws.append(sb.solve_lower_t_vec(D, invd, w))

    outs = _plain_sweep(R_cm, O_cm, y_cm, jitter, emit)
    st = torch.stack
    return outs[:8] + (st(hcs), st(hw0s), st(hws), outs[8])


def forward_sweep_collect_cuda(R_cm: Tensor, O_cm: Tensor, y_cm: Tensor,
                               jitter: float = 0.0):
    """Forward sweep collecting the solve's hat factors (the function of
    partitioned._forward_sweep with collect="solve_ldrows", on the TPU
    kernels' Cholesky).

    R_cm, O_cm [s, d, d, C], y_cm [s, d, C] (float32 or float64, s >= 2,
    d in 1..15).  Returns (acc00, accy0, w0_last, w_last, d_last, invd_last,
    mh, ld, hat_cs [s-1, d, d, C], hat_w0s [s-1, d, d, C], hat_ws
    [s-1, d, C], ld_rows [s-1, C]), with stack row j-1 holding step j:
    hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0, hat_w = D^{-T} w and the
    pivot log-det 2 log|D_j|.  The stacks come at the true chunk count C
    (the TPU kernel pads them to its lane tile).

    CUDA tensors launch ``csrc/solve_sweep.cu`` at d <= 8: lane groups of
    32 chunk lanes (fewer where shared memory is short; two a thread
    block where they fit), in each one warp running the elimination's
    carried part while three warps copy the rows in ahead of it with
    cp.async and form the hats, the row log-dets and the sums
    (``csrc/pipeline.cuh``'s ``elim_split``; one thread per chunk lane
    where ``THREAD_F64`` says so;
    ``forward_sweep_collect_cuda.launches``, and ``.launches_split`` and
    ``.launches_thread`` by design); ``csrc/rt_solve.cu`` at d = 9..15,
    one warp per chunk lane (``.launches_rt``); CPU tensors run
    `forward_sweep_collect_plain`.
    """
    name = "forward_sweep_collect_cuda"
    _build.check_no_grad(name, R_cm, O_cm, y_cm)
    if not R_cm.is_cuda:
        return forward_sweep_collect_plain(R_cm, O_cm, y_cm, jitter)
    s, d, c = _check_sweep_inputs(name, R_cm, O_cm, y_cm,
                                  _build.SOLVE_RANKS)
    symbol, design = _elim_symbol("forward_sweep_collect", R_cm.dtype, d, c)
    out = _elim_launch("forward_sweep_collect", symbol, R_cm, O_cm, y_cm,
                       jitter)
    _count_solve(forward_sweep_collect_cuda, d)
    _count_design(forward_sweep_collect_cuda, design)
    return out


forward_sweep_collect_cuda.launches = 0
forward_sweep_collect_cuda.launches_rt = 0
forward_sweep_collect_cuda.launches_split = 0
forward_sweep_collect_cuda.launches_thread = 0


def backward_substitute_plain(hat_cs, hat_w0s, hat_ws, hat_w1, xb,
                              xb_next):
    """Plain twin of the back-substitution kernel (see
    `backward_substitute_cuda`), written as its grid runs: one descending
    loop over the whole stack."""
    sm1 = hat_cs.shape[0]
    xs = [None] * sm1
    for t in reversed(range(sm1)):
        common = hat_ws[t] - sb.matvec(hat_w0s[t], xb)
        if t == sm1 - 1:
            x = common - sb.matvec(hat_w1, xb_next)
        else:
            x = common - sb.matvec(hat_cs[t], x)
        xs[t] = x
    return torch.stack(xs)


def backward_substitute_cuda(hat_cs: Tensor, hat_w0s: Tensor,
                             hat_ws: Tensor, hat_w1: Tensor, xb: Tensor,
                             xb_next: Tensor) -> Tensor:
    """Chunk-interior back-substitution on the hat factors of
    `forward_sweep_collect_cuda` (steps s-1 .. 1, descending):

      x_{s-1} = hat_w - hat_W0 x_b - hat_W1 x_{b,next}
      x_j     = hat_w - hat_W0 x_b - hat_C x_{j+1}

    hat_cs / hat_w0s [s-1, d, d, C], hat_ws [s-1, d, C], hat_w1 =
    D_{s-1}^{-T} W1 [d, d, C], xb / xb_next [d, C] the reduced boundary
    solution and its next-chunk shift.  Returns x rows [s-1, d, C] for
    steps 1..s-1.  float32 or float64, d in 1..15.

    CUDA tensors launch ``csrc/solve_sweep.cu`` at d <= 8: 32 chunk lanes
    a thread block, one warp running the rows' chain x_j while three warps
    copy the rows in ahead of it with cp.async and form hat_w - hat_W0
    x_b (``backward_substitute_cuda.launches`` and ``.launches_split``);
    ``csrc/rt_solve.cu`` at d = 9..15, one warp per chunk lane
    (``.launches_rt``); CPU tensors run `backward_substitute_plain`.
    """
    name = "backward_substitute_cuda"
    args = (hat_cs, hat_w0s, hat_ws, hat_w1, xb, xb_next)
    _build.check_no_grad(name, *args)
    if not hat_cs.is_cuda:
        return backward_substitute_plain(*args)
    keys = ("hat_cs", "hat_w0s", "hat_ws", "hat_w1", "xb", "xb_next")
    _build.check_tensors(name, (torch.float32, torch.float64),
                         **dict(zip(keys, args)))
    sm1, d, _, c = hat_cs.shape
    _build.check_rank(d, name, _build.SOLVE_RANKS)
    shapes = ((sm1, d, d, c), (sm1, d, d, c), (sm1, d, c), (d, d, c),
              (d, c), (d, c))
    for key, t, shape in zip(keys, args, shapes):
        _build.check_shape(name, key, t, shape)
    x = hat_cs.new_empty((sm1, d, c))
    with torch.cuda.device(hat_cs.device):
        _launch(name, _solve_symbol("backward_substitute", d),
                hat_cs.dtype, *args, sm1 + 1, d, c, x)
    _count_solve(backward_substitute_cuda, d)
    if not _build.runtime_d(d):
        backward_substitute_cuda.launches_split += 1
    return x


backward_substitute_cuda.launches = 0
backward_substitute_cuda.launches_rt = 0
backward_substitute_cuda.launches_split = 0


def forward_sweep_inverse_plain(R_cm: Tensor, O_cm: Tensor,
                                jitter: float = 0.0):
    """Plain twin of the selected inversion's sweep kernel (see
    `forward_sweep_inverse_cuda`): the elimination of `forward_sweep_plain`
    on a zero right-hand side, keeping each step's raw factors."""
    ds, invds, cs, w0s = [], [], [], []

    def emit(D, invd, w0, w, cprev):
        ds.append(D)
        invds.append(invd)
        cs.append(cprev)
        w0s.append(w0)

    s, d, _, c = R_cm.shape
    acc00, _, w0l, _, dl, invdl = _plain_sweep(
        R_cm, O_cm, R_cm.new_zeros((s, d, c)), jitter, emit)[:6]
    st = torch.stack
    return acc00, w0l, dl, invdl, st(ds), st(invds), st(cs), st(w0s)


def forward_sweep_inverse_cuda(R_cm: Tensor, O_cm: Tensor,
                               jitter: float = 0.0):
    """Forward sweep for the selected inversion (the function of
    partitioned._forward_sweep with collect="inverse" and no right-hand
    side, on the TPU kernels' Cholesky).

    R_cm, O_cm [s, d, d, C] (float32 or float64, s >= 2, d in 1..15).
    Returns (acc00, w0_last, d_last [d, d, C], invd_last [d, C], ds
    [s-1, d, d, C], invds [s-1, d, C], cs [s-1, d, d, C], w0s
    [s-1, d, d, C]), with stack row j-1 holding step j's D_j, 1/diag(D_j),
    C_j = O_j D_j^{-T} and W0_j, at the true chunk count C.

    CUDA tensors launch ``csrc/inverse_sweep.cu`` at d <= 8 (the split
    sweep of ``csrc/pipeline.cuh`` without the right-hand side: lane
    groups of 32 chunk lanes, two a thread block where they fit, in each
    one warp running the elimination's carried part while three warps
    copy the rows in ahead of it with cp.async and store each row's raw
    factors; one thread per chunk lane where ``THREAD_F64`` says so;
    ``forward_sweep_inverse_cuda.launches``, and
    ``.launches_split`` and ``.launches_thread`` by design) and
    ``csrc/rt_inverse.cu`` at d = 9..15 (``.launches_rt``); CPU tensors
    run `forward_sweep_inverse_plain`.
    """
    name = "forward_sweep_inverse_cuda"
    _build.check_no_grad(name, R_cm, O_cm)
    if not R_cm.is_cuda:
        return forward_sweep_inverse_plain(R_cm, O_cm, jitter)
    s, d, _, c = R_cm.shape
    _check_sweep_inputs(name, R_cm, O_cm, R_cm.new_empty((s, d, c)),
                        _build.SOLVE_RANKS)
    symbol, design = _elim_symbol("forward_sweep_inverse", R_cm.dtype, d, c)
    out = _elim_launch("forward_sweep_inverse", symbol, R_cm, O_cm, None,
                       jitter)
    _count_solve(forward_sweep_inverse_cuda, d)
    _count_design(forward_sweep_inverse_cuda, design)
    return out


forward_sweep_inverse_cuda.launches = 0
forward_sweep_inverse_cuda.launches_rt = 0
forward_sweep_inverse_cuda.launches_split = 0
forward_sweep_inverse_cuda.launches_thread = 0


def takahashi_backward_plain(ds, invds, cs, w0s, p00, p01, p10, p11, phi0,
                             u00, u10, a00, a10):
    """Plain twin of the raw-factor Takahashi kernel (see
    `takahashi_backward_cuda`), written as its grid runs.  ``a00`` and
    ``a10`` are not read (see the wrapper)."""
    mm = sb.matmul
    sm1, d = ds.shape[0], ds.shape[1]
    eye = sb.eye_em(d, ds).expand_as(ds[0])
    phi, u0, u1 = phi0, u00, u10
    diags, offs = [None] * (sm1 - 1), [None] * (sm1 - 1)
    for t in reversed(range(sm1 - 1)):
        d_j, invd_j, c_j = ds[t], invds[t], cs[t]
        di = sb.solve_lower(d_j, invd_j, eye)
        cd = mm(c_j, di)
        phi_off = -mm(phi, cd)
        phi_j = mm(di, di, ta=True) + mm(mm(cd, phi, ta=True), cd)
        u0_j = sb.solve_lower_t(d_j, invd_j, w0s[t] - mm(c_j, u0, ta=True))
        u1_j = -sb.solve_lower_t(d_j, invd_j, mm(c_j, u1, ta=True))
        a0, a1 = _sig_ut(p00, p01, p10, p11, u0_j, u1_j)
        diags[t] = phi_j + mm(u0_j, a0) + mm(u1_j, a1)
        offs[t] = phi_off + mm(u0, a0) + mm(u1, a1)
        phi, u0, u1 = phi_j, u0_j, u1_j
    return torch.stack(diags), torch.stack(offs), u0, u1


def takahashi_backward_cuda(ds: Tensor, invds: Tensor, cs: Tensor,
                            w0s: Tensor, p00: Tensor, p01: Tensor,
                            p10: Tensor, p11: Tensor, phi0: Tensor,
                            u00: Tensor, u10: Tensor, a00: Tensor,
                            a10: Tensor):
    """Takahashi recursion over the raw factors of
    `forward_sweep_inverse_cuda`, steps s-2 .. 1 descending (stack rows
    s-3 .. 0):

      di = D^{-1},  cd = C di,  phi_off = -phi_{j+1} cd
      phi_j = di^T di + cd^T phi_{j+1} cd
      u0_j = D^{-T} (W0_j - C^T u0_{j+1}),  u1_j = -D^{-T} C^T u1_{j+1}
      Sigma_jj = phi_j + u0_j a0_j + u1_j a1_j
      Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j

    Stacks [s-1, d, d, C] (invds [s-1, d, C], s >= 3); p00/p01/p10/p11
    the reduced system's selected-inverse blocks and (phi0, u00, u10) the
    step s-1 seeds, all [d, d, C].  ``a00`` / ``a10`` (the step s-1
    values of a0 / a1) keep the TPU kernel's argument list; no step reads
    them, so they are checked but not passed to the kernel.  Returns
    (diag rows [s-2, d, d, C] = Sigma_jj, off rows [s-2, d, d, C] =
    Sigma_{j+1,j}, u0_final, u1_final [d, d, C]).  float32 or float64, d
    in 1..15.

    CUDA tensors launch ``csrc/inverse_sweep.cu`` at d <= 8: 32 chunk
    lanes a thread block, one warp running the chain (phi, u0, u1) in the
    hat form (phi_j = pinv + cd^T phi cd, u0_j = D^{-T} W0 - cd^T u0, u1_j
    = -cd^T u1) while three warps copy the rows' factors in with cp.async,
    build their hats and form Sigma_jj and Sigma_{j+1,j}
    (``takahashi_backward_cuda.launches`` and ``.launches_split``); the hat
    form sums u0 and u1 in another order than the twin, so the two agree
    to rounding.  ``csrc/rt_inverse.cu`` at d = 9..15
    (``.launches_rt``); CPU tensors run `takahashi_backward_plain`.
    """
    name = "takahashi_backward_cuda"
    args = (ds, invds, cs, w0s, p00, p01, p10, p11, phi0, u00, u10, a00,
            a10)
    _build.check_no_grad(name, *args)
    if not ds.is_cuda:
        return takahashi_backward_plain(*args)
    keys = ("ds", "invds", "cs", "w0s", "p00", "p01", "p10", "p11", "phi0",
            "u00", "u10", "a00", "a10")
    _build.check_tensors(name, (torch.float32, torch.float64),
                         **dict(zip(keys, args)))
    sm1, d, _, c = ds.shape
    _build.check_rank(d, name, _build.SOLVE_RANKS)
    if sm1 < 2:
        raise ValueError(f"{name}: chunk length {sm1 + 1} < 3")
    step, mat = (sm1, d, d, c), (d, d, c)
    for key, t, shape in zip(keys, args, (step, (sm1, d, c), step, step)
                             + (mat,) * 9):
        _build.check_shape(name, key, t, shape)
    outs = [ds.new_empty(shape) for shape in ((sm1 - 1, d, d, c),
                                              (sm1 - 1, d, d, c), mat, mat)]
    with torch.cuda.device(ds.device):
        _launch(name, _solve_symbol("takahashi_backward", d), ds.dtype,
                *args[:11], sm1 + 1, d, c, *outs)
    _count_solve(takahashi_backward_cuda, d)
    if not _build.runtime_d(d):
        takahashi_backward_cuda.launches_split += 1
    return tuple(outs)


takahashi_backward_cuda.launches = 0
takahashi_backward_cuda.launches_rt = 0
takahashi_backward_cuda.launches_split = 0
