"""The engine's sweeps on the WIDE layout (8 < d < 16) as hand-written CUDA
kernels.

Counterparts of ``cyclic_gps_tpu/ops/pallas_wide.py``:

* `forward_sweep_wide_cuda` (``csrc/wide_sweep.cu``) replaces :166
  forward_sweep_wide_pallas, the likelihood's elimination sweep on wide
  inputs (kernel 16 of ROADMAP Queue 2);
* `forward_sweep_solveinv_wide_cuda` (``csrc/wide_sweep.cu``) replaces
  :998 forward_sweep_solveinv_wide_pallas, the same sweep streaming the
  hat and pinv stacks of the analytic backward (kernel 21);
* `backward_solve_takahashi_wide_cuda` (``csrc/wide_backward.cu``)
  replaces :1199 backward_solve_takahashi_wide_pallas, the descending pass
  running the back-substitution and the hat-form Takahashi recursion
  together (kernel 22).

Every matrix at the boundary is a wide pair (a11 [.., 8, 8, C], st
[.., 3e, 8, C]) of ops/wideblock.py, for d = 8 + e with e in 1..7; d <= 8
and d = 16 take the plain kernels of ops/sweep_cuda.py.  The stacks stay
at the true chunk count C (the TPU kernels pad them to their lane tile).

Each wrapper launches its kernel for CUDA tensors; for CPU tensors it runs
its plain twin (``*_plain``), the TPU kernel's body written with the
wideblock helpers (blocked-panel Cholesky, rsqrt pivots, no floor).  The
kernels unpack each block to d x d and eliminate column by column, which
is the same arithmetic in another summation order.
"""

from __future__ import annotations

import torch

from . import _build
from . import wideblock as wb
from .sweep_cuda import _launch

Tensor = torch.Tensor

WIDE_E = tuple(range(1, 8))  # d = 8 + e the wide kernels take


def check_wide(e: int, name: str) -> None:
    """Refuse a strip height that is not a wide block size 9..15."""
    if e not in WIDE_E:
        raise ValueError(
            f"{name}: block size d = {8 + e} (e = {e}) is not a wide size; "
            "the wide kernels take d = 9..15 (e = 1..7), and d <= 8 and "
            "d = 16 run the plain kernels of ops/sweep_cuda.py (ROADMAP.md, "
            "Queue 2)")


def _eyes(e: int, like: Tensor):
    """The wide identity: (eye8 [8, 8, 1], eye strips [3e, 8, 1])."""
    eye8 = torch.eye(8, dtype=like.dtype, device=like.device)[:, :, None]
    eye_e = torch.eye(e, 8, dtype=like.dtype, device=like.device)[:, :, None]
    return eye8, torch.cat([torch.zeros_like(eye_e), torch.zeros_like(eye_e),
                            eye_e], dim=0)


def _wide_plain_sweep(R11, Rst, O11, Ost, y_cm, jitter, emit=None):
    """The wide kernels' elimination loop over steps j = 1..s-1 with the
    wideblock helpers (pallas_wide._wide_sweep_kernel); ``emit(D, w0, w,
    x)`` sees every step's factor D = (L11, Lst, invd1, invd2), W0 and w
    as wide pairs and x = D^{-1} O_j^T."""
    s = R11.shape[0]
    e = Rst.shape[1] // 3
    eye8, eyest = _eyes(e, R11)
    mh = R11.new_zeros(())
    ld = R11.new_zeros(())
    for j in range(1, s):
        r11, rst = R11[j] + jitter * eye8, Rst[j] + jitter * eyest
        y1, y2 = y_cm[j, :8, None], y_cm[j, 8:, None]
        if j == 1:
            L11, Lst, i1, i2, ldj = wb.wchol(r11, rst)
            D = (L11, Lst, i1, i2)
            w0 = wb.wsolve_lower(*D, O11[0], Ost[0])
            w = wb.wsolve_lower_vec(*D, y1, y2)
            acc = wb.wmm_tn(*w0, *w0)
            accy0 = wb.wmv_t(*w0, *w)
        else:
            s11, sst = wb.wmm_nt(*cp, *cp)
            L11, Lst, i1, i2, ldj = wb.wchol(r11 - s11, rst - sst)
            D = (L11, Lst, i1, i2)
            m11, mst = wb.wmm(*cp, *w0)
            w011, w0st = wb.wsolve_lower(*D, m11, mst)
            cv1, cv2 = wb.wmv(*cp, *w)
            w0 = (-w011, -w0st)
            w = wb.wsolve_lower_vec(*D, y1 - cv1, y2 - cv2)
            acc = wb.wadd(*acc, *wb.wmm_tn(*w0, *w0))
            g1, g2 = wb.wmv_t(*w0, *w)
            accy0 = (accy0[0] + g1, accy0[1] + g2)
        x = wb.wsolve_lower(*D, *wb.wtranspose(O11[j], Ost[j]))
        cp = wb.wtranspose(*x)
        mh = mh + torch.sum(w[0] * w[0]) + torch.sum(w[1] * w[1])
        ld = ld + torch.sum(ldj)
        if emit is not None:
            emit(D, w0, w, x)
    vec = lambda v: torch.cat(v, dim=0)[:, 0]  # noqa: E731
    return (*acc, vec(accy0), *w0, vec(w), D[0], D[1], vec(D[2:]), mh, ld)


def forward_sweep_wide_plain(R11: Tensor, Rst: Tensor, O11: Tensor,
                             Ost: Tensor, y_cm: Tensor, jitter: float = 0.0):
    """Plain twin of kernel 16 (see `forward_sweep_wide_cuda`)."""
    return _wide_plain_sweep(R11, Rst, O11, Ost, y_cm, jitter)


def _check_sweep(name, R11, Rst, O11, Ost, y_cm):
    """Shapes of a wide sweep's inputs; returns (s, e, C)."""
    s, c = R11.shape[0], R11.shape[-1]
    e = Rst.shape[1] // 3
    check_wide(e, name)
    for key, t, shape in (("R11", R11, (s, 8, 8, c)),
                          ("Rst", Rst, (s, 3 * e, 8, c)),
                          ("O11", O11, (s, 8, 8, c)),
                          ("Ost", Ost, (s, 3 * e, 8, c)),
                          ("y_cm", y_cm, (s, 8 + e, c))):
        _build.check_shape(name, key, t, shape)
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
    return s, e, c


def _sweep_cuda(name, wrapper, symbol, plain, args, jitter, collect):
    """The two sweep wrappers' body: check, run ``plain`` on CPU tensors,
    else launch the C entry ``symbol`` and count it on ``wrapper``."""
    _build.check_no_grad(name, *args)
    s, e, c = _check_sweep(name, *args)
    if not args[0].is_cuda:
        return plain(*args, jitter)
    _build.check_tensors(name, (torch.float32, torch.float64),
                         **dict(zip(("R11", "Rst", "O11", "Ost", "y_cm"),
                                    args)))
    d = 8 + e
    shapes = [(8, 8, c), (3 * e, 8, c), (d, c)] * 3 + [(c,), (c,)]
    if collect:
        shapes += [(s - 1, 8, 8, c), (s - 1, 3 * e, 8, c)] * 2 + [
            (s - 1, d, c), (s - 1, 8, 8, c), (s - 1, 3 * e, 8, c)]
    outs = [args[0].new_empty(shape) for shape in shapes]
    with torch.cuda.device(args[0].device):
        _launch(name, symbol, args[0].dtype, *args, float(jitter), s, e, c,
                *outs)
    wrapper.launches += 1
    # the per-lane partial sums of mh and ld are summed here
    return (*outs[:9], torch.sum(outs[9]), torch.sum(outs[10]), *outs[11:])


def forward_sweep_wide_cuda(R11: Tensor, Rst: Tensor, O11: Tensor,
                            Ost: Tensor, y_cm: Tensor, jitter: float = 0.0):
    """Fused forward sweep on wide chunk-major inputs.

    R11 / O11 [s, 8, 8, C], Rst / Ost [s, 3e, 8, C], y_cm [s, d, C] with
    d = 8 + e, e in 1..7, s >= 2, float32 or float64.  Returns (acc11,
    accst, accy0 [d, C], w011, w0st, w_last [d, C], d11, dst, invd [d, C],
    mh, ld): the running sum W0^T W0, W0^T w, the last step's W0, w and
    Cholesky factor (wide pairs), 1/diag D, and the sums of ||w||^2 and of
    log diag D over every step and lane.  ``jitter`` is added to every
    pivot block's diagonal.

    CUDA tensors launch ``csrc/wide_sweep.cu`` on the current stream
    (``forward_sweep_wide_cuda.launches`` counts the launches); CPU tensors
    run `forward_sweep_wide_plain`.
    """
    return _sweep_cuda("forward_sweep_wide_cuda", forward_sweep_wide_cuda,
                       "cgt_wide_sweep", forward_sweep_wide_plain,
                       (R11, Rst, O11, Ost, y_cm), jitter, collect=False)


forward_sweep_wide_cuda.launches = 0


def forward_sweep_solveinv_wide_plain(R11: Tensor, Rst: Tensor, O11: Tensor,
                                      Ost: Tensor, y_cm: Tensor,
                                      jitter: float = 0.0):
    """Plain twin of kernel 21 (see `forward_sweep_solveinv_wide_cuda`):
    the sweep of `forward_sweep_wide_plain`, with each step's hats and
    pinv from the triangular inverse di = D^{-1}, as the TPU kernel's
    ``emit`` builds them."""
    eye8, eyest = _eyes(Rst.shape[1] // 3, R11)
    stacks = [[] for _ in range(7)]

    def emit(D, w0, w, x):
        di = wb.wsolve_lower(*D, eye8.expand(8, 8, R11.shape[-1]),
                             eyest.expand(-1, 8, R11.shape[-1]))
        hv = wb.wmv_t(*di, *w)
        for lst, val in zip(stacks, (*wb.wmm_tn(*di, *x),
                                     *wb.wmm_tn(*di, *w0),
                                     torch.cat(hv, dim=0)[:, 0],
                                     *wb.wmm_tn(*di, *di))):
            lst.append(val)

    outs = _wide_plain_sweep(R11, Rst, O11, Ost, y_cm, jitter, emit)
    return outs + tuple(torch.stack(lst) for lst in stacks)


def forward_sweep_solveinv_wide_cuda(R11: Tensor, Rst: Tensor, O11: Tensor,
                                     Ost: Tensor, y_cm: Tensor,
                                     jitter: float = 0.0):
    """Wide forward sweep collecting the shared backward stacks.

    Inputs as `forward_sweep_wide_cuda`.  Returns its eleven outputs
    followed by (hc11, hcst, hw011, hw0st, hw [s-1, d, C], pinv11,
    pinvst): stack row j-1 holds step j's hat_C = D^{-T} C^T, hat_W0 =
    D^{-T} W0, hat_w = D^{-T} w and pinv = P^{-1} = D^{-T} D^{-1}, the
    matrices as wide stacks [s-1, 8, 8, C] / [s-1, 3e, 8, C].

    CUDA tensors launch ``csrc/wide_sweep.cu``
    (``forward_sweep_solveinv_wide_cuda.launches``); CPU tensors run
    `forward_sweep_solveinv_wide_plain`.
    """
    return _sweep_cuda("forward_sweep_solveinv_wide_cuda",
                       forward_sweep_solveinv_wide_cuda,
                       "cgt_wide_sweep_solveinv",
                       forward_sweep_solveinv_wide_plain,
                       (R11, Rst, O11, Ost, y_cm), jitter, collect=True)


forward_sweep_solveinv_wide_cuda.launches = 0


def backward_solve_takahashi_wide_plain(hc11, hcst, hw011, hw0st, hw,
                                        pinv11, pinvst, hw1_11, hw1_st, xb,
                                        xb_next, p00, p01, p10, p11):
    """Plain twin of kernel 22 (see `backward_solve_takahashi_wide_cuda`),
    written as the TPU kernel's grid runs: one descending loop doing both
    walks per step with wide products."""
    sm1 = hc11.shape[0]

    def mm(a, b):
        return wb.wmm(*a, *b)

    def add(a, b):
        return a[0] + b[0], a[1] + b[1]

    def neg(a):
        return -a[0], -a[1]

    def sig_ut(u0, u1):
        ut0, ut1 = wb.wtranspose(*u0), wb.wtranspose(*u1)
        return (add(mm(p00, ut0), mm(p01, ut1)),
                add(mm(p10, ut0), mm(p11, ut1)))

    hw1 = (hw1_11, hw1_st)
    xs, dgs, ofs = [None] * sm1, [None] * sm1, [None] * sm1
    for t in reversed(range(sm1)):
        hc, hw0 = (hc11[t], hcst[t]), (hw011[t], hw0st[t])
        pinv = (pinv11[t], pinvst[t])
        h1, h2 = wb.wmv(*hw0, xb[:8, None], xb[8:, None])
        c1, c2 = hw[t, :8, None] - h1, hw[t, 8:, None] - h2
        if t == sm1 - 1:
            g1, g2 = wb.wmv(*hw1, xb_next[:8, None], xb_next[8:, None])
            phi, u0, u1 = pinv, hw0, hw1
            a0, a1 = sig_ut(u0, u1)
            dgs[t] = add(phi, add(mm(u0, a0), mm(u1, a1)))
            ofs[t] = neg(a1)
        else:
            g1, g2 = wb.wmv(*hc, x[:8], x[8:])
            tt = mm(phi, wb.wtranspose(*hc))          # phi_{j+1} hat_c^T
            phi_j = add(pinv, mm(hc, tt))
            u0_j = add(hw0, neg(mm(hc, u0)))
            u1_j = neg(mm(hc, u1))
            a0, a1 = sig_ut(u0_j, u1_j)
            dgs[t] = add(phi_j, add(mm(u0_j, a0), mm(u1_j, a1)))
            ofs[t] = add(neg(tt), add(mm(u0, a0), mm(u1, a1)))
            phi, u0, u1 = phi_j, u0_j, u1_j
        x = torch.cat([c1 - g1, c2 - g2], dim=0)
        xs[t] = x[:, 0]
    st = torch.stack
    return (st(xs), (st([a for a, _ in dgs]), st([b for _, b in dgs])),
            (st([a for a, _ in ofs]), st([b for _, b in ofs])), u0, u1)


def backward_solve_takahashi_wide_cuda(hc11: Tensor, hcst: Tensor,
                                       hw011: Tensor, hw0st: Tensor,
                                       hw: Tensor, pinv11: Tensor,
                                       pinvst: Tensor, hw1_11: Tensor,
                                       hw1_st: Tensor, xb: Tensor,
                                       xb_next: Tensor, p00, p01, p10, p11):
    """Fused wide back-substitution + hat-form Takahashi recursion over the
    stacks of `forward_sweep_solveinv_wide_cuda` (steps s-1 .. 1,
    descending).

    hc / hw0 / pinv as wide stacks [s-1, 8, 8, C] / [s-1, 3e, 8, C], hw
    [s-1, d, C]; (hw1_11, hw1_st) = D_{s-1}^{-T} W1 as a wide pair; xb /
    xb_next [d, C] the boundary solution and its next-chunk shift;
    p00, p01, p10, p11 the reduced system's selected-inverse blocks as wide
    pairs (a11 [8, 8, C], st [3e, 8, C]).  Returns (x rows [s-1, d, C]
    steps 1..s-1, Sigma_jj rows as a wide stack pair, Sigma_{j+1,j} rows
    (the last is the right-edge block) as a wide stack pair, u0_final and
    u1_final as wide pairs).  float32 or float64.

    CUDA tensors launch ``csrc/wide_backward.cu``
    (``backward_solve_takahashi_wide_cuda.launches``); CPU tensors run
    `backward_solve_takahashi_wide_plain`.
    """
    name = "backward_solve_takahashi_wide_cuda"
    args = (hc11, hcst, hw011, hw0st, hw, pinv11, pinvst, hw1_11, hw1_st,
            xb, xb_next, *p00, *p01, *p10, *p11)
    _build.check_no_grad(name, *args)
    sm1, c = hc11.shape[0], hc11.shape[-1]
    e = hcst.shape[1] // 3
    check_wide(e, name)
    d = 8 + e
    m11, mst = (8, 8, c), (3 * e, 8, c)
    s11, sst = (sm1,) + m11, (sm1,) + mst
    keys = ("hc11", "hcst", "hw011", "hw0st", "hw", "pinv11", "pinvst",
            "hw1_11", "hw1_st", "xb", "xb_next", "p00_11", "p00_st",
            "p01_11", "p01_st", "p10_11", "p10_st", "p11_11", "p11_st")
    shapes = (s11, sst, s11, sst, (sm1, d, c), s11, sst, m11, mst, (d, c),
              (d, c)) + (m11, mst) * 4
    for key, t, shape in zip(keys, args, shapes):
        _build.check_shape(name, key, t, shape)
    if not hc11.is_cuda:
        return backward_solve_takahashi_wide_plain(
            *args[:11], p00, p01, p10, p11)
    _build.check_tensors(name, (torch.float32, torch.float64),
                         **dict(zip(keys, args)))
    outs = [hc11.new_empty(shape)
            for shape in ((sm1, d, c), s11, sst, s11, sst, m11, mst, m11,
                          mst)]
    with torch.cuda.device(hc11.device):
        _launch(name, "cgt_wide_backward", hc11.dtype, *args, sm1 + 1, e, c,
                *outs)
    backward_solve_takahashi_wide_cuda.launches += 1
    x, dg11, dgst, of11, ofst, u011, u0st, u111, u1st = outs
    return x, (dg11, dgst), (of11, ofst), (u011, u0st), (u111, u1st)


backward_solve_takahashi_wide_cuda.launches = 0
