"""The celerite family's kernels as hand-written CUDA, with plain twins.

Counterpart of ``cyclic_gps_tpu/ops/celerite_pallas.py``.  The wrappers
launch ``csrc/celerite_sweep.cu``, ``csrc/celerite_filter.cu`` and
``csrc/celerite_adjoint.cu``:

* `celerite_gap_mahal_sweep_cuda` replaces celerite_pallas.py:285
  celerite_gap_mahal_sweep_pallas: closed-form 2x2 gap terms built and
  eliminated in place (the celerite twin of
  ``expm_cuda.gap_mahal_sweep_cuda``);
* `celerite_filter_cuda` replaces celerite_pallas.py:479
  celerite_filter_sweep_pallas: the chunk-parallel conditional Kalman
  filter's per-chunk statistics;
* `celerite_filter_collect_cuda` replaces celerite_pallas.py:592
  celerite_filter_collect_sweep_pallas: the same, also writing the
  per-step pre-update state (run by the backward only);
* `celerite_filter_adjoint_cuda` replaces celerite_pallas.py:813
  celerite_filter_adjoint_pallas: the descending analytic adjoint.

Each wrapper launches its kernel for CUDA tensors (float32; nblocks
1..8, obs_dim 1 or 2 for the filters) and raises on anything else; for
CPU tensors it runs its plain twin (``*_plain``): the closed-form gap
terms of ``models/celerite.py`` assembled block-diagonally, then the
forward-sweep twin (kernel 12) or the plain conditional filter and its
analytic adjoint of ``ops/chunked_filter.py`` (kernels 13-15), with the
statistics element-major as the kernels write them.  Every raw wrapper
refuses inputs that require grad under grad mode
(`_build.check_no_grad`); ``models/celerite.py`` wires them into
``torch.autograd.Function``s.  The kernels take the true chunk count C:
no lane-tile padding goes in or comes out.
"""

from __future__ import annotations

import torch

from . import _build
from . import chunked_filter as cf
from .sweep_cuda import forward_sweep_plain

Tensor = torch.Tensor

NBLOCKS = tuple(range(1, 9))  # instantiated oscillator counts (rank 2..16)
OBS_DIMS = (1, 2)  # instantiated observation sizes of the filter kernels
# the filter adjoint (kernel 15), the fused likelihood sweep (kernel 12),
# the collecting filter (kernel 14) and the filter sweep (kernel 13) run
# one warp per chunk lane from these nblocks up (the WARP_NB of
# csrc/celerite_adjoint.cu and csrc/celerite_sweep.cu, the COLLECT_WARP_NB
# and FILTER_WARP_NB of csrc/celerite_filter.cu), one thread per lane below
WARP_NBLOCKS = 5
SWEEP_WARP_NBLOCKS = 5
COLLECT_WARP_NBLOCKS = 5
FILTER_WARP_NBLOCKS = 5


def _cel():
    # models/celerite.py holds the closed forms and imports this module
    from cyclic_gps_tpu_torch.models import celerite

    return celerite


def _gap_system(gb, boost, dt_cm, gv_cm, real_cm, wrap_em):
    """(k_cm [s, r, r, C], off_cm [s, r, r, C], lq [s, C]): the K rows and
    couplings kernel 12 builds, by the closed forms."""
    cel = _cel()
    s, c = dt_cm.shape
    r = 2 * gb.shape[0]
    off_b, dl_b, dr_b, logq1 = cel._block_gap_terms(gb, dt_cm.reshape(-1))
    gv = gv_cm.reshape(-1)

    def cm(blocks):  # [nb, 2, 2, s*C] -> masked [s, r, r, C]
        x = cel._assemble_blockdiag(blocks) * gv
        return x.reshape(r, r, s, c).permute(2, 0, 1, 3)

    d_left_prev = torch.cat([wrap_em[None], cm(dl_b)[:-1]], dim=0)
    eye = torch.eye(r, dtype=gb.dtype, device=gb.device)[None, :, :, None]
    k_cm = (eye + d_left_prev + cm(dr_b)
            + boost[None, :, :, None] * real_cm[:, None, None, :])
    return k_cm, cm(off_b), (logq1 * gv).reshape(s, c)


def celerite_gap_mahal_sweep_plain(gb: Tensor, boost: Tensor, dt_cm: Tensor,
                                   gv_cm: Tensor, real_cm: Tensor,
                                   wrap_em: Tensor, y_cm: Tensor):
    """Plain twin of kernel 12: the closed-form K system eliminated by the
    forward-sweep twin (the kernel builds exactly these rows and runs
    exactly this step)."""
    s = dt_cm.shape[0]
    k_cm, off_cm, lq = _gap_system(gb, boost, dt_cm, gv_cm, real_cm,
                                   wrap_em)
    (acc00, accy0, w0l, wl, dl, invdl, mh, ld,
     _) = forward_sweep_plain(k_cm, off_cm, y_cm)
    return (acc00, accy0, w0l, wl, dl, invdl, mh, ld, torch.sum(lq),
            k_cm[0], off_cm[s - 1])


def _filter_plain_inputs(gb, dt_cm, gv_cm, y_cm):
    """Batch-major (e, Q [s, C, r, r], y [s, C, q]) of the plain filter."""
    e_cm, q_cm = _cel()._filter_eq_cm(gb, dt_cm, gv_cm)
    return e_cm, q_cm, y_cm.permute(0, 2, 1)


def _stats_em(out: cf.ChunkFilterOut):
    """Batch-major statistics -> the kernels' element-major (H [r, r, C],
    h [r, C], c0 [C], ld [C], F [r, r, C], a [r, C], P [r, r, C])."""
    H, h, c0, ld, F, a, P = out
    em = lambda x: x.permute(1, 2, 0)  # noqa: E731
    return em(H), h.T, c0, ld, em(F), a.T, em(P)


def celerite_filter_plain(gb: Tensor, b: Tensor, lam: Tensor, dt_cm: Tensor,
                          gv_cm: Tensor, real_cm: Tensor, y_cm: Tensor):
    """Plain twin of kernel 13 (see `celerite_filter_cuda`)."""
    e_cm, q_cm, y = _filter_plain_inputs(gb, dt_cm, gv_cm, y_cm)
    return _stats_em(cf.conditional_filter_plain(e_cm, q_cm, b, lam, y,
                                                 real_cm))


def celerite_filter_collect_plain(gb: Tensor, b: Tensor, lam: Tensor,
                                  dt_cm: Tensor, gv_cm: Tensor,
                                  real_cm: Tensor, y_cm: Tensor):
    """Plain twin of kernel 14 (see `celerite_filter_collect_cuda`)."""
    e_cm, q_cm, y = _filter_plain_inputs(gb, dt_cm, gv_cm, y_cm)
    out, (a_h, F_h, P_h) = cf._collect_plain(e_cm, q_cm, b, lam, y,
                                             real_cm)
    return _stats_em(out), (a_h.permute(0, 2, 1), F_h.permute(0, 2, 3, 1),
                            P_h.permute(0, 2, 3, 1))


def _diag_blocks(x: Tensor, nb: int) -> Tensor:
    """[s, C, r, r] -> its 2x2 diagonal blocks' entries [s, nb, 4, C]
    (entry order 00, 01, 10, 11)."""
    s, c = x.shape[:2]
    blocks = [x[:, :, 2 * k:2 * k + 2, 2 * k:2 * k + 2].reshape(s, c, 4)
              for k in range(nb)]
    return torch.stack(blocks, dim=1).permute(0, 1, 3, 2)


def celerite_filter_adjoint_plain(gb: Tensor, b: Tensor, lam: Tensor,
                                  dt_cm: Tensor, gv_cm: Tensor,
                                  real_cm: Tensor, y_cm: Tensor, hists,
                                  cots):
    """Plain twin of kernel 15 (see `celerite_filter_adjoint_cuda`): the
    dense analytic adjoint, cut to the 2x2 diagonal blocks of (e, Q)."""
    nb = gb.shape[0]
    e_cm, q_cm, y = _filter_plain_inputs(gb, dt_cm, gv_cm, y_cm)
    a_h, F_h, P_h = hists
    hist = (a_h.permute(0, 2, 1), F_h.permute(0, 3, 1, 2),
            P_h.permute(0, 3, 1, 2))
    Hb, hb, c0b, ldb, Fsb, asb, Psb = cots
    bm = lambda x: x.permute(2, 0, 1)  # noqa: E731
    cots_bm = cf.ChunkFilterOut(bm(Hb), hb.T, c0b, ldb, bm(Fsb), asb.T,
                                bm(Psb))
    ebar, qbar, bbar, lambar, ybar = cf._adjoint_plain(
        e_cm, q_cm, b, lam, y, real_cm, hist, cots_bm)
    return (_diag_blocks(ebar, nb), _diag_blocks(qbar, nb),
            ybar.permute(0, 2, 1), bbar, lambar)


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------


def _check_oscillators(name: str, gb: Tensor) -> int:
    nb = gb.shape[0]
    _build.check_shape(name, "gb", gb, (nb, 2, 2))
    if nb not in NBLOCKS:
        raise ValueError(f"{name}: nblocks {nb} has no CUDA kernel "
                         f"(instantiated for {NBLOCKS[0]}..{NBLOCKS[-1]})")
    return nb


def _check_filter(name: str, gb, b, lam, dt_cm, gv_cm, real_cm, y_cm):
    """Shapes of the filter kernels' inputs; returns (nb, q, s, C)."""
    _build.check_tensors(name, (torch.float32,), gb=gb, b=b, lam=lam,
                         dt_cm=dt_cm, gv_cm=gv_cm, real_cm=real_cm,
                         y_cm=y_cm)
    nb = _check_oscillators(name, gb)
    qd = b.shape[0]
    if qd not in OBS_DIMS:
        raise ValueError(f"{name}: obs_dim {qd} has no CUDA kernel "
                         f"(instantiated for {OBS_DIMS})")
    s, c = dt_cm.shape
    for key, t, shape in (("b", b, (qd, 2 * nb)), ("lam", lam, (qd, qd)),
                          ("gv_cm", gv_cm, (s, c)),
                          ("real_cm", real_cm, (s, c)),
                          ("y_cm", y_cm, (s, qd, c))):
        _build.check_shape(name, key, t, shape)
    return nb, qd, s, c


def _stream():
    return torch.cuda.current_stream().cuda_stream


def celerite_gap_mahal_sweep_cuda(gb: Tensor, boost: Tensor, dt_cm: Tensor,
                                  gv_cm: Tensor, real_cm: Tensor,
                                  wrap_em: Tensor, y_cm: Tensor,
                                  warp: bool = False):
    """Fused celerite gaps -> forward-eliminated likelihood sweep.

    gb [nb, 2, 2]: the oscillator blocks of G (``celerite.g_blocks``);
    boost [r, r] = B^T (LL^T)^{-1} B with r = 2 nb; dt_cm/gv_cm/real_cm
    [s, C] (gap following row j of chunk c, its validity, row-observed
    mask); wrap_em [r, r, C] the chunk-crossing d_left row; y_cm
    [s, r, C] the right-hand side v (s >= 2).  Returns the tuple of
    ``expm_cuda.gap_mahal_sweep_cuda``: (acc00, accy0, w0_last, w_last,
    d_last, invd_last, mh, ld, lq_sum, k0 [r, r, C], o_last [r, r, C]).
    float32.

    CUDA tensors launch ``csrc/celerite_sweep.cu``
    (``celerite_gap_mahal_sweep_cuda.launches``): one warp per chunk lane
    at nblocks 5..8 (``.launches_warp`` counts those launches), one thread
    per lane at 1..4; ``warp=True`` takes the warp-per-lane design at every
    nblocks (to time the two).  CPU tensors run
    `celerite_gap_mahal_sweep_plain`.
    """
    name = "celerite_gap_mahal_sweep_cuda"
    args = (gb, boost, dt_cm, gv_cm, real_cm, wrap_em, y_cm)
    _build.check_no_grad(name, *args)
    if not dt_cm.is_cuda:
        return celerite_gap_mahal_sweep_plain(*args)
    _build.check_tensors(name, (torch.float32,), **dict(zip(
        ("gb", "boost", "dt_cm", "gv_cm", "real_cm", "wrap_em", "y_cm"),
        args)))
    nb = _check_oscillators(name, gb)
    r = 2 * nb
    s, c = dt_cm.shape
    for key, t, shape in (("boost", boost, (r, r)), ("gv_cm", gv_cm, (s, c)),
                          ("real_cm", real_cm, (s, c)),
                          ("wrap_em", wrap_em, (r, r, c)),
                          ("y_cm", y_cm, (s, r, c))):
        _build.check_shape(name, key, t, shape)
    if s < 2:
        raise ValueError(f"{name}: chunk length {s} < 2")
    outs = [dt_cm.new_empty(shape) for shape in
            [(r, r, c), (r, c), (r, r, c), (r, c), (r, r, c), (r, c),
             (c,), (c,), (c,), (r, r, c), (r, r, c)]]
    lib = _build.load()
    with torch.cuda.device(dt_cm.device):
        entry = (lib.cgt_celerite_gap_mahal_sweep_warp_f32 if warp
                 else lib.cgt_celerite_gap_mahal_sweep_f32)
        err = entry(*[a.data_ptr() for a in args], nb, s, c,
                    *[o.data_ptr() for o in outs], _stream())
    _build.check_launch(err, name)
    celerite_gap_mahal_sweep_cuda.launches += 1
    if warp or nb >= SWEEP_WARP_NBLOCKS:
        celerite_gap_mahal_sweep_cuda.launches_warp += 1
    acc00, accy0, w0l, wl, dl, invdl, mh, ld, lq, k0, olast = outs
    return (acc00, accy0, w0l, wl, dl, invdl, torch.sum(mh), torch.sum(ld),
            torch.sum(lq), k0, olast)


celerite_gap_mahal_sweep_cuda.launches = 0
celerite_gap_mahal_sweep_cuda.launches_warp = 0


def _launch_filter(name, args, collect: bool, warp: bool):
    """Launch kernel 13 (``collect=False``) or kernel 14, one warp per
    chunk lane where ``warp``; returns (statistics, histories)."""
    nb, qd, s, c = _check_filter(name, *args)
    r = 2 * nb
    y_cm = args[-1]
    stats = [y_cm.new_empty(shape) for shape in
             [(r, r, c), (r, c), (c,), (c,), (r, r, c), (r, c), (r, r, c)]]
    hists = ([y_cm.new_empty(shape) for shape in
              [(s, r, c), (s, r, r, c), (s, r, r, c)]] if collect else [])
    lib = _build.load()
    ptrs = [a.data_ptr() for a in (*args, *stats, *hists)]
    with torch.cuda.device(y_cm.device):
        if collect:
            err = lib.cgt_celerite_filter_collect_f32(
                *ptrs[:7], nb, qd, s, c, *ptrs[7:], int(warp), _stream())
        else:
            err = lib.cgt_celerite_filter_f32(*ptrs[:7], nb, qd, s, c,
                                              *ptrs[7:], int(warp),
                                              _stream())
    _build.check_launch(err, name)
    return tuple(stats), tuple(hists)


def celerite_filter_cuda(gb: Tensor, b: Tensor, lam: Tensor, dt_cm: Tensor,
                         gv_cm: Tensor, real_cm: Tensor, y_cm: Tensor,
                         warp: bool = False):
    """Fused conditional-filter sweep: per-chunk statistics of the
    O(N r^2 q) celerite solve.

    gb [nb, 2, 2] oscillator blocks; b [q, r], lam [q, q] the observation
    model (lam = Lambda Lambda^T); dt_cm/gv_cm/real_cm [s, C]; y_cm
    [s, q, C] observations.  Returns the statistics element-major --
    (H [r, r, C], h [r, C], c0 [C], ld_s [C], F [r, r, C], a [r, C],
    P [r, r, C]) -- as ``chunked_filter.boundary_loglik_em`` takes them.
    float32, nblocks 1..8, q 1 or 2.

    CUDA tensors launch ``csrc/celerite_filter.cu``
    (``celerite_filter_cuda.launches``): one warp per chunk lane from
    nblocks `FILTER_WARP_NBLOCKS` up (``.launches_warp`` counts those
    launches), one thread per lane below; ``warp=True`` takes the
    warp-per-lane design at every nblocks (to time the two).  CPU tensors
    run `celerite_filter_plain`.
    """
    name = "celerite_filter_cuda"
    args = (gb, b, lam, dt_cm, gv_cm, real_cm, y_cm)
    _build.check_no_grad(name, *args)
    if not dt_cm.is_cuda:
        return celerite_filter_plain(*args)
    warp = warp or gb.shape[0] >= FILTER_WARP_NBLOCKS
    stats, _ = _launch_filter(name, args, collect=False, warp=warp)
    celerite_filter_cuda.launches += 1
    if warp:
        celerite_filter_cuda.launches_warp += 1
    return stats


celerite_filter_cuda.launches = 0
celerite_filter_cuda.launches_warp = 0


def celerite_filter_collect_cuda(gb: Tensor, b: Tensor, lam: Tensor,
                                 dt_cm: Tensor, gv_cm: Tensor,
                                 real_cm: Tensor, y_cm: Tensor,
                                 warp: bool = False):
    """`celerite_filter_cuda` that also writes the per-step pre-update
    state: returns (statistics, (a_h [s, r, C], F_h [s, r, r, C], P_h
    [s, r, r, C])), step j's state before its update at [j].  The
    residual stream of `celerite_filter_adjoint_cuda` (2 r^2 + r floats
    per step); the backward runs it, a forward-only call never does.

    CUDA tensors launch ``csrc/celerite_filter.cu``
    (``celerite_filter_collect_cuda.launches``): one warp per chunk lane
    at nblocks 5..8 (``.launches_warp`` counts those launches), one thread
    per lane at 1..4; ``warp=True`` takes the warp-per-lane design at every
    nblocks (to time the two).  CPU tensors run
    `celerite_filter_collect_plain`.
    """
    name = "celerite_filter_collect_cuda"
    args = (gb, b, lam, dt_cm, gv_cm, real_cm, y_cm)
    _build.check_no_grad(name, *args)
    if not dt_cm.is_cuda:
        return celerite_filter_collect_plain(*args)
    warp = warp or gb.shape[0] >= COLLECT_WARP_NBLOCKS
    stats, hists = _launch_filter(name, args, collect=True, warp=warp)
    celerite_filter_collect_cuda.launches += 1
    if warp:
        celerite_filter_collect_cuda.launches_warp += 1
    return stats, hists


celerite_filter_collect_cuda.launches = 0
celerite_filter_collect_cuda.launches_warp = 0


def celerite_filter_adjoint_cuda(gb: Tensor, b: Tensor, lam: Tensor,
                                 dt_cm: Tensor, gv_cm: Tensor,
                                 real_cm: Tensor, y_cm: Tensor, hists,
                                 cots, warp: bool = False):
    """Analytic adjoint of the conditional-filter sweep.

    Inputs as `celerite_filter_cuda`, plus ``hists`` = (a_h, F_h, P_h)
    from `celerite_filter_collect_cuda` and ``cots`` the element-major
    cotangents of its seven statistics.  Returns (ebar [s, nb, 4, C],
    qbar [s, nb, 4, C], ybar [s, q, C], bbar [q, r], lambar [q, q]): the
    cotangents of each gap's 2x2 diagonal blocks of e and Q (entry order
    00, 01, 10, 11), of y, B and Lambda Lambda^T.  bbar and lambar are
    summed here from per-lane partials in a fixed order (no atomics).

    CUDA tensors launch ``csrc/celerite_adjoint.cu``
    (``celerite_filter_adjoint_cuda.launches``): one warp per chunk lane
    at nblocks 5..8 (``.launches_warp`` counts those launches), one
    thread per lane at 1..4, where it is the faster design; ``warp=True``
    takes the warp-per-lane design at every nblocks (to time the two).
    CPU tensors run `celerite_filter_adjoint_plain`.
    """
    name = "celerite_filter_adjoint_cuda"
    args = (gb, b, lam, dt_cm, gv_cm, real_cm, y_cm)
    _build.check_no_grad(name, *args, *hists, *cots)
    if not dt_cm.is_cuda:
        return celerite_filter_adjoint_plain(*args, hists, cots)
    nb, qd, s, c = _check_filter(name, *args)
    r = 2 * nb
    hist_keys = ("a_h", "F_h", "P_h")
    cot_keys = ("H_bar", "h_bar", "c0_bar", "ld_bar", "F_bar", "a_bar",
                "P_bar")
    _build.check_tensors(name, (torch.float32,), y_cm=y_cm,
                         **dict(zip(hist_keys + cot_keys, (*hists, *cots))))
    for key, t, shape in zip(hist_keys + cot_keys, (*hists, *cots),
                             ((s, r, c), (s, r, r, c), (s, r, r, c),
                              (r, r, c), (r, c), (c,), (c,), (r, r, c),
                              (r, c), (r, r, c))):
        _build.check_shape(name, key, t, shape)
    outs = [y_cm.new_empty(shape) for shape in
            [(s, nb, 4, c), (s, nb, 4, c), (s, qd, c), (qd * r, c),
             (qd * qd, c)]]
    lib = _build.load()
    with torch.cuda.device(y_cm.device):
        entry = (lib.cgt_celerite_filter_adjoint_warp_f32 if warp
                 else lib.cgt_celerite_filter_adjoint_f32)
        err = entry(
            *[a.data_ptr() for a in (*args, *hists, *cots)], nb, qd, s, c,
            *[o.data_ptr() for o in outs], _stream())
    _build.check_launch(err, name)
    celerite_filter_adjoint_cuda.launches += 1
    if warp or nb >= WARP_NBLOCKS:
        celerite_filter_adjoint_cuda.launches_warp += 1
    ebar, qbar, ybar, b_part, l_part = outs
    return (ebar, qbar, ybar, torch.sum(b_part, dim=1).reshape(qd, r),
            torch.sum(l_part, dim=1).reshape(qd, qd))


celerite_filter_adjoint_cuda.launches = 0
celerite_filter_adjoint_cuda.launches_warp = 0
