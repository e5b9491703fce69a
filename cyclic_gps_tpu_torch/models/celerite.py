"""Celerite-structured LEG family (PyTorch).

Counterpart of ``cyclic_gps_tpu/models/celerite.py``.  With rank =
2 * nblocks the generator is constrained to celerite structure:

  N: diagonal entries plus the subdiagonal entries (2k+1, 2k),
  R: only the subdiagonal entries (2k+1, 2k),

so G = N N^T + R - R^T (+ eps I) is block-diagonal with 2x2 blocks --
each block a damped oscillator, the celerite kernel class.  The
parameter count drops from O(rank^2) to O(nblocks).

Every 2x2 gap term has a closed form (`_block_e_terms`), so the family
has two fast likelihood routes and never forms a matrix exponential:

* `log_likelihood`: the closed-form precision blocks into the
  partitioned engine.  float32 on the card runs the fused sweep kernel
  (ops/celerite_cuda, kernel 12 of ROADMAP Queue 2), which builds each
  row's blocks from its gap width and eliminates them in place; its
  backward replays the closed-form K through the engine's analytic
  adjoint.
* `log_likelihood_filter` (the training route of `nll_loss`): the
  chunk-parallel conditional Kalman filter (ops/chunked_filter), O(N r^2
  q).  float32 on the card runs the filter kernel forward (13) and the
  collect (14) + analytic adjoint (15) kernels backward; the per-block
  cotangents are chained through the closed forms by autograd.

Both finish on the partitioned engine at block size r = 2 * nblocks.
The filter route's boundary chain calls the natural-layout
`partitioned.mahal_and_logdet`, which on the card runs the plain sweep
kernels at r <= 8 and r = 16 and the wide-layout kernels (16, 21, 22 of
ROADMAP Queue 2) at r = 10, 12, 14: `log_likelihood_filter` and
`nll_loss`'s default method train on the card at every nblocks 1..8.  The
precision route's reduced ladder and its replayed backward run the plain
sweep kernels on chunk-major blocks, which have no instance at r = 10-14:
on the card `log_likelihood` takes nblocks 1..4 and 8 and raises at 5..7.
Small N, and everything else the LEG family offers (predictions,
posteriors), runs through `expand`, which maps the structured parameters
to a `leg.LEGView` whose gradients flow back to them.  The dense LEG
emission kernels stop at rank 8 (the posterior's solve and selected
inversion take 1..15), so those calls run on the card at nblocks <= 4.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from cyclic_gps_tpu_torch import resolve_device
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import chunked_filter as cf
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import smallblock as sb
from cyclic_gps_tpu_torch.ops.celerite_cuda import (
    celerite_filter_adjoint_cuda, celerite_filter_collect_cuda,
    celerite_filter_cuda, celerite_gap_mahal_sweep_cuda)

Tensor = torch.Tensor


class CeleriteParams(nn.Module):
    """Structured parameters, rank = 2 * nblocks.

    n_diag:  [rank]     diagonal of N
    n_sub:   [nblocks]  N[2k+1, 2k]
    r_sub:   [nblocks]  R[2k+1, 2k] (antisymmetrised by g_matrix)
    lambda_params: [obs*(obs+1)/2] packed lower-tri (softplus on read)
    b:       [obs_dim, rank]
    """

    def __init__(self, n_diag: Tensor, n_sub: Tensor, r_sub: Tensor,
                 lambda_params: Tensor, b: Tensor):
        super().__init__()
        self.n_diag = nn.Parameter(n_diag)
        self.n_sub = nn.Parameter(n_sub)
        self.r_sub = nn.Parameter(r_sub)
        self.lambda_params = nn.Parameter(lambda_params)
        self.b = nn.Parameter(b)

    @property
    def nblocks(self) -> int:
        return self.n_sub.shape[0]

    @property
    def rank(self) -> int:
        return self.b.shape[1]

    @property
    def obs_dim(self) -> int:
        return self.b.shape[0]


def parameter_count(nblocks: int, obs_dim: int) -> int:
    """rank (N diagonal) + nblocks (N subdiagonal) + nblocks (R) + obs
    tril + B (reference psize, models.py:570-575, with the structured
    N/R masks)."""
    rank = 2 * nblocks
    return (rank + nblocks + nblocks + obs_dim * (obs_dim + 1) // 2
            + obs_dim * rank)


def init_params(
    nblocks: int,
    obs_dim: int,
    prior_process_noise_level: float = 1.0,
    prior_length_scale: float = 0.2,
    generator: torch.Generator = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> CeleriteParams:
    """Initial guess mirroring the reference sketch (models.py:577-583):
    N = noise_level * I (structured entries), R subdiagonal standard
    normal from ``generator`` times length_scale, Lambda = 0.1 I, B = 0.5
    ones / row norm.  ``generator`` takes the place of the JAX key (the
    draws differ).  On the card unless ``device`` says otherwise."""
    rank = 2 * nblocks
    n_diag = torch.full((rank,), prior_process_noise_level, dtype=dtype)
    n_sub = torch.zeros((nblocks,), dtype=dtype)
    r_sub = torch.randn((nblocks,), generator=generator,
                        dtype=dtype) * prior_length_scale
    lam = 0.1 * torch.eye(obs_dim, dtype=dtype)
    ti = leg.tril_indices(obs_dim)
    lambda_params = lam[ti[0], ti[1]]
    b = torch.ones((obs_dim, rank), dtype=dtype)
    b = 0.5 * b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True))
    return CeleriteParams(n_diag, n_sub, r_sub, lambda_params, b).to(
        resolve_device(device))


def _sub_positions(nblocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col indices of the structured subdiagonal entries
    (2k+1, 2k)."""
    rows = 2 * np.arange(nblocks) + 1
    return rows, rows - 1


def expand(params: CeleriteParams) -> leg.LEGView:
    """Structured -> full LEG parameters (packed tril layout) as a
    `leg.LEGView`: the masked-out positions are exact zeros, and
    gradients of any LEG function flow back through this map to the
    structured parameters."""
    rank, nb = params.rank, params.nblocks
    dev = params.n_diag.device
    rows, cols = (torch.as_tensor(i, device=dev)
                  for i in _sub_positions(nb))
    n_full = torch.diag(params.n_diag).index_put((rows, cols), params.n_sub)
    r_full = params.r_sub.new_zeros((rank, rank)).index_put((rows, cols),
                                                            params.r_sub)
    ti = leg.tril_indices(rank, 0, device=dev)
    tl = leg.tril_indices(rank, -1, device=dev)
    return leg.LEGView(n_full[ti[0], ti[1]], r_full[tl[0], tl[1]],
                       params.lambda_params, params.b)


# ---------------------------------------------------------------------------
# Closed forms: with A = -d G_k / 2 = mu I + Delta, tr Delta = 0,
#
#   expm(A) = e^mu (cosh(w) I + sinh(w)/w Delta),   w = sqrt(q2),
#   q2 = Delta_00^2 + Delta_01 Delta_10        (its sign selects cosh/cos),
#
# evaluated cancellation-free: E = expm(A) - I from expm1-style pieces, so
# Q1 = -(E + E^T + E E^T) is exact at working precision at any gap.
# ---------------------------------------------------------------------------

_SERIES_CUT = 0.29  # |w| below which the signed-q2 series is exact to f32


def g_blocks(params: CeleriteParams) -> Tensor:
    """The 2x2 diagonal blocks of G = N N^T + R - R^T + eps I as
    [nblocks, 2, 2]."""
    n1 = params.n_diag[0::2]
    n2 = params.n_diag[1::2]
    ns, rs = params.n_sub, params.r_sub
    eps = leg.G_DIAG_EPS
    g00 = n1 * n1 + eps
    g01 = n1 * ns - rs
    g10 = n1 * ns + rs
    g11 = ns * ns + n2 * n2 + eps
    return torch.stack([torch.stack([g00, g01], -1),
                        torch.stack([g10, g11], -1)], -2)


def _block_e_terms(gb: Tensor, diffs: Tensor):
    """Per-block, per-gap closed-form (ecm1, esnc, alpha, beta, gamma):
    E = expm(-d G_k / 2) - I = ecm1 I + esnc Delta, Delta = [[alpha,
    beta], [gamma, -alpha]].  All [nb, M].

    Branches on q2 = alpha^2 + beta gamma, with every input sanitised so
    each branch is finite and has finite gradients (a masked-out inf
    still NaNs the backward of `torch.where`):
      |q2| small : the unified signed-q2 series for cosh-1 / sinhc
      q2 >= cut  : hyperbolic, (expm1(mu+w) +/- expm1(mu-w)) / 2
      q2 <= -cut : trigonometric (damped oscillation)
    """
    d = diffs[None, :]
    g00 = gb[:, 0, 0][:, None]
    g01 = gb[:, 0, 1][:, None]
    g10 = gb[:, 1, 0][:, None]
    g11 = gb[:, 1, 1][:, None]

    mu = -d * (g00 + g11) / 4.0
    alpha = -d * (g00 - g11) / 4.0
    beta = -d * g01 / 2.0
    gamma = -d * g10 / 2.0
    q2 = alpha * alpha + beta * gamma
    em1_mu = torch.expm1(mu)
    cut2 = _SERIES_CUT**2
    hyper = q2 >= cut2
    trig = q2 <= -cut2
    # sqrt only where a branch consumes it: d(sqrt)/dq2 -> inf at q2 = 0
    w = torch.sqrt(torch.where(hyper | trig, torch.abs(q2),
                               torch.full_like(q2, cut2)))

    zero = torch.zeros_like(w)
    w_h = torch.where(hyper, w, zero)
    ep = torch.expm1(mu + w_h)
    em = torch.expm1(mu - w_h)
    ecm1_h = 0.5 * (ep + em)
    esnc_h = (ep - em) / (2.0 * torch.clamp(w_h, min=_SERIES_CUT))

    w_t = torch.where(trig, w, zero)
    cw = torch.cos(w_t)
    ecm1_t = em1_mu * cw + (cw - 1.0)
    esnc_t = (1.0 + em1_mu) * torch.sin(w_t) / torch.clamp(
        w_t, min=_SERIES_CUT)

    q2_s = torch.clamp(q2, -cut2, cut2)
    cm1_s = q2_s * (
        1.0 / 2.0 + q2_s * (
            1.0 / 24.0 + q2_s * (
                1.0 / 720.0 + q2_s * (
                    1.0 / 40320.0 + q2_s * (
                        1.0 / 3628800.0 + q2_s / 479001600.0)))))
    snc_s = 1.0 + q2_s * (
        1.0 / 6.0 + q2_s * (
            1.0 / 120.0 + q2_s * (
                1.0 / 5040.0 + q2_s * (
                    1.0 / 362880.0 + q2_s / 39916800.0))))
    ecm1_s = em1_mu * (1.0 + cm1_s) + cm1_s
    esnc_s = (1.0 + em1_mu) * snc_s

    ecm1 = torch.where(hyper, ecm1_h, torch.where(trig, ecm1_t, ecm1_s))
    esnc = torch.where(hyper, esnc_h, torch.where(trig, esnc_t, esnc_s))
    return ecm1, esnc, alpha, beta, gamma


def _block_eq_terms(gb: Tensor, diffs: Tensor):
    """Closed-form per-block (E = e - I, Q = I - e e^T) entries, each
    [nb, M]: ((E00, E01, E10, E11), (Q00, Q01, Q11)).  Q is -(E + E^T +
    E E^T), exact at working precision for any gap; no inverse appears,
    so dt = 0 (masked gaps) degenerates to (I, 0)."""
    ecm1, esnc, al, be, ga = _block_e_terms(gb, diffs)
    e00_m1 = ecm1 + esnc * al
    e01 = esnc * be
    e10 = esnc * ga
    e11_m1 = ecm1 - esnc * al
    q00 = -(2.0 * e00_m1 + e00_m1 * e00_m1 + e01 * e01)
    q11 = -(2.0 * e11_m1 + e11_m1 * e11_m1 + e10 * e10)
    q01 = -(e01 + e10 + e00_m1 * e10 + e01 * e11_m1)
    return (e00_m1, e01, e10, e11_m1), (q00, q01, q11)


def _m22(a, b, c, d):
    """Four [nb, M] entries -> [nb, 2, 2, M] blocks."""
    return torch.stack([torch.stack([a, b], -2), torch.stack([c, d], -2)],
                       -3)


def _block_gap_terms(gb: Tensor, diffs: Tensor):
    """Closed-form per-block `leg._q1_terms`: (off, d_left, d_right
    [nb, 2, 2, M], logq1 [M]) from 2x2 scalar algebra (adjugate
    inverses, exact 2x2 determinants)."""
    (e00_m1, e01, e10, e11_m1), (q00, q01, q11) = _block_eq_terms(gb,
                                                                  diffs)
    e00 = 1.0 + e00_m1
    e11 = 1.0 + e11_m1
    det = q00 * q11 - q01 * q01
    inv_det = 1.0 / det
    i00 = q11 * inv_det
    i01 = -q01 * inv_det
    i11 = q00 * inv_det
    # off = -Q1^{-1} e
    o00 = -(i00 * e00 + i01 * e10)
    o01 = -(i00 * e01 + i01 * e11)
    o10 = -(i01 * e00 + i11 * e10)
    o11 = -(i01 * e01 + i11 * e11)
    # d_left = Q1^{-1} - I (push-through identity, leg._q1_terms)
    dl00 = i00 - 1.0
    dl11 = i11 - 1.0
    # d_right = e^T Q1^{-1} e = -e^T off
    dr00 = -(e00 * o00 + e10 * o10)
    dr01 = -(e00 * o01 + e10 * o11)
    dr10 = -(e01 * o00 + e11 * o10)
    dr11 = -(e01 * o01 + e11 * o11)
    drs = 0.5 * (dr01 + dr10)
    return (_m22(o00, o01, o10, o11), _m22(dl00, i01, i01, dl11),
            _m22(dr00, drs, drs, dr11), torch.sum(torch.log(det), dim=0))


def _assemble_blockdiag(blocks: Tensor) -> Tensor:
    """[nb, 2, 2, M] oscillator blocks -> dense block-diagonal
    [2 nb, 2 nb, M] element-major."""
    nb, _, _, m = blocks.shape
    cols = [torch.cat([blocks.new_zeros((2, 2 * k, m)), blocks[k],
                       blocks.new_zeros((2, 2 * (nb - k - 1), m))], dim=1)
            for k in range(nb)]
    return torch.cat(cols, dim=0)


def gap_terms_from_blocks(gb: Tensor):
    """`leg._gap_terms_dense`-compatible closure on the oscillator blocks
    gb [nb, 2, 2]: diffs [M] -> (off1, d_left, d_right [r, r, M]
    element-major block-diagonal, log|Q1| per gap [M]) via the closed
    forms.  Differentiable in gb by autograd, which is how the fused
    kernel's backward replay reaches the structured parameters."""

    def fn(diffs):
        off_b, dl_b, dr_b, logq1 = _block_gap_terms(gb, diffs)
        return (_assemble_blockdiag(off_b), _assemble_blockdiag(dl_b),
                _assemble_blockdiag(dr_b), logq1)

    return fn


def gap_terms(params: CeleriteParams):
    """`gap_terms_from_blocks` on the parameters' oscillator blocks."""
    return gap_terms_from_blocks(g_blocks(params))


# ---------------------------------------------------------------------------
# The precision route: fused kernel forward, closed-form replay backward.
# ---------------------------------------------------------------------------


def _wrap_row(gb: Tensor, diffs: Tensor, gap_valid: Tensor, s: int):
    """The chunk-crossing d_left row: gap c*s - 1 feeds row 0 of chunk c.
    Closed form on the C boundary gaps, valid-masked, then shifted one
    lane right with zeros into chunk 0 ([r, r, C])."""
    _, dl_b, _, _ = _block_gap_terms(gb, diffs[s - 1])
    dl_w = _assemble_blockdiag(dl_b) * gap_valid[s - 1][None, None, :]
    return torch.cat([dl_w.new_zeros(dl_w.shape[:2] + (1,)), dl_w[:, :, :-1]],
                     dim=-1).contiguous()


class _CelGapMahalFused(torch.autograd.Function):
    """(v^T K^{-1} v, log|K|, log|Sigma^{-1}|) straight from the gap
    widths: kernel 12 builds and eliminates every chunk interior row, the
    reduced boundary system finishes on the partitioned ladder (block
    size r = 2 nblocks).  ``v_cm`` [s, r, C] at the true chunk count.
    CPU tensors run the kernel's plain twin.

    Backward (the JAX ``_cel_gap_mahal_fused_bwd``): replay the
    closed-form K emission and ``partitioned.mahal_and_logdet_cm`` (the
    engine's analytic adjoint) by autograd."""

    @staticmethod
    def forward(ctx, gb, boost, ts, v_cm, s):
        n = ts.shape[0]
        c = -(-n // s)
        diffs, gap_valid, is_real = leg._chunk_gap_geometry(ts, s, n, c,
                                                            gb.dtype)
        wrap = _wrap_row(gb, diffs, gap_valid, s)
        (acc00, accy0, w0l, wl, dl, invdl, mh, ld, lq_sum, k0,
         olast) = celerite_gap_mahal_sweep_cuda(
            gb.contiguous(), boost.contiguous(), diffs, gap_valid, is_real,
            wrap, v_cm)
        state = pt._SweepState(None, w0l, wl, dl, invdl, acc00, accy0, mh,
                               ld)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(olast))
        red_diag, red_off, red_rhs = pt._reduced_system(k0[None], v_cm[:1],
                                                        state, w1)
        red_mh, red_ld = pt._mahal_and_logdet_impl(
            sb.from_em(red_diag), sb.from_em(red_off)[: c - 1],
            sb.vec_from_em(red_rhs), None, 0.0,
            pt.resolve_backend("auto", v_cm))
        ctx.s = s
        ctx.save_for_backward(gb, boost, ts, v_cm)
        return mh + red_mh, 2.0 * ld + red_ld, -lq_sum

    @staticmethod
    def backward(ctx, *cots):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            gb, boost, ts, v_cm = ins
            rank = 2 * gb.shape[0]
            k_cm, off_cm, lq_cm = leg._k_gap_parts_plain(
                None, boost, ts, ctx.s, False, rank, boost.dtype, "auto",
                gap_terms_from_blocks(gb))
            mh, ld = pt.mahal_and_logdet_cm(k_cm, off_cm, v_cm,
                                            backend="auto")
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(
                (mh, ld, -torch.sum(lq_cm)), wanted, cots,
                allow_unused=True))
        return tuple(next(grads) if need else None for need in needs) + (
            None,)


def _small(num_obs: int, s: int) -> bool:
    """Below the chunked threshold both routes fall back to `expand` and
    the LEG likelihood."""
    return num_obs < max(pt._TERMINAL, 2 * s)


@leg._highest_precision
def log_likelihood(params: CeleriteParams, ts: Tensor, xs: Tensor,
                   regular: bool = False, backend: str = "auto") -> Tensor:
    """Marginal log-likelihood under the celerite structure.

    Large N at float32 on the card (``backend`` "auto" or "cuda") runs
    the fused sweep kernel (`_CelGapMahalFused`); large N elsewhere, and
    ``backend="torch"``, emits the closed-form gap terms into the
    partitioned engine's chunk-major system.  Small N falls back to
    `expand` + ``leg.log_likelihood``, the parity oracle."""
    num_obs = ts.shape[0]
    s = pt.default_chunk_len(num_obs)
    if _small(num_obs, s):
        return leg.log_likelihood(expand(params), ts, xs, regular=regular,
                                  backend=backend)
    llt = leg.lambda_lambda_t(params)
    x_llt_inv = torch.linalg.solve(llt, xs.T).T
    llt_mahal = torch.sum(x_llt_inv * xs)
    llt_logdet = num_obs * torch.linalg.slogdet(2.0 * math.pi * llt)[1]
    if (params.n_diag.dtype == torch.float32
            and pt.resolve_backend(backend, llt) == "cuda"):
        c = -(-num_obs // s)
        boost = params.b.T @ torch.linalg.solve(llt, params.b)
        v_cm = leg._v_chunk_major(params, xs, llt, s, c, llt.dtype)
        k_mahal, k_logdet, sig_inv_logdet = _CelGapMahalFused.apply(
            g_blocks(params), boost, ts, v_cm, s)
    else:
        k_cm, o_cm, v_cm, sig_inv_logdet = leg._k_system_chunked(
            params, ts, xs, s, regular, backend, gap_fn=gap_terms(params))
        k_mahal, k_logdet = pt.mahal_and_logdet_cm(k_cm, o_cm, v_cm,
                                                   backend=backend)
    mahal = llt_mahal - k_mahal
    logdet = llt_logdet + k_logdet - sig_inv_logdet
    return -0.5 * (mahal + logdet)


# ---------------------------------------------------------------------------
# The conditional-filter route: O(N r^2 q), the training route.
# ---------------------------------------------------------------------------


def _filter_eq_cm(gb: Tensor, diffs: Tensor, gap_valid: Tensor):
    """Chunk-major batch-major (e, Q) [s, C, r, r] of the conditional
    filter from the gap geometry [s, C]: block-diagonal closed forms,
    masked gaps exactly (I, 0)."""
    s, c = diffs.shape
    rank = 2 * gb.shape[0]
    (e00m, e01, e10, e11m), (q00, q01, q11) = _block_eq_terms(
        gb, diffs.reshape(-1))
    gv = gap_valid.reshape(-1)[None, None, None, :]

    def cm(x_em):  # [r, r, s*C] -> [s, C, r, r]
        return x_em.reshape(rank, rank, s, c).permute(2, 3, 0, 1)

    eye = torch.eye(rank, dtype=gb.dtype, device=gb.device)
    e_cm = cm(_assemble_blockdiag(_m22(e00m, e01, e10, e11m) * gv)) + eye
    q_cm = cm(_assemble_blockdiag(_m22(q00, q01, q01, q11) * gv))
    return e_cm, q_cm


def _y_chunk_major(xs: Tensor, s: int, c: int) -> Tensor:
    """Observations [n, q] -> [s, q, C] (natural row c*s + j at [j, :, c],
    zero padding)."""
    n, qd = xs.shape
    xs_pad = torch.cat([xs, xs.new_zeros((c * s - n, qd))], dim=0)
    return xs_pad.reshape(c, s, qd).permute(1, 2, 0).contiguous()


def _filter_inputs(params: CeleriteParams, ts: Tensor, xs: Tensor, s: int):
    """Chunk-major (e, Q, y, valid) inputs of the plain conditional
    filter: e/q [s, C, r, r], y [s, C, q], valid [s, C]."""
    gb = g_blocks(params)
    n = ts.shape[0]
    c = -(-n // s)
    diffs, gap_valid, is_real = leg._chunk_gap_geometry(ts, s, n, c,
                                                        gb.dtype)
    e_cm, q_cm = _filter_eq_cm(gb, diffs, gap_valid)
    return e_cm, q_cm, _y_chunk_major(xs, s, c).permute(0, 2, 1), is_real


class _CelFilter(torch.autograd.Function):
    """The conditional filter's per-chunk statistics, element-major
    (H, h, c0, ld, F, a, P), by kernel 13.  CPU tensors run the kernels'
    plain twins.

    Backward (the JAX ``_cel_filter_pallas_bwd``): kernel 14 re-runs the
    filter storing the per-step pre-update state, kernel 15 runs the
    descending analytic adjoint and emits cotangents of the 2x2 diagonal
    blocks of (e, Q) per gap, and those are chained through the closed
    forms and the gap geometry to (gb, ts) by autograd (e = I + gv E,
    q = gv Q1: the constant I drops out; Q's 01 and 10 entries are one
    value)."""

    @staticmethod
    def forward(ctx, gb, b, lam, ts, xs, s):
        n = ts.shape[0]
        c = -(-n // s)
        diffs, gap_valid, is_real = leg._chunk_gap_geometry(ts, s, n, c,
                                                            gb.dtype)
        y_cm = _y_chunk_major(xs, s, c)
        args = (gb.contiguous(), b.contiguous(), lam.contiguous(), diffs,
                gap_valid, is_real, y_cm)
        ctx.s = s
        ctx.save_for_backward(ts, *args)
        return celerite_filter_cuda(*args)

    @staticmethod
    def backward(ctx, *cots):
        s = ctx.s
        ts, *args = ctx.saved_tensors
        gb = args[0]
        nb = gb.shape[0]
        n = ts.shape[0]
        qd = args[1].shape[0]
        c = args[3].shape[1]
        _, hists = celerite_filter_collect_cuda(*args)
        ebar, qbar, ybar, bbar, lambar = celerite_filter_adjoint_cuda(
            *args, hists, tuple(t.contiguous() for t in cots))
        del hists

        def blk(x, i):  # [s, nb, 4, C] entry i -> [nb, s*C] (j-major)
            return x[:, :, i, :].permute(1, 0, 2).reshape(nb, -1)

        cot_streams = (blk(ebar, 0), blk(ebar, 1), blk(ebar, 2),
                       blk(ebar, 3), blk(qbar, 0),
                       blk(qbar, 1) + blk(qbar, 2), blk(qbar, 3))
        with torch.enable_grad():
            gb_ = gb.detach().requires_grad_()
            ts_ = ts.detach().requires_grad_(ctx.needs_input_grad[3])
            d_, gv_, _ = leg._chunk_gap_geometry(ts_, s, n, c, gb.dtype)
            (e00m, e01, e10, e11m), (q00, q01, q11) = _block_eq_terms(
                gb_, d_.reshape(-1))
            gvf = gv_.reshape(-1)[None, :]
            streams = tuple(gvf * x for x in (e00m, e01, e10, e11m, q00,
                                              q01, q11))
            wanted = [gb_] + ([ts_] if ts_.requires_grad else [])
            grads = torch.autograd.grad(streams, wanted, cot_streams)
        gb_bar = grads[0]
        ts_bar = grads[1] if ts_.requires_grad else None
        xs_bar = ybar.permute(2, 0, 1).reshape(c * s, qd)[:n]
        return gb_bar, bbar, lambar, ts_bar, xs_bar, None


@leg._highest_precision
def log_likelihood_filter(params: CeleriteParams, ts: Tensor, xs: Tensor,
                          backend: str = "auto") -> Tensor:
    """Marginal log-likelihood via the chunk-parallel conditional Kalman
    filter (ops/chunked_filter): O(N r^2 q) work instead of the block
    elimination's O(N r^3); exact (the same chunk decomposition as the
    partitioned engine, in covariance form).

    float32 on the card (``backend`` "auto" or "cuda") runs the filter
    kernels (`_CelFilter`); elsewhere, and with ``backend="torch"``, the
    plain filter with its analytic adjoint.  The boundary chain runs on
    the partitioned engine with ``backend``."""
    num_obs = ts.shape[0]
    s = pt.default_chunk_len(num_obs)
    if _small(num_obs, s):
        return leg.log_likelihood(expand(params), ts, xs, backend=backend)
    lam = leg.lambda_lambda_t(params)
    nq = num_obs * xs.shape[1]
    if (params.n_diag.dtype == torch.float32
            and pt.resolve_backend(backend, lam) == "cuda"):
        out = _CelFilter.apply(g_blocks(params), params.b, lam, ts, xs, s)
        return cf.boundary_loglik_em(out, nq, backend=backend)
    e_cm, q_cm, y_cm, valid = _filter_inputs(params, ts, xs, s)
    out = cf.conditional_filter(e_cm, q_cm, params.b, lam, y_cm, valid)
    return cf.boundary_loglik(out, nq, backend=backend)


def make_predictions(params: CeleriteParams, ts: Tensor, xs: Tensor,
                     target_ts: Tensor, **kw):
    """``leg.make_predictions`` on the expanded parameters (on the card
    at nblocks <= 4: the dense emission kernels stop at rank 8)."""
    return leg.make_predictions(expand(params), ts, xs, target_ts, **kw)


NLL_METHODS = ("auto", "filter", "precision")


def nll_loss(params: CeleriteParams, ts: Tensor, xs: Tensor,
             method: str = "auto") -> Tensor:
    """-log_likelihood / nobs on the structured parameters (the loss of a
    ``train.loop.Optimizer`` step).

    ``method="auto"`` (or "filter") trains through the conditional-filter
    route, O(N r^2 q) forward and backward; ``method="precision"`` through
    the fused precision route.  Any other method raises ``ValueError``
    (the JAX package silently takes the precision route)."""
    if method not in NLL_METHODS:
        raise ValueError(f"method must be one of {NLL_METHODS}, got "
                         f"{method!r}")
    if method == "precision":
        return -log_likelihood(params, ts, xs) / xs.numel()
    return -log_likelihood_filter(params, ts, xs) / xs.numel()
