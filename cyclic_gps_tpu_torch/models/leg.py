"""LEG (Latent Exponentially Generated) Gaussian-process family, PyTorch:
the marginal likelihood and its gradient, the posterior and predictions.

Counterpart of ``cyclic_gps_tpu/models/leg.py`` (the likelihood, the
posterior on the precision and smoother routes, intercast, the stacked
multi-series entries and prior sampling):

    z ~ PEG(N, R)           a stationary latent Markov process with unit
                            stationary covariance and generator
                            G = N N^T + R - R^T (+ 1e-5 I),
    x(t) ~ Normal(B z(t), Lambda Lambda^T).

Because the PEG prior is Markov, its precision over any time grid is
block-tridiagonal, and the marginal likelihood reduces to one fused
(mahal, logdet) pass of the block-tridiagonal engines (ops/).

Parameters live in an ``nn.Module`` (`LEGParams`) with the reference's
packing: N lower-triangular incl. the diagonal, R strictly lower, Lambda
lower-triangular with a softplus on read, B dense.

Backends (``backend=``): ``"auto"`` runs the hand-written CUDA kernels
for CUDA tensors and plain tensor code otherwise (the engine's sweep
kernels take float32 and float64; the gap-emission kernels take float32
only, so float64 emits with tensor code); ``"torch"`` runs plain tensor
code on any device, end to end; ``"cuda"`` demands the kernels.
Timestamps may be float64 while the model runs in float32: gaps are
formed at the timestamps' precision and then cast (at N = 1e6 a float32
time axis can no longer resolve a 0.01 gap).

Gradients: every kernel route is a ``torch.autograd.Function`` whose
backward is the JAX package's custom VJP -- the fused route replays the
two-kernel route, whose K emission has the analytic adjoint kernel
(`_KGapParts`) and whose elimination has the analytic solve + selected
inversion (``partitioned.mahal_and_logdet_cm``); the (e, Q) kernel
replays its structured Pade-7 twin.  The plain routes differentiate by
autograd through the same custom backwards.

Entry points put their tensors on the card unless the caller names a
device (``device="cpu"`` on a machine without one).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cyclic_gps_tpu_torch import resolve_device
from cyclic_gps_tpu_torch.models.gaussians import (build_2x2_block,
                                                   build_3x3_block,
                                                   gaussian_stitch)
from cyclic_gps_tpu_torch.ops import cyclic_reduction as cr
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import smallblock as sb
from cyclic_gps_tpu_torch.ops.expm_cuda import (gap_mahal_sweep_cuda,
                                                k_system_adjoint_cuda,
                                                k_system_cuda,
                                                transition_and_noise_cuda,
                                                transition_and_noise_diff)

Tensor = torch.Tensor

G_DIAG_EPS = 1e-5  # reference models.py:158
LLT_DIAG_EPS = 1e-9  # reference models.py:165


def _highest_precision(fn):
    """Full-precision float32 matmuls inside model math (no TF32): the
    counterpart of the JAX package's ``default_matmul_precision
    ("highest")``.  The small-block algebra is elementwise already; this
    covers the few dense r x r products."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev)

    return wrapped


class LEGParams(nn.Module):
    """Trainable parameters, packed as in the reference (models.py:38-68)."""

    def __init__(self, n_params: Tensor, r_params: Tensor,
                 lambda_params: Tensor, b: Tensor):
        super().__init__()
        self.n_params = nn.Parameter(n_params)  # [rank*(rank+1)/2]
        self.r_params = nn.Parameter(r_params)  # [rank*(rank-1)/2]
        self.lambda_params = nn.Parameter(lambda_params)  # [obs*(obs+1)/2]
        self.b = nn.Parameter(b)  # [obs_dim, rank]

    @property
    def rank(self) -> int:
        return self.b.shape[1]

    @property
    def obs_dim(self) -> int:
        return self.b.shape[0]


class LEGView(NamedTuple):
    """The four packed parameter tensors as they are, without
    ``nn.Parameter`` wrapping: every LEG function takes one in place of a
    `LEGParams`, reading only these fields.  A structured family builds
    one from its own parameters (``celerite.expand``) so that gradients
    flow back through the expansion; wrapping the expanded tensors in a
    `LEGParams` would detach them."""

    n_params: Tensor
    r_params: Tensor
    lambda_params: Tensor
    b: Tensor

    @property
    def rank(self) -> int:
        return self.b.shape[1]

    @property
    def obs_dim(self) -> int:
        return self.b.shape[0]


def tril_indices(n: int, offset: int = 0, device=None) -> Tensor:
    """[2, K] row-major lower-triangle indices (numpy's order)."""
    return torch.tril_indices(n, n, offset, device=device)


def parameter_count(rank: int, obs_dim: int) -> int:
    """Total trainable scalars (reference models.py:123-133)."""
    return (
        rank * (rank + 1) // 2
        + rank * (rank - 1) // 2
        + obs_dim * (obs_dim + 1) // 2
        + obs_dim * rank
    )


def init_params(
    rank: int,
    obs_dim: int,
    prior_process_noise_level: float = 1.0,
    prior_length_scale: float = 0.2,
    generator: torch.Generator = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> LEGParams:
    """Initial guess matching the reference (models.py:93-121):

    N = noise_level * I (via chol(N N^T)); R = (Z - Z^T) * length_scale
    with Z standard normal drawn from ``generator``; Lambda = 0.1 * I
    (packed raw; softplus applied on read); B = 0.5 * ones / row-norm.
    On the card unless ``device`` says otherwise.
    """
    n_mat = torch.eye(rank, dtype=dtype) * prior_process_noise_level
    n_mat = torch.linalg.cholesky(n_mat @ n_mat.T)
    ti = tril_indices(rank, 0)
    n_params = n_mat[ti[0], ti[1]]

    z = torch.randn((rank, rank), generator=generator, dtype=dtype)
    r_mat = (z - z.T) * prior_length_scale
    ti = tril_indices(rank, -1)
    r_params = r_mat[ti[0], ti[1]]

    lam = 0.1 * torch.eye(obs_dim, dtype=dtype)
    lam = torch.linalg.cholesky(lam @ lam.T)
    ti = tril_indices(obs_dim, 0)
    lambda_params = lam[ti[0], ti[1]]

    b = torch.ones((obs_dim, rank), dtype=dtype)
    b = 0.5 * b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True))
    return LEGParams(n_params, r_params, lambda_params, b).to(
        resolve_device(device))


def _unpack(packed: Tensor, n: int, offset: int) -> Tensor:
    out = packed.new_zeros((n, n))
    ti = tril_indices(n, offset, device=packed.device)
    out[ti[0], ti[1]] = packed
    return out


def n_matrix(params: LEGParams) -> Tensor:
    return _unpack(params.n_params, params.rank, 0)


def r_matrix(params: LEGParams) -> Tensor:
    return _unpack(params.r_params, params.rank, -1)


def lambda_matrix(params: LEGParams) -> Tensor:
    """Softplus-positivised lower-triangular Lambda (models.py:145-150)."""
    return _unpack(nn.functional.softplus(params.lambda_params),
                   params.obs_dim, 0)


def g_matrix(params: LEGParams) -> Tensor:
    """PEG generator G = N N^T + R - R^T + 1e-5 I (models.py:152-159)."""
    n = n_matrix(params)
    r = r_matrix(params)
    g = n @ n.T + r - r.T
    return g + G_DIAG_EPS * torch.eye(params.rank, dtype=g.dtype,
                                      device=g.device)


def lambda_lambda_t(params: LEGParams) -> Tensor:
    """Observation noise covariance + eps I (models.py:161-170): the
    reference's 1e-9 at float64, a 1e-6 floor at float32."""
    lam = lambda_matrix(params)
    llt = lam @ lam.T
    eps = LLT_DIAG_EPS if llt.dtype == torch.float64 else 1e-6
    return llt + eps * torch.eye(params.obs_dim, dtype=llt.dtype,
                                 device=llt.device)


def expm_batch(mats: Tensor) -> Tensor:
    """Batched matrix exponential of [..., d, d] (dense oracles only)."""
    return torch.linalg.matrix_exp(mats)


# ---------------------------------------------------------------------------
# Gap emission: gap widths -> (transition e, conditional covariance Q1).
# ---------------------------------------------------------------------------


def transition_and_noise(g: Tensor, diffs: Tensor,
                         backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Per-gap transition e = expm(-.5 d G) and conditional covariance
    Q = I - e e^T, formed without cancellation (Van Loan's augmented
    exponential where the direct form would cancel).  Returns
    (e [T, r, r], q [T, r, r])."""
    e_em, q_em = transition_and_noise_em(g, diffs, backend)
    return sb.from_em(e_em), sb.from_em(q_em)


def transition_and_noise_em(g: Tensor, diffs: Tensor,
                            backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Element-major `transition_and_noise`: returns (e, q) as [r, r, T].

    float32 on CUDA runs the (e, Q) kernel (ops/expm_cuda.py), whose
    gradient replays its structured Pade-7 twin; everything else, and
    ``backend="torch"``, runs the Pade-13 tensor pipeline."""
    if (g.dtype == torch.float32
            and pt.resolve_backend(backend, diffs) == "cuda"):
        return transition_and_noise_diff(g, diffs)
    return _transition_and_noise_em_plain(g, diffs)


def _transition_and_noise_em_plain(g: Tensor,
                                   diffs: Tensor) -> Tuple[Tensor, Tensor]:
    """Tensor implementation of `transition_and_noise_em` (Pade-13), for
    one generator g [r, r] (the JAX twin also takes a stack of them; no
    caller uses that).

    Hybrid per gap: Van Loan's augmented exponential
    expm([[A, S], [0, -A^T]] d) = [[e, P], [0, e^{-T}]], Q = P e^T
    (A = -G/2, S = (G + G^T)/2) is accurate where |d G|/2 < 1 but its
    growing block contaminates P for large gaps, where the direct
    I - e e^T is accurate instead.  The Van Loan gap is clamped into its
    stable range so the unselected branch stays finite.
    """
    from cyclic_gps_tpu_torch.ops.expm_em import expm_em

    r = g.shape[0]
    a = -0.5 * g
    aug = torch.cat([torch.cat([a, 0.5 * (g + g.T)], dim=-1),
                     torch.cat([torch.zeros_like(a), -a.T], dim=-1)],
                    dim=-2)  # [2r, 2r]
    # the half-norm locates the cancellation regime
    half_norm = torch.amax(torch.sum(torch.abs(a), dim=-1))
    small = diffs * half_norm < 1.0
    d_clamped = torch.where(small, diffs, 1.0 / half_norm)

    # Van Loan branch (clamped gaps), 2r x 2r
    big = expm_em(aug[:, :, None] * d_clamped[None, None])
    p = big[:r, r:]
    e_vl = big[:r, :r]
    q_vl = sb.matmul(p, e_vl, tb=True)

    # direct branch (true gaps), r x r -- e is decaying, always stable
    e = expm_em(a[:, :, None] * diffs[None, None])
    q_direct = sb.eye_em(r, g) - sb.matmul(e, e, tb=True)

    mask = small[None, None, :].to(g.dtype)
    q = mask * q_vl + (1.0 - mask) * q_direct
    q = 0.5 * (q + sb.transpose(q))
    return e, q


def peg_precision_and_logdet(g: Tensor, ts: Tensor, backend: str = "auto"):
    """Block-tridiagonal precision of the PEG latent on grid ``ts`` and
    its log-determinant: ([N, r, r] diag, [N-1, r, r] lower-off,
    log|Sigma^{-1}|).  With e_i = expm(-.5 dt_i G), Q1_i = I - e_i e_i^T:
      off_i  = -Q1_i^{-1} e_i
      diag_i = I + [Q1_{i-1}^{-1} - I  if i > 0]
                 + [e_i^T Q1_i^{-1} e_i  if i < N-1]
    (the boundary terms implement the infinite lead-in/lead-out), and by
    Markovianity log|Sigma| = sum_i log|Q1_i|."""
    diag_em, off_em, sig_inv_logdet = _peg_precision_em(g, ts, backend)
    return sb.from_em(diag_em), sb.from_em(off_em), sig_inv_logdet


def peg_precision(g: Tensor, ts: Tensor,
                  backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Block-tridiagonal precision of the PEG latent on grid ``ts``:
    ([N, r, r] diag, [N-1, r, r] lower-off) of
    `peg_precision_and_logdet`."""
    return peg_precision_and_logdet(g, ts, backend)[:2]


def _q1_terms(e, q1):
    """From (e, Q1 = I - e e^T): the three precision ingredients

      off     = -Q1^{-1} e
      d_left  = e Q2^{-1} e^T = Q1^{-1} - I   (push-through identity)
      d_right = e^T Q1^{-1} e

    Returns (off, d_left, d_right, l1) with l1 the Cholesky of Q1
    (pivot-floored at float32)."""
    rank = e.shape[0]
    l1, inv1 = sb.cholesky(q1)
    q1_inv_e = sb.solve_lower_t(l1, inv1, sb.solve_lower(l1, inv1, e))
    li = sb.tri_lower_inverse(l1, inv1)
    d_left = sb.matmul(li, li, ta=True) - sb.eye_em(rank, e)  # Q1^{-1} - I
    d_right = sb.matmul(sb.transpose(e), q1_inv_e)
    return -q1_inv_e, d_left, d_right, l1


def _peg_precision_em(g: Tensor, ts: Tensor, backend: str = "auto"):
    """Element-major precision assembly: (diag [r, r, N],
    off [r, r, N-1], log|Sigma^{-1}|)."""
    rank = g.shape[0]
    diffs = (ts[1:] - ts[:-1]).to(g.dtype)
    e, q1 = transition_and_noise_em(g, diffs, backend)
    off, d_left, d_right, l1 = _q1_terms(e, q1)

    # diag_i = I + d_left[i-1] + d_right[i]  (gap g connects points g, g+1)
    zero = g.new_zeros((rank, rank, 1))
    diag = (
        sb.eye_em(rank, g)
        + torch.cat([zero, d_left], dim=-1)
        + torch.cat([d_right, zero], dim=-1)
    )
    logdet_prior = 2.0 * sb.chol_log_diag_sum(l1)
    return diag, off, -logdet_prior


def _peg_precision_em_regular(g: Tensor, dt: Tensor, num_obs: int,
                              backend: str = "auto"):
    """Element-major precision for a REGULAR grid with gap ``dt``: one
    matrix exponential instead of N-1, then broadcast blocks."""
    rank = g.shape[0]
    t = num_obs - 1
    e1, q1 = transition_and_noise_em(g, dt.reshape(1).to(g.dtype), backend)
    off1, d_left, d_right, l1 = _q1_terms(e1, q1)

    eye = sb.eye_em(rank, g)
    mid = (eye + d_left + d_right).expand(rank, rank, max(num_obs - 2, 0))
    diag = torch.cat([eye + d_right, mid, eye + d_left], dim=-1)
    off = off1.expand(rank, rank, t)
    logdet_prior = 2.0 * t * sb.chol_log_diag_sum(l1)
    return diag, off, -logdet_prior


def _gap_terms_dense(g: Tensor, backend: str = "auto"):
    """Gap-emission closure for a dense generator: diffs [M] ->
    (off1, d_left, d_right [r, r, M] element-major, log|Q1| per gap
    [M])."""

    def fn(diffs):
        e, q1 = transition_and_noise_em(g, diffs, backend)
        off1, d_left, d_right, l1 = _q1_terms(e, q1)
        logq1 = 2.0 * torch.sum(
            torch.log(torch.diagonal(l1, dim1=0, dim2=1)), dim=1
        )
        return off1, d_left, d_right, logq1

    return fn


# Gap-slab size for the streamed emission: the adjoint of the whole-M
# Pade-13 pipeline holds [4r, 4r, M] Frechet temporaries (~1.5 GB each at
# rank 5, M = 1e6); 64 K-gap slabs bound them at ~100 MB.
_ADJ_SLAB = 65536


def _gap_terms_dense_streamed(g: Tensor, backend: str = "auto"):
    """`_gap_terms_dense` evaluated slab by slab under
    ``torch.utils.checkpoint``: identical values, but the backward
    recomputes one slab's forward at a time instead of storing every
    slab's temporaries.  What makes the plain irregular-grid gradient fit
    at N >= 1e6."""
    dense = _gap_terms_dense(g, backend)

    def fn(diffs):
        m = diffs.shape[0]
        if m <= _ADJ_SLAB:
            return dense(diffs)
        parts = [checkpoint(dense, diffs[i:i + _ADJ_SLAB],
                            use_reentrant=False)
                 for i in range(0, m, _ADJ_SLAB)]
        return tuple(torch.cat(leaf, dim=-1) for leaf in zip(*parts))

    return fn


# ---------------------------------------------------------------------------
# Chunk-major assembly of the posterior-precision system K.
# ---------------------------------------------------------------------------


def _chunk_gap_geometry(ts: Tensor, s: int, n: int, c: int, dtype,
                        gap_mask: Optional[Tensor] = None):
    """Chunk-major gap geometry: (diffs [s, C], gap_valid [s, C],
    is_real [s, C]), contiguous.  Natural index i = c*s + j lives at
    [j, c]; padded gaps are 1 (harmless), the last real gap is masked by
    gap_valid.  Gaps are formed at the precision of ``ts`` and cast to
    ``dtype``.

    ``gap_mask`` (natural [n], 1 where gap i between points i and i+1 is
    real): more invalid gaps.  The stacked multi-series entries mask the
    series-boundary gaps here, which zeroes their off-diagonal coupling
    and their d_left / d_right precision terms, so K is exactly
    block-diagonal over the series (each block that series' own K)."""
    m = c * s
    ts_pad = torch.cat([ts, ts.new_zeros((m - n,))]).reshape(c, s).T
    idx = (torch.arange(s, device=ts.device)[:, None]
           + s * torch.arange(c, device=ts.device)[None, :])  # [s, C]
    gap_valid = (idx < n - 1).to(dtype)
    is_real = (idx < n).to(dtype)
    if gap_mask is not None:
        gm = torch.cat([gap_mask.to(dtype),
                        gap_valid.new_zeros((m - n,))]).reshape(c, s).T
        gap_valid = gap_valid * gm
    # next timestamp in natural order: [j+1, c], wrapping to [0, c+1]
    next_row = torch.cat([ts_pad[:1, 1:], ts_pad.new_zeros((1, 1))], dim=1)
    ts_next = torch.cat([ts_pad[1:], next_row], dim=0)
    diffs = (ts_next - ts_pad).to(dtype) * gap_valid + (1.0 - gap_valid)
    return diffs.contiguous(), gap_valid, is_real


def _k_gap_parts_plain(g, boost, ts, s, regular, rank, dtype, backend,
                       gap_fn=None, gap_mask=None):
    """(k_cm [s, r, r, C], off_cm, lq_cm [s, C]): the gap-dependent part
    of the chunk-major K system, assembled with tensor ops from the gap
    emission ``gap_fn`` (diffs [M] -> (off1, d_left, d_right [r, r, M],
    log|Q1| [M]), as `_gap_terms_dense`), by default the dense emission of
    the generator ``g``.  lq_cm is the valid-masked per-gap log|Q1| (the
    prior log-determinant is -sum(lq_cm)).  The dense irregular emission
    streams in slabs (`_gap_terms_dense_streamed`).  ``gap_mask``: see
    `_chunk_gap_geometry`."""
    if gap_fn is None:
        gap_fn = (_gap_terms_dense(g, backend) if regular
                  else _gap_terms_dense_streamed(g, backend))
    n = ts.shape[0]
    c = -(-n // s)
    diffs, gap_valid, is_real = _chunk_gap_geometry(ts, s, n, c, dtype,
                                                    gap_mask)

    if regular:
        dt = (ts[1] - ts[0]).to(dtype)
        off1, d_left, d_right, logq1 = gap_fn(dt.reshape(1))
    else:
        off1, d_left, d_right, logq1 = gap_fn(diffs.reshape(-1))

    def cm(x):  # [r, r, s*C] -> [s, r, r, C] (broadcasting the regular case)
        if x.shape[-1] == 1:
            return x[None].expand(s, rank, rank, c)
        return x.reshape(rank, rank, s, c).permute(2, 0, 1, 3)

    gv = gap_valid[:, None, None, :]
    off_cm = cm(off1) * gv
    d_right_cm = cm(d_right) * gv
    d_left_cm = cm(d_left) * gv
    # shift d_left down one natural step: [j-1, c]; j=0 <- [s-1, c-1]
    wrap = torch.cat(
        [d_left_cm.new_zeros((1, rank, rank, 1)), d_left_cm[-1:, :, :, :-1]],
        dim=-1,
    )
    d_left_shifted = torch.cat([wrap, d_left_cm[:-1]], dim=0)

    eye = torch.eye(rank, dtype=dtype, device=boost.device)[None, :, :, None]
    k_cm = (
        eye
        + d_left_shifted
        + d_right_cm
        + boost[None, :, :, None] * is_real[:, None, None, :]
    )
    if regular:
        lq_cm = gap_valid * logq1[0]
    else:
        lq_cm = logq1.reshape(s, c) * gap_valid
    return k_cm.contiguous(), off_cm.contiguous(), lq_cm


def _wrap_row(g: Tensor, diffs: Tensor, gap_valid: Tensor, s: int):
    """The chunk-crossing d_left row: gap c*s - 1 feeds point c*s = row 0
    of chunk c.  C gaps through the (e, Q) kernel, the tensor Q1 terms,
    then a one-lane shift right with zeros into chunk 0 ([r, r, C])."""
    rank = g.shape[0]
    e_w, q_w = transition_and_noise_cuda(g, diffs[s - 1].contiguous())
    _, dl_w, _, _ = _q1_terms(e_w, q_w)
    dl_w = dl_w * gap_valid[s - 1][None, None, :]
    return torch.cat([dl_w.new_zeros((rank, rank, 1)), dl_w[:, :, :-1]],
                     dim=-1).contiguous()


class _KGapParts(torch.autograd.Function):
    """Kernel version of `_k_gap_parts_plain` (irregular grid, dense G,
    float32): the (e, Q) kernel for the chunk-crossing row, then ONE
    K-system kernel pass emits (k_cm, off_cm, per-gap log|Q1|)
    chunk-major at the true chunk count.  ``gap_mask`` (natural [n] or
    None; the stacked series' boundaries) rides the kernels' gap_valid
    input and the chunk-crossing row's.  CPU tensors run the kernels'
    plain twins.

    Backward (the JAX ``_k_gap_parts_pallas_bwd``): the K-row cotangents
    become per-gap cotangents (d_right of gap [j, c] feeds K row [j, c];
    d_left feeds row [j+1, c], crossing into row [0, c+1] at j = s-1),
    the adjoint kernel maps them to (c_g, c_sym, c_dt), and c_dt is
    pulled through the gap geometry to the timestamps."""

    @staticmethod
    def forward(ctx, g, boost, ts, gap_mask, s):
        n = ts.shape[0]
        c = -(-n // s)
        diffs, gap_valid, is_real = _chunk_gap_geometry(ts, s, n, c,
                                                        g.dtype, gap_mask)
        wrap = _wrap_row(g, diffs, gap_valid, s)
        ctx.s = s
        ctx.save_for_backward(g, ts, gap_mask, diffs, gap_valid, is_real)
        return k_system_cuda(g.contiguous(), boost.contiguous(), diffs,
                             gap_valid, is_real, wrap)

    @staticmethod
    def backward(ctx, gk, goff, glq):
        g, ts, gap_mask, diffs, gap_valid, is_real = ctx.saved_tensors
        s = ctx.s
        rank = g.shape[0]
        c = diffs.shape[-1]
        wrap_next = torch.cat([gk[0, :, :, 1:],
                               gk.new_zeros((rank, rank, 1))], dim=-1)
        c_dl = torch.cat([gk[1:], wrap_next[None]], dim=0)
        c_g_raw, c_sym, c_dt = k_system_adjoint_cuda(
            g.contiguous(), diffs, gap_valid, goff.contiguous(), c_dl,
            gk.contiguous(), glq.contiguous())
        c_g = c_g_raw + 0.5 * (c_sym + c_sym.T)
        c_boost = torch.einsum("sijc,sc->ij", gk, is_real)
        c_ts = None
        if ctx.needs_input_grad[2]:
            with torch.enable_grad():
                t = ts.detach().requires_grad_()
                geo = _chunk_gap_geometry(t, s, ts.shape[0], c, g.dtype,
                                          gap_mask)[0]
                (c_ts,) = torch.autograd.grad(geo, t, c_dt)
        # the 0/1 gap mask is a set-membership constant: no cotangent
        return c_g, c_boost, c_ts, None, None


class _GapMahalFused(torch.autograd.Function):
    """(v^T K^{-1} v, log|K|, log|Sigma^{-1}|) straight from the gap
    widths (irregular grid, dense G, float32): the fused gaps -> sweep
    kernel builds and eliminates every chunk interior row without
    storing K; the reduced boundary system finishes on the partitioned
    ladder.  ``v_cm`` [s, r, C] at the true chunk count C = ceil(n / s);
    ``gap_mask`` as for `_KGapParts`.  CPU tensors run the kernels' plain
    twins.

    Backward (the JAX ``_gap_mahal_fused_bwd``): replay the two-kernel
    route, whose custom backwards are analytic, by autograd."""

    @staticmethod
    def forward(ctx, g, boost, ts, gap_mask, v_cm, s):
        n = ts.shape[0]
        c = -(-n // s)
        diffs, gap_valid, is_real = _chunk_gap_geometry(ts, s, n, c,
                                                        g.dtype, gap_mask)
        wrap = _wrap_row(g, diffs, gap_valid, s)
        (acc00, accy0, w0l, wl, dl, invdl, mh, ld, lq_sum, k0,
         olast) = gap_mahal_sweep_cuda(g.contiguous(), boost.contiguous(),
                                       diffs, gap_valid, is_real, wrap,
                                       v_cm)
        state = pt._SweepState(None, w0l, wl, dl, invdl, acc00, accy0, mh,
                               ld)
        w1 = sb.solve_lower(dl, invdl, sb.transpose(olast))
        red_diag, red_off, red_rhs = pt._reduced_system(
            k0[None], v_cm[:1], state, w1
        )
        red_mh, red_ld = pt._mahal_and_logdet_impl(
            sb.from_em(red_diag), sb.from_em(red_off)[: c - 1],
            sb.vec_from_em(red_rhs), None, 0.0,
            pt.resolve_backend("auto", v_cm),
        )
        ctx.s = s
        ctx.save_for_backward(g, boost, ts, v_cm, gap_mask)
        return mh + red_mh, 2.0 * ld + red_ld, -lq_sum

    @staticmethod
    def backward(ctx, *cots):
        needs = (ctx.needs_input_grad[:3]
                 + ctx.needs_input_grad[4:5])  # g, boost, ts, v_cm
        *saved, gap_mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            g, boost, ts, v_cm = ins
            k_cm, off_cm, lq_cm = _KGapParts.apply(g, boost, ts, gap_mask,
                                                   ctx.s)
            mh, ld = pt.mahal_and_logdet_cm(k_cm, off_cm, v_cm,
                                            backend="auto")
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(
                (mh, ld, -torch.sum(lq_cm)), wanted, cots,
                allow_unused=True))
        g_g, g_boost, g_ts, g_v = (next(grads) if need else None
                                   for need in needs)
        return g_g, g_boost, g_ts, None, g_v, None


def _v_chunk_major(params, xs, llt, s: int, c: int, dtype):
    """v = (LLT^{-1} x) B in chunk-major [s, r, C] (zero padding rows)."""
    n = xs.shape[0]
    x_llt_inv = torch.linalg.solve(llt, xs.T).T
    v = x_llt_inv @ params.b
    v_pad = torch.cat([v, v.new_zeros((c * s - n, params.rank))], dim=0)
    return v_pad.reshape(c, s, params.rank).permute(1, 2, 0).contiguous()


def _use_gap_fused(params, regular: bool, backend: str, n: int,
                   s: int) -> bool:
    """Gate for the fused gaps -> sweep kernel: irregular grid, float32,
    the CUDA backend, and a large-N system."""
    return (
        not regular
        and params.n_params.dtype == torch.float32
        and n >= max(pt._TERMINAL, 2 * s)
        and pt.resolve_backend(backend, params.n_params) == "cuda"
    )


def _k_system_chunked(params, ts: Tensor, xs: Tensor, s: int,
                      regular: bool, backend: str = "auto", gap_fn=None,
                      return_sig_rows: bool = False,
                      gap_mask: Optional[Tensor] = None):
    """Posterior-precision system K = Sigma^{-1} + I (x) B^T LLT^{-1} B
    emitted DIRECTLY in the partitioned engine's chunk-major layout
    ([s, r, r, C] / [s, r, C]), plus log|Sigma^{-1}|.

    Natural index i = c*s + j lives at [j, ..., c]; padding blocks are
    exactly identity / zero.  An irregular float32 grid on the CUDA
    backend emits K with the K-system kernel (ops/expm_cuda.py); every
    other case, and ``backend="torch"``, assembles it with tensor ops.
    (The JAX package reads ``resolve_backend("auto")`` at this point, not
    the caller's backend, so its explicit "xla" still emits K with the
    TPU kernel; here the caller's backend is threaded through, so
    "torch" is plain end to end.)  ``gap_fn`` overrides the gap emission
    (see `_k_gap_parts_plain`; the celerite closed forms): K is then
    assembled with tensor ops on every backend, and ``params`` needs only
    its ``b`` and ``lambda_params``.  ``gap_mask`` (natural [n]) marks
    more invalid gaps (the stacked series' boundaries, see
    `_chunk_gap_geometry`).  ``return_sig_rows=True`` appends the
    valid-masked per-gap log|Q1| [s, C], whose sum is -log|Sigma^{-1}|
    (the per-row pairing of `log_likelihood_residual`, the per-series
    sums of `log_likelihood_per_series`).  ``gap_mask`` (natural [n])
    marks more invalid gaps, on every route (`_chunk_gap_geometry`).
    """
    rank = params.rank
    llt = lambda_lambda_t(params)
    n = ts.shape[0]
    dtype = llt.dtype
    boost = params.b.T @ torch.linalg.solve(llt, params.b)

    if (gap_fn is None and not regular and dtype == torch.float32
            and pt.resolve_backend(backend, llt) == "cuda"):
        k_cm, off_cm, lq_cm = _KGapParts.apply(g_matrix(params), boost, ts,
                                               gap_mask, s)
    else:
        g = g_matrix(params) if gap_fn is None else None
        k_cm, off_cm, lq_cm = _k_gap_parts_plain(g, boost, ts, s, regular,
                                                 rank, dtype, backend,
                                                 gap_fn, gap_mask)
    sig_logdet = -torch.sum(lq_cm)
    v_cm = _v_chunk_major(params, xs, llt, s, k_cm.shape[-1], dtype)
    if return_sig_rows:
        return k_cm, off_cm, v_cm, sig_logdet, lq_cm
    return k_cm, off_cm, v_cm, sig_logdet


@_highest_precision
def log_likelihood(
    params: LEGParams, ts: Tensor, xs: Tensor, regular: bool = False,
    backend: str = "auto", fused: bool = True,
) -> Tensor:
    """Marginal log-likelihood log p(x | ts, params) in O(N).

    Identity (reference models.py:300-372):
      log p(x) = -1/2 [ x^T Ltilde^{-1} x - v^T K^{-1} v
                        + N log|2 pi LLT| + log|K| - log|Sigma^{-1}| ]
      with Sigma^{-1} the PEG precision, K = Sigma^{-1} + I_N (x) B^T
      LLT^{-1} B, v = (LLT^{-1} x) B.

    ``regular=True`` asserts the grid has a constant gap (ts[1] - ts[0]),
    replacing N-1 matrix exponentials with one.  ``backend``: "auto"
    (CUDA kernels for CUDA tensors, tensor code elsewhere), "torch"
    (tensor code on any device) or "cuda".  Routes, as in the JAX
    package: large irregular float32 systems on CUDA run the fused
    gaps -> sweep kernel; other large systems emit K chunk-major and run
    the partitioned engine; N < 64 assembles the natural-order precision
    and runs cyclic reduction.  ``fused=False`` takes the two-kernel
    route on the irregular grid instead (K emitted by the K-system
    kernel, then eliminated by the forward-sweep kernel): the route the
    JAX package takes for an explicit non-kernel solver backend and the
    one the likelihood gradient replays.  A series needs at least two
    observations: one point has no gap to build the precision from, so
    N < 2 raises ``ValueError`` on both grids (the JAX package raises on
    the irregular one and returns NaN on the regular one).
    """
    num_obs = ts.shape[0]
    if num_obs < 2:
        raise ValueError(
            f"log_likelihood needs at least two observations, got {num_obs}"
            " (the precision is built from the gaps between them)")
    llt = lambda_lambda_t(params)
    g = g_matrix(params)

    x_llt_inv = torch.linalg.solve(llt, xs.T).T  # [N, obs]
    llt_mahal = torch.sum(x_llt_inv * xs)
    llt_logdet = num_obs * torch.linalg.slogdet(2.0 * math.pi * llt)[1]

    s = pt.default_chunk_len(num_obs)
    if fused and _use_gap_fused(params, regular, backend, num_obs, s):
        # each row's precision blocks are built in the kernel from the
        # gap widths and eliminated in place -- K is never stored
        c = -(-num_obs // s)
        boost = params.b.T @ torch.linalg.solve(llt, params.b)
        v_cm = _v_chunk_major(params, xs, llt, s, c, llt.dtype)
        k_mahal, k_logdet, sig_inv_logdet = _GapMahalFused.apply(
            g, boost, ts, None, v_cm, s
        )
    elif num_obs >= max(pt._TERMINAL, 2 * s):
        # large-N path: emit K directly in the partitioned engine's
        # chunk-major layout
        k_cm, o_cm, v_cm, sig_inv_logdet = _k_system_chunked(
            params, ts, xs, s, regular, backend
        )
        k_mahal, k_logdet = pt.mahal_and_logdet_cm(k_cm, o_cm, v_cm,
                                                   backend=backend)
    else:
        v = x_llt_inv @ params.b  # [N, rank]
        if regular:
            d_em, o_em, sig_inv_logdet = _peg_precision_em_regular(
                g, ts[1] - ts[0], num_obs, backend
            )
            sig_inv_diag, sig_inv_off = sb.from_em(d_em), sb.from_em(o_em)
        else:
            (sig_inv_diag, sig_inv_off,
             sig_inv_logdet) = peg_precision_and_logdet(g, ts, backend)
        bt_llt_inv_b = params.b.T @ torch.linalg.solve(llt, params.b)
        k_diag = sig_inv_diag + bt_llt_inv_b[None]
        k_mahal, k_logdet = pt.mahal_and_logdet(k_diag, sig_inv_off, v,
                                                backend=backend)

    mahal = llt_mahal - k_mahal
    logdet = llt_logdet + k_logdet - sig_inv_logdet
    return -0.5 * (mahal + logdet)


@_highest_precision
def log_likelihood_residual(
    params: LEGParams, ts: Tensor, xs: Tensor, regular: bool = False,
    backend: str = "auto",
) -> Tensor:
    """Float32-safe precision-form marginal log-likelihood (the JAX
    package's ``log_likelihood_residual``).

    Mathematically identical to `log_likelihood`; organised so that
    single precision survives the smooth-fit regime, where K's blocks
    scale like 1/(dt lambda_min) and the plain form's two large
    (mahal, logdet) terms cancel:

      * mahal: x^T LLT^{-1} x - v^T K^{-1} v is computed variationally
        as r^T LLT^{-1} r + z^T Sigma^{-1} z, with z = K^{-1} v the
        posterior mean and r = x - B z the residual: both terms are
        nonnegative, and z minimises the quadratic, so the float32
        solve's error in z enters only at second order.  z^T Sigma^{-1} z
        uses the Markov factorisation |z_0|^2 + sum_i |L_i^{-1} (z_{i+1}
        - e_i z_i)|^2 (`_residual_quad_streamed`).
      * logdet: log|K| - log|Sigma^{-1}| is summed per row pair,
        sum_j (ld_row_j + log|Q1_j|), each pair O(1).  The per-row pivot
        log-dets come from the solve's own sweep
        (``partitioned.solve_and_ld_rows_cm``: kernels 8 and 9 on the
        card, with their analytic adjoint).

    Below the chunked threshold it is `log_likelihood`, as in the JAX
    package.  ``backend`` as for `log_likelihood`."""
    num_obs = ts.shape[0]
    s = pt.default_chunk_len(num_obs)
    if num_obs < max(pt._TERMINAL, 2 * s):
        return log_likelihood(params, ts, xs, regular=regular,
                              backend=backend)
    llt = lambda_lambda_t(params)
    g = g_matrix(params)
    llt_logdet = num_obs * torch.linalg.slogdet(2.0 * math.pi * llt)[1]

    k_cm, o_cm, v_cm, _, lq_cm = _k_system_chunked(
        params, ts, xs, s, regular, backend, return_sig_rows=True)
    x_pad, ld_rows = pt.solve_and_ld_rows_cm(k_cm, o_cm, v_cm,
                                             backend=backend)
    z = x_pad[:num_obs]  # posterior mean [N, r]
    logdet = llt_logdet + torch.sum(ld_rows + lq_cm)

    r = xs - z @ params.b.T
    r_mahal = torch.sum(r * torch.linalg.solve(llt, r.T).T)

    diffs = (ts[1:] - ts[:-1]).to(llt.dtype)
    z_em = sb.vec_to_em(z)  # [r, N]
    z_sig_z = (torch.sum(z_em[:, 0] ** 2)
               + _residual_quad_streamed(g, diffs, z_em, backend=backend))
    return -0.5 * (r_mahal + z_sig_z + logdet)


def _residual_quad_streamed(g: Tensor, diffs: Tensor, z_em: Tensor,
                            slab: int = _ADJ_SLAB,
                            backend: str = "auto") -> Tensor:
    """sum_i |L_i^{-1} (z_{i+1} - e_i z_i)|^2 (the Markov-factorised
    posterior-mean quadratic of `log_likelihood_residual`), evaluated in
    gap slabs under ``torch.utils.checkpoint``, as
    `_gap_terms_dense_streamed`: the backward of `transition_and_noise_em`
    over all gaps at once would hold ~10 [r, r, M] temporaries, so each
    slab's forward is recomputed in the backward instead of stored."""

    def quad(dt_sl, z0_sl, z1_sl):
        e, q1 = transition_and_noise_em(g, dt_sl, backend)
        dz = z1_sl - sb.matvec(e, z0_sl)
        lq1, invd1 = sb.cholesky(q1)
        w = sb.solve_lower_vec(lq1, invd1, dz)
        return torch.sum(w * w)

    m = diffs.shape[0]
    z0, z1 = z_em[:, :-1], z_em[:, 1:]  # each gap's two ends
    if m <= slab:
        return quad(diffs, z0, z1)
    sums = [checkpoint(quad, diffs[i:i + slab], z0[:, i:i + slab],
                       z1[:, i:i + slab], use_reentrant=False)
            for i in range(0, m, slab)]
    return torch.sum(torch.stack(sums))

# ---------------------------------------------------------------------------
# Stacked multi-series entries.  B independent series that share one set
# of parameters are concatenated into one block-tridiagonal system whose
# series-boundary gaps are masked (gap_valid = 0): the off-diagonal
# coupling and the d_left / d_right precision terms of those gaps vanish,
# so K is exactly block-diagonal over the series, and one pass of the
# engine (the kernels on the card) serves the whole batch.  Segment sums
# run on ``index_add_``.
# ---------------------------------------------------------------------------


def stack_series(series) -> Tuple[Tensor, Tensor, Tensor]:
    """A list of ``(ts_b, xs_b)`` pairs (ragged lengths, no padding) ->
    the stacked ``(ts, xs, series_ids)`` the stacked entries take (ids
    int64, on the device of the first series)."""
    ts = torch.cat([t for t, _ in series])
    xs = torch.cat([x for _, x in series])
    ids = torch.cat([torch.full((t.shape[0],), i, dtype=torch.int64,
                                device=ts.device)
                     for i, (t, _) in enumerate(series)])
    return ts, xs, ids


def _series_gap_mask(series_ids: Tensor) -> Tensor:
    """Natural [n] gap mask from sorted series ids: gap i (between points
    i and i+1) is within a series iff their ids match; the trailing slot
    (no gap) is False."""
    same = series_ids[1:] == series_ids[:-1]
    return torch.cat([same, same.new_zeros((1,))])


def _segment_sum(values: Tensor, series_ids: Tensor,
                 num_series: int) -> Tensor:
    """[num_series] sums of ``values`` [n] by series id."""
    return values.new_zeros((num_series,)).index_add(0, series_ids, values)


def _cm_to_natural(k_cm, o_cm, v_cm, rank):
    """A chunk-major K system in natural [m, r, r] / [m, r] order
    (m = s C; the identity / zero padding rows are exact for every solver
    entry)."""
    m = k_cm.shape[0] * k_cm.shape[-1]
    diag = k_cm.permute(3, 0, 1, 2).reshape(m, rank, rank)
    off = o_cm.permute(3, 0, 1, 2).reshape(m, rank, rank)[:m - 1]
    v = v_cm.permute(2, 0, 1).reshape(m, rank)
    return diag, off, v


def _mahal_logdet_cm_any_n(k_cm, o_cm, v_cm, n, rank, backend):
    """(mahal, logdet) of a chunk-major K system at any total n: the
    partitioned entry from the chunked size on, else the system in
    natural order on cyclic reduction."""
    s = k_cm.shape[0]
    if n >= max(pt._TERMINAL, 2 * s):
        return pt.mahal_and_logdet_cm(k_cm, o_cm, v_cm, backend=backend)
    diag, off, v = _cm_to_natural(k_cm, o_cm, v_cm, rank)
    return cr.mahal_and_logdet(diag, off, v)


def _stacked_system(params, ts, xs, series_ids, regular, backend,
                    return_sig_rows=False):
    """`_k_system_chunked` with the series-boundary mask."""
    s = pt.default_chunk_len(ts.shape[0])
    return _k_system_chunked(params, ts, xs, s, regular, backend,
                             return_sig_rows=return_sig_rows,
                             gap_mask=_series_gap_mask(series_ids))


@_highest_precision
def log_likelihood_stacked(params: LEGParams, ts: Tensor, xs: Tensor,
                           series_ids: Tensor, regular: bool = False,
                           backend: str = "auto") -> Tensor:
    """Sum of the marginal log-likelihoods of B independent series
    stacked in one [N] array, in one pass of the engine.

    ``series_ids`` [N]: the sorted series label of each point (only
    adjacent equality is used).  ``ts`` increases within each series and
    may restart anywhere at a boundary (boundary gaps are masked out
    exactly).  ``regular=True`` asserts that every series has the gap
    ts[1] - ts[0] (offsets may differ).  Equal to
    sum_b log_likelihood(params, ts_b, xs_b).  Routes as
    `log_likelihood`: on the card at float32 an irregular grid runs the
    fused gaps -> sweep kernel with the mask in its gap_valid input."""
    llt = lambda_lambda_t(params)
    num_obs = ts.shape[0]
    x_llt_inv = torch.linalg.solve(llt, xs.T).T
    llt_mahal = torch.sum(x_llt_inv * xs)
    llt_logdet = num_obs * torch.linalg.slogdet(2.0 * math.pi * llt)[1]

    s = pt.default_chunk_len(num_obs)
    if _use_gap_fused(params, regular, backend, num_obs, s):
        c = -(-num_obs // s)
        boost = params.b.T @ torch.linalg.solve(llt, params.b)
        v_cm = _v_chunk_major(params, xs, llt, s, c, llt.dtype)
        k_mahal, k_logdet, sig_inv_logdet = _GapMahalFused.apply(
            g_matrix(params), boost, ts, _series_gap_mask(series_ids), v_cm,
            s)
    else:
        k_cm, o_cm, v_cm, sig_inv_logdet = _stacked_system(
            params, ts, xs, series_ids, regular, backend)
        k_mahal, k_logdet = _mahal_logdet_cm_any_n(
            k_cm, o_cm, v_cm, num_obs, params.rank, backend)
    mahal = llt_mahal - k_mahal
    logdet = llt_logdet + k_logdet - sig_inv_logdet
    return -0.5 * (mahal + logdet)


def _batch_ids(b: int, nb: int, device) -> Tensor:
    """Consecutive series ids of an equal-length batch, flattened."""
    return torch.arange(b, device=device).repeat_interleave(nb)


def log_likelihood_batch(params: LEGParams, ts_batch: Tensor,
                         xs_batch: Tensor, regular: bool = False,
                         backend: str = "auto") -> Tensor:
    """`log_likelihood_stacked` over an equal-length batch (ts [B, n],
    xs [B, n, obs]): flattened, with consecutive ids."""
    b, nb = ts_batch.shape
    return log_likelihood_stacked(
        params, ts_batch.reshape(-1), xs_batch.reshape(b * nb, -1),
        _batch_ids(b, nb, ts_batch.device), regular=regular,
        backend=backend)


@_highest_precision
def posterior_mean_stacked(params: LEGParams, ts: Tensor, xs: Tensor,
                           series_ids: Tensor, regular: bool = False,
                           backend: str = "auto") -> Tensor:
    """The posterior means of the stacked series' latents [N, r] (rows
    line up with the inputs), by one solve of the block-diagonal K: the
    precision route (at float32 the conditioning bound of
    `_resolve_posterior_method` applies per series; short series keep
    their gaps moderate).  ``backend`` selects the engine and the
    emission."""
    n = ts.shape[0]
    k_cm, o_cm, v_cm, _ = _stacked_system(params, ts, xs, series_ids,
                                          regular, backend)
    if n < max(pt._TERMINAL, 2 * k_cm.shape[0]):
        diag, off, v = _cm_to_natural(k_cm, o_cm, v_cm, params.rank)
        return pt.solve(diag, off, v, backend=backend)[:n]
    x_pad, _ = pt.solve_cm(k_cm, o_cm, v_cm, backend=backend)
    return x_pad[:n]


@_highest_precision
def insample_posterior_stacked(params: LEGParams, ts: Tensor, xs: Tensor,
                               series_ids: Tensor, regular: bool = False,
                               backend: str = "auto"
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Stacked-series `insample_posterior` on the precision route (one
    solve and one selected inversion of the block-diagonal K): (mean
    [N, r], cov_diag [N, r, r], cov_off [N-1, r, r]).  The cov_off rows
    at series boundaries are exactly zero.  As `insample_posterior`,
    call it under ``torch.no_grad()`` when the parameters require
    grad."""
    n = ts.shape[0]
    k_cm, o_cm, v_cm, _ = _stacked_system(params, ts, xs, series_ids,
                                          regular, backend)
    if n < max(pt._TERMINAL, 2 * k_cm.shape[0]):
        diag, off, v = _cm_to_natural(k_cm, o_cm, v_cm, params.rank)
        mean = pt.solve(diag, off, v, backend=backend)
        cov_diag, cov_off = pt.inverse_blocks(diag, off, backend=backend)
        return mean[:n], cov_diag[:n], cov_off[:n - 1]
    mean_pad, _ = pt.solve_cm(k_cm, o_cm, v_cm, backend=backend)
    cov_diag_pad, cov_off_pad = pt.inverse_blocks_cm(k_cm, o_cm,
                                                     backend=backend)
    return mean_pad[:n], cov_diag_pad[:n], cov_off_pad[:n - 1]


def _cm_rows_to_natural(rows_cm: Tensor, n: int) -> Tensor:
    """[s, C] chunk-major per-row scalars -> natural [n] (row c*s + j
    lives at [j, c]; padding rows dropped)."""
    s, cw = rows_cm.shape
    return rows_cm.T.reshape(cw * s)[:n]


@_highest_precision
def log_likelihood_per_series(params: LEGParams, ts: Tensor, xs: Tensor,
                              series_ids: Tensor, num_series: int,
                              regular: bool = False,
                              backend: str = "auto") -> Tensor:
    """The per-series marginal log-likelihoods [num_series] from one
    stacked pass (`log_likelihood_stacked` gives only their sum).

    ``series_ids`` sorted integers in [0, num_series); entry b equals
    log_likelihood(params, ts_b, xs_b).  Every term decomposes over the
    block-diagonal system: mahal_b = sum_{i in b} x_i.(LLT^{-1} x_i) -
    v_i.(K^{-1} v)_i, logdet_b = n_b log|2 pi LLT| + log|K_b| -
    log|Sigma_b^{-1}|, log|K_b| a segment sum of the per-row pivot
    log-dets (`partitioned.solve_and_ld_rows_cm`: kernels 8 and 9 on the
    card, one sweep for x and the rows) and log|Sigma_b^{-1}| one of the
    per-gap log|Q1|.  Differentiable through the analytic adjoints (one
    solve and one selected inversion)."""
    rank = params.rank
    llt = lambda_lambda_t(params)
    n = ts.shape[0]
    counts = _segment_sum(torch.ones_like(xs[:, 0]), series_ids, num_series)
    x_llt_inv = torch.linalg.solve(llt, xs.T).T
    llt_mahal_b = _segment_sum(torch.sum(x_llt_inv * xs, dim=1), series_ids,
                               num_series)
    llt_logdet_b = counts * torch.linalg.slogdet(2.0 * math.pi * llt)[1]

    k_cm, o_cm, v_cm, _, lq_cm = _stacked_system(
        params, ts, xs, series_ids, regular, backend, return_sig_rows=True)
    # gap i lies between points i and i+1 of one series (masked gaps are
    # exactly zero, so their attribution does not matter)
    sig_logdet_b = -_segment_sum(_cm_rows_to_natural(lq_cm, n), series_ids,
                                 num_series)
    if n < max(pt._TERMINAL, 2 * k_cm.shape[0]):
        diag, off, v = _cm_to_natural(k_cm, o_cm, v_cm, rank)
        x = pt.solve(diag, off, v, backend=backend)[:n]
        # the identity padding rows come last: the first n rows' pivots
        # are those of the n-row system (sequential, differentiable)
        ld_rows = pt.logdet_rows(diag[:n], off[:n - 1])
        v_nat = v[:n]
    else:
        x_pad, rows_cm = pt.solve_and_ld_rows_cm(k_cm, o_cm, v_cm,
                                                 backend=backend)
        x = x_pad[:n]
        ld_rows = _cm_rows_to_natural(rows_cm, n)
        v_nat = v_cm.permute(2, 0, 1).reshape(-1, rank)[:n]
    k_mahal_b = _segment_sum(torch.sum(v_nat * x, dim=1), series_ids,
                             num_series)
    k_logdet_b = _segment_sum(ld_rows, series_ids, num_series)
    mahal_b = llt_mahal_b - k_mahal_b
    logdet_b = llt_logdet_b + k_logdet_b - sig_logdet_b
    return -0.5 * (mahal_b + logdet_b)


# ---------------------------------------------------------------------------
# The posterior and predictions.
# ---------------------------------------------------------------------------


@_highest_precision
def posterior_precision(params: LEGParams, ts: Tensor,
                        backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """K = Sigma^{-1} + I_N (x) B^T LLT^{-1} B (reference models.py:254-268):
    ([N, r, r] diag, [N-1, r, r] lower-off)."""
    llt = lambda_lambda_t(params)
    sig_inv_diag, sig_inv_off = peg_precision(g_matrix(params), ts, backend)
    bt_llt_inv_b = params.b.T @ torch.linalg.solve(llt, params.b)
    return sig_inv_diag + bt_llt_inv_b[None], sig_inv_off


@_highest_precision
def compute_v(params: LEGParams, xs: Tensor) -> Tensor:
    """v = (LLT^{-1} x) B (reference models.py:270-280)."""
    llt = lambda_lambda_t(params)
    return torch.linalg.solve(llt, xs.T).T @ params.b


POSTERIOR_METHODS = ("auto", "precision", "smoother")


def _resolve_posterior_method(method: str, dtype) -> str:
    """Resolve the posterior route.  "precision" factorises the
    block-tridiagonal posterior precision K (partitioned engine); its
    condition number scales like 1/(dt * lambda_min(sym G)), beyond
    1/eps_f32 for very smooth learned processes, so it is the float64
    route.  "smoother" is the parallel Kalman/RTS smoother, safe in
    float32.  "auto" picks by dtype."""
    if method not in POSTERIOR_METHODS:
        raise ValueError(
            f"method must be one of {POSTERIOR_METHODS}, got {method!r}")
    if method == "auto":
        return "precision" if dtype == torch.float64 else "smoother"
    return method


def _smoother(params: LEGParams, ts: Tensor, xs: Tensor, regular: bool,
              backend: str, cross: bool):
    """The smoother route: (means, covs), with the lag-1 cross-covariances
    if ``cross``, by the parallel RTS smoother (on the card at float32
    every gap's (A, Q) from the (e, Q) kernel); above
    `kalman.SMOOTHER_BLOCK` points the blocked one, whose working memory
    is one block's."""
    from cyclic_gps_tpu_torch.baselines import kalman

    ssm = kalman.leg_to_ssm(params, ts, regular=regular, backend=backend)
    if ts.shape[0] > kalman.SMOOTHER_BLOCK:
        return kalman.smooth_parallel_full_blocked(ssm, xs,
                                                   kalman.SMOOTHER_BLOCK)
    return (kalman.smooth_parallel_full if cross
            else kalman.smooth_parallel)(ssm, xs)


@_highest_precision
def posterior_mean(params: LEGParams, ts: Tensor, xs: Tensor,
                   regular: bool = False, method: str = "auto",
                   backend: str = "auto") -> Tensor:
    """Posterior mean of the latent z at the observation times [N, r].
    ``method``: see `_resolve_posterior_method`, resolved by the model's
    dtype (the JAX package reads the timestamps'; here float64
    timestamps may drive a float32 model); "precision" is one solve of
    the posterior precision K emitted chunk-major, "smoother" the
    parallel RTS smoother (`_smoother`).  ``backend`` selects the engine
    and the emission only."""
    if _resolve_posterior_method(method, params.b.dtype) == "smoother":
        return _smoother(params, ts, xs, regular, backend, cross=False)[0]
    n = ts.shape[0]
    s = pt.default_chunk_len(n)
    if n < max(pt._TERMINAL, 2 * s):
        k_diag, k_off = posterior_precision(params, ts, backend)
        return pt.solve(k_diag, k_off, compute_v(params, xs),
                        backend=backend)
    k_cm, o_cm, v_cm, _ = _k_system_chunked(params, ts, xs, s, regular,
                                            backend)
    x_pad, _ = pt.solve_cm(k_cm, o_cm, v_cm, backend=backend)
    return x_pad[:n]


@_highest_precision
def insample_posterior(params: LEGParams, ts: Tensor, xs: Tensor,
                       regular: bool = False, method: str = "auto",
                       backend: str = "auto"
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Posterior mean, marginal covariances and lag-1 cross-covariances of
    the latent z at the observation times (reference models.py:282-298):
    (mean [N, r], cov_diag [N, r, r], cov_off [N-1, r, r]) with
    cov_off[i] = Cov(z_{i+1}, z_i | x).

    The precision route: one solve (`partitioned.solve_cm`) and one
    selected inversion (`partitioned.inverse_blocks_cm`) of K.  On the
    card (``backend="auto"`` or "cuda") K is emitted by the K-system
    kernel at float32 and both engine calls run their kernels at every
    ladder level.  The selected inversion's kernels have no backward:
    call this under ``torch.no_grad()`` when the parameters require
    grad.  The smoother route (float32 "auto"): `_smoother` with the
    lag-1 cross-covariances.  ``method``: see `posterior_mean`."""
    n = ts.shape[0]
    if _resolve_posterior_method(method, params.b.dtype) == "smoother":
        return _smoother(params, ts, xs, regular, backend, cross=True)
    s = pt.default_chunk_len(n)
    if n < max(pt._TERMINAL, 2 * s):
        k_diag, k_off = posterior_precision(params, ts, backend)
        mean = pt.solve(k_diag, k_off, compute_v(params, xs),
                        backend=backend)
        cov_diag, cov_off = pt.inverse_blocks(k_diag, k_off,
                                              backend=backend)
        return mean, cov_diag, cov_off
    k_cm, o_cm, v_cm, _ = _k_system_chunked(params, ts, xs, s, regular,
                                            backend)
    mean_pad, _ = pt.solve_cm(k_cm, o_cm, v_cm, backend=backend)
    cov_diag_pad, cov_off_pad = pt.inverse_blocks_cm(k_cm, o_cm,
                                                     backend=backend)
    return mean_pad[:n], cov_diag_pad[:n], cov_off_pad[: n - 1]


def _forecast(rank, eg, ip_mean, ip_cov):
    """Extrapolate one step through the prior (reference models.py:394-407),
    batched over leading dims; eg = expm(-0.5 |dt| G) oriented so that
    Cov(z_target, z_anchor) = eg."""
    eye = torch.eye(rank, dtype=eg.dtype, device=eg.device).expand_as(eg)
    joint_mean = eg.new_zeros(eg.shape[:-2] + (2 * rank,))
    joint_cov = build_2x2_block(eye, eg.transpose(-1, -2), eg, eye)
    return gaussian_stitch(joint_mean, joint_cov, ip_mean, ip_cov)


def _interpolate(rank, eg1, eg2, prev_mean, prev_cov, prev_cross, next_mean,
                 next_cov):
    """Condition a between-points latent on both neighbours (reference
    models.py:409-451), batched over leading dims.  eg1 = expm(-0.5
    (t* - t_prev) G), eg2 = expm(-0.5 (t_next - t*) G); prev_cross =
    Cov(z_next, z_prev | x)."""
    eye = torch.eye(rank, dtype=eg1.dtype, device=eg1.device).expand_as(eg1)
    eg3 = eg1 @ eg2
    t = lambda a: a.transpose(-1, -2)  # noqa: E731
    joint_mean = eg1.new_zeros(eg1.shape[:-2] + (3 * rank,))
    joint_cov = build_3x3_block(eye, t(eg3), t(eg1), eg3, eye, eg2, eg1,
                                t(eg2), eye)
    joint_ip_mean = torch.cat([prev_mean, next_mean], dim=-1)
    joint_ip_cov = build_2x2_block(prev_cov, t(prev_cross), prev_cross,
                                   next_cov)
    return gaussian_stitch(joint_mean, joint_cov, joint_ip_mean,
                           joint_ip_cov)


def _intercast_geometry(ts: Tensor, target_ts: Tensor, thresh: float):
    """(is_back, is_fwd, hit_first, hit_last, prev_i, next_i, off_i,
    d_back, d_fwd, d1, d2) shared by both intercast implementations;
    ``target_ts`` must be sorted.

    Dense grids (P >= 2N) take the dual search, as the JAX package does:
    the N observations are searched into the P sorted targets and
    idx_t = #{i: ts_i < target_t} is recovered by a scatter-add and a
    cumulative sum; the anchor times come from a scatter-max + cummax
    (scatter-min + reversed cummin).  Index p marks a dropped update, so
    the scatters go into p + 1 slots and the last is cut off."""
    n = ts.shape[0]
    p = target_ts.shape[0]
    if p >= 2 * n:
        # q_i = #{t: target_t <= ts_i}; then ts_i < target_t <=> q_i <= t
        q = torch.searchsorted(target_ts, ts, right=True)
        idx = torch.cumsum(torch.zeros(p + 1, dtype=q.dtype,
                                       device=ts.device).scatter_add_(
            0, q, torch.ones_like(q))[:p], 0)
        zmax = torch.full((p + 1,), -math.inf, dtype=ts.dtype,
                          device=ts.device).scatter_reduce_(0, q, ts, "amax")
        ts_prev = torch.maximum(torch.cummax(zmax[:p], 0).values, ts[0])
        qn = torch.where(q >= 1, q - 1, p)
        zmin = torch.full((p + 1,), math.inf, dtype=ts.dtype,
                          device=ts.device).scatter_reduce_(0, qn, ts, "amin")
        ts_next = torch.minimum(
            torch.flip(torch.cummin(torch.flip(zmin[:p], (0,)), 0).values,
                       (0,)), ts[-1])
    else:
        idx = torch.searchsorted(ts, target_ts)
        ts_prev = ts[torch.clamp(idx - 1, 0, n - 1)]
        ts_next = ts[torch.clamp(idx, 0, n - 1)]
    is_back = idx == 0
    is_fwd = idx == n
    hit_first = torch.abs(target_ts - ts[0]) <= thresh
    hit_last = torch.abs(target_ts - ts[-1]) <= thresh
    prev_i = torch.clamp(idx - 1, 0, n - 1)
    next_i = torch.clamp(idx, 0, n - 1)
    off_i = torch.clamp(idx - 1, 0, max(n - 2, 0))
    # time gaps, clamped nonnegative so unused branches stay finite
    d_back = torch.clamp(ts[0] - target_ts, min=0.0)
    d_fwd = torch.clamp(target_ts - ts[-1], min=0.0)
    d1 = torch.clamp(target_ts - ts_prev, min=0.0)
    d2 = torch.clamp(ts_next - target_ts, min=0.0)
    return (is_back, is_fwd, hit_first, hit_last, prev_i, next_i, off_i,
            d_back, d_fwd, d1, d2)


@_highest_precision
def intercast(params: LEGParams, ip_mean: Tensor, ip_cov_diag: Tensor,
              ip_cov_off: Tensor, ts: Tensor, target_ts: Tensor,
              thresh: float = 1e-10,
              backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Latent predictive moments (mean [P, r], cov [P, r, r]) at sorted
    target times: backward forecast, forward forecast or interpolation
    per target, with exact passthrough where a target coincides with the
    first or last observation (reference models.py:454-514).

    Element-major throughout ([*, *, P]), as the JAX package's: the
    interpolation stitch solves its 2r x 2r system with the element-major
    Cholesky, and the forecast stitches have closed forms.  The four
    exponential batches run in one call: the (e, Q) kernel with Q
    discarded for float32 on the card, the plain Pade-13 exponential
    elsewhere.  `_intercast_batched` is the per-target oracle."""
    (is_back, is_fwd, hit_first, hit_last, prev_i, _, _,
     d_back, d_fwd, d1, d2) = _intercast_geometry(ts, target_ts, thresh)
    m_em, cd_em = sb.vec_to_em(ip_mean), sb.to_em(ip_cov_diag)
    return _intercast_em(
        params, ip_mean, ip_cov_diag, ip_cov_off,
        (is_back, is_fwd, hit_first, hit_last, prev_i, d_back, d_fwd, d1,
         d2), (m_em[:, :1], cd_em[:, :, :1]), (m_em[:, -1:], cd_em[:, :, -1:]),
        backend)


def _intercast_em(params, ip_mean, ip_cov_diag, ip_cov_off, geometry,
                  first, last, backend):
    """`intercast` on a given geometry (is_back, is_fwd, hit_first,
    hit_last, prev_i, d_back, d_fwd, d1, d2; each [P]), with the moments
    of the series' first and last observations ``first`` and ``last``
    ((mean [r, 1 or P], cov [r, r, 1 or P]), per target where P
    targets belong to several series).  ``prev_i`` indexes the rows of
    ``ip_mean``; an interpolation target's neighbours are rows prev_i and
    prev_i + 1 and their cross-covariance ip_cov_off[prev_i]."""
    rank = params.rank
    g = g_matrix(params)
    dtype = g.dtype
    (is_back, is_fwd, hit_first, hit_last, prev_i, d_back, d_fwd, d1,
     d2) = geometry
    p = prev_i.shape[0]

    gaps = torch.cat([d_back, d_fwd, d1, d2]).to(dtype)  # [4P]
    if dtype == torch.float32 and pt.resolve_backend(backend, gaps) == "cuda":
        egs = transition_and_noise_em(g, gaps, backend)[0]
    else:
        from cyclic_gps_tpu_torch.ops.expm_em import expm_em

        egs = expm_em(-0.5 * gaps[None, None, :] * g[:, :, None])
    eg_back, eg_fwd = egs[:, :, :p], egs[:, :, p:2 * p]
    eg1, eg2 = egs[:, :, 2 * p:3 * p], egs[:, :, 3 * p:]

    # the interpolation anchors' moments: one row gather of a packed
    # [N, 2r + 3r^2] matrix (m_i, m_{i+1}, cd_i, cd_{i+1}, co_i) by prev_i;
    # for every interpolation target next_i == prev_i + 1 and off_i ==
    # prev_i, and the other targets read finite values that are discarded
    n_obs = ip_mean.shape[0]
    r2 = rank * rank
    z_pack = torch.cat([
        ip_mean,
        torch.cat([ip_mean[1:], ip_mean[-1:]], dim=0),
        ip_cov_diag.reshape(n_obs, r2),
        torch.cat([ip_cov_diag[1:], ip_cov_diag[-1:]],
                  dim=0).reshape(n_obs, r2),
        torch.cat([ip_cov_off, ip_cov_off.new_zeros((1, rank, rank))],
                  dim=0).reshape(n_obs, r2),
    ], dim=1)
    z_g = z_pack[prev_i].T  # [2r + 3r^2, P]
    m_prev, m_next = z_g[:rank], z_g[rank:2 * rank]
    p_prev = z_g[2 * rank:2 * rank + r2].reshape(rank, rank, p)
    p_next = z_g[2 * rank + r2:2 * rank + 2 * r2].reshape(rank, rank, p)
    c_off = z_g[2 * rank + 2 * r2:].reshape(rank, rank, p)

    eye = sb.eye_em(rank, g)
    mm = sb.matmul

    def forecast_em(eg, m_a, p_a):
        # the anchor's conditioning covariance is I: T = eg (closed form)
        mean = sb.matvec(eg, m_a.expand(rank, p))
        eg_pa = mm(eg, p_a.expand(rank, rank, p))
        return mean, eye - mm(eg, eg, tb=True) + mm(eg_pa, eg, tb=True)

    # backward forecast: Cov(z_target, z_first) = expm(-.5 d G)^T
    mean_b, cov_b = forecast_em(sb.transpose(eg_back), *first)
    # forward forecast: Cov(z_target, z_last) = expm(-.5 d G)
    mean_f, cov_f = forecast_em(eg_fwd, *last)

    # interpolation: condition z_target on (z_prev, z_next)
    eg3 = mm(eg1, eg2)
    eye_b = eye.expand(rank, rank, p)
    sxx = torch.cat([torch.cat([eye_b, sb.transpose(eg3)], dim=1),
                     torch.cat([eg3, eye_b], dim=1)], dim=0)  # [2r, 2r, P]
    sxy = torch.cat([sb.transpose(eg1), eg2], dim=0)  # [2r, r, P]
    L, invd = sb.cholesky(sxx)
    t_t = sb.solve_lower_t(L, invd, sb.solve_lower(L, invd, sxy))
    mean_i = sb.matvec(t_t, torch.cat([m_prev, m_next], dim=0), ta=True)
    s_x = torch.cat([torch.cat([p_prev, sb.transpose(c_off)], dim=1),
                     torch.cat([c_off, p_next], dim=1)], dim=0)
    cov_i = (eye - mm(t_t, sxy, ta=True)
             + mm(mm(t_t, s_x, ta=True), t_t))

    def select(mask, a_m, a_c, b_m, b_c):
        # a select, not arithmetic masking: boundary-hit lanes make the
        # interpolation system exactly singular, and 0 * nan is nan
        return (torch.where(mask[None, :], a_m, b_m),
                torch.where(mask[None, None, :], a_c, b_c))

    mean, cov = select(is_back, mean_b, cov_b, mean_i, cov_i)
    mean, cov = select(is_fwd, mean_f, cov_f, mean, cov)
    # exact hits on the first/last observation pass through unchanged
    mean, cov = select(hit_first, first[0].expand(rank, p),
                       first[1].expand(rank, rank, p), mean, cov)
    mean, cov = select(hit_last, last[0].expand(rank, p),
                       last[1].expand(rank, rank, p), mean, cov)
    return sb.vec_from_em(mean), sb.from_em(cov)


@_highest_precision
def _intercast_batched(params: LEGParams, ip_mean: Tensor,
                       ip_cov_diag: Tensor, ip_cov_off: Tensor, ts: Tensor,
                       target_ts: Tensor,
                       thresh: float = 1e-10) -> Tuple[Tensor, Tensor]:
    """Per-target (batch-major) intercast built from the reference's
    Gaussian stitches: the readable oracle `intercast` is tested against.
    Builds [P, 3r, 3r] stitches; not for dense P."""
    from cyclic_gps_tpu_torch.ops.expm_em import expm_em

    rank = params.rank
    g = g_matrix(params)
    p = target_ts.shape[0]
    (is_back, is_fwd, hit_first, hit_last, prev_i, next_i, off_i,
     d_back, d_fwd, d1, d2) = _intercast_geometry(ts, target_ts, thresh)
    gaps = torch.cat([d_back, d_fwd, d1, d2]).to(g.dtype)
    egs = sb.from_em(expm_em(-0.5 * gaps[None, None, :] * g[:, :, None]))
    eg_back, eg_fwd = egs[:p], egs[p:2 * p]
    eg1, eg2 = egs[2 * p:3 * p], egs[3 * p:]

    def first(a):
        return a[:1].expand((p,) + a.shape[1:])

    def last(a):
        return a[-1:].expand((p,) + a.shape[1:])

    m_b, v_b = _forecast(rank, eg_back.transpose(-1, -2), first(ip_mean),
                         first(ip_cov_diag))
    m_f, v_f = _forecast(rank, eg_fwd, last(ip_mean), last(ip_cov_diag))
    m_i, v_i = _interpolate(rank, eg1, eg2, ip_mean[prev_i],
                            ip_cov_diag[prev_i], ip_cov_off[off_i],
                            ip_mean[next_i], ip_cov_diag[next_i])
    mean = torch.where(is_back[:, None], m_b,
                       torch.where(is_fwd[:, None], m_f, m_i))
    cov = torch.where(is_back[:, None, None], v_b,
                      torch.where(is_fwd[:, None, None], v_f, v_i))
    mean = torch.where(hit_first[:, None], first(ip_mean), mean)
    cov = torch.where(hit_first[:, None, None], first(ip_cov_diag), cov)
    mean = torch.where(hit_last[:, None], last(ip_mean), mean)
    cov = torch.where(hit_last[:, None, None], last(ip_cov_diag), cov)
    return mean, cov


def predictive_posterior(params: LEGParams, ts: Tensor, xs: Tensor,
                         target_ts: Tensor, method: str = "auto",
                         backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Latent predictive moments at sorted target times (reference
    models.py:516-528): `insample_posterior`, then `intercast`."""
    mean, cov_diag, cov_off = insample_posterior(params, ts, xs,
                                                 method=method,
                                                 backend=backend)
    return intercast(params, mean, cov_diag, cov_off, ts, target_ts,
                     backend=backend)


@_highest_precision
def make_predictions(params: LEGParams, ts: Tensor, xs: Tensor,
                     target_ts: Tensor, include_obs_noise: bool = False,
                     method: str = "auto",
                     backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Data-space predictive moments (mean [P, obs], cov [P, obs, obs]) at
    sorted target times (reference models.py:530-546).  With
    ``include_obs_noise=False`` this matches the reference, which omits
    Lambda Lambda^T from the predictive covariance; True adds it.
    ``target_ts`` has the dtype of ``ts``."""
    lat_mean, lat_cov = predictive_posterior(params, ts, xs, target_ts,
                                             method=method, backend=backend)
    mean = lat_mean @ params.b.T
    cov = params.b[None] @ lat_cov @ params.b.T[None]
    if include_obs_noise:
        cov = cov + lambda_lambda_t(params)[None]
    return mean, cov


def _intercast_geometry_batch(ts_batch: Tensor, target_batch: Tensor,
                              thresh: float):
    """`_intercast_geometry` of B equal-length series at once (ts [B, n],
    targets [B, P], each row sorted), flattened to B P targets:
    (geometry as `_intercast_em` takes it, with prev_i indexing the B n
    stacked rows, and each target's series' first and last row)."""
    b, n = ts_batch.shape
    idx = torch.searchsorted(ts_batch, target_batch)  # #{i: ts_i < t}
    first, last = ts_batch[:, :1], ts_batch[:, -1:]
    prev_l = torch.clamp(idx - 1, 0, n - 1)
    ts_prev = torch.gather(ts_batch, 1, prev_l)
    ts_next = torch.gather(ts_batch, 1, torch.clamp(idx, 0, n - 1))
    base = n * torch.arange(b, device=ts_batch.device)[:, None]
    ends = (base.expand_as(idx).reshape(-1),
            (base + n - 1).expand_as(idx).reshape(-1))
    geometry = tuple(x.reshape(-1) for x in (
        idx == 0, idx == n,
        torch.abs(target_batch - first) <= thresh,
        torch.abs(target_batch - last) <= thresh,
        prev_l + base,
        # time gaps, clamped nonnegative so unused branches stay finite
        torch.clamp(first - target_batch, min=0.0),
        torch.clamp(target_batch - last, min=0.0),
        torch.clamp(target_batch - ts_prev, min=0.0),
        torch.clamp(ts_next - target_batch, min=0.0)))
    return geometry, ends


@_highest_precision
def make_predictions_batch(params: LEGParams, ts_batch: Tensor,
                           xs_batch: Tensor, target_batch: Tensor,
                           include_obs_noise: bool = False,
                           regular: bool = False,
                           backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """`make_predictions` over an equal-length batch of B independent
    series (ts [B, n], xs [B, n, obs], targets [B, P], each row sorted):
    (mean [B, P, obs], cov [B, P, obs, obs]).

    The posterior mean and selected inversion run as one stacked
    block-diagonal system over all B series
    (`insample_posterior_stacked`, the precision route; the JAX package's
    too), then one `intercast` stitch over all B P targets, each reading
    its own series' rows.  Call it under ``torch.no_grad()`` when the
    parameters require grad."""
    b, nb = ts_batch.shape
    p = target_batch.shape[1]
    rank = params.rank
    mean, cov_diag, cov_off = insample_posterior_stacked(
        params, ts_batch.reshape(-1), xs_batch.reshape(b * nb, -1),
        _batch_ids(b, nb, ts_batch.device), regular=regular,
        backend=backend)
    geometry, (first_i, last_i) = _intercast_geometry_batch(
        ts_batch, target_batch, 1e-10)
    m_em, cd_em = sb.vec_to_em(mean), sb.to_em(cov_diag)
    lat_mean, lat_cov = _intercast_em(
        params, mean, cov_diag, cov_off, geometry,
        (m_em[:, first_i], cd_em[:, :, first_i]),
        (m_em[:, last_i], cd_em[:, :, last_i]), backend)
    lat_mean = lat_mean.reshape(b, p, rank)
    lat_cov = lat_cov.reshape(b, p, rank, rank)
    pred_mean = lat_mean @ params.b.T
    pred_cov = params.b[None, None] @ lat_cov @ params.b.T[None, None]
    if include_obs_noise:
        pred_cov = pred_cov + lambda_lambda_t(params)[None, None]
    return pred_mean, pred_cov


@_highest_precision
def sample_from_prior(params: LEGParams, generator: torch.Generator,
                      ts: Tensor, num: int = 1) -> Tuple[Tensor, Tensor]:
    """Joint samples (zs [num, N, r], xs [num, N, obs]) from the LEG prior
    on grid ``ts``, by the exact discrete-time bridge: for gap d,
    z_{i+1} = expm(-0.5 d G) z_i + w_i with Cov(w_i) = I - A A^T, then
    x_i = B z_i + Lambda e_i.  ``generator`` takes the place of the JAX
    key (the two give different numbers from one seed); its draws are
    made on its own device and moved to the parameters'."""
    rank = params.rank
    g = g_matrix(params)
    diffs = (ts[1:] - ts[:-1]).to(g.dtype)
    a, q = transition_and_noise(g, diffs)
    q_chol = torch.linalg.cholesky(
        q + 1e-12 * torch.eye(rank, dtype=g.dtype, device=g.device))

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=g.dtype,
                           device=generator.device).to(g.device)

    z = normal(num, rank)
    ws = normal(diffs.shape[0], num, rank)
    zs = [z]
    for i in range(diffs.shape[0]):
        z = z @ a[i].T + ws[i] @ q_chol[i].T
        zs.append(z)
    zs = torch.stack(zs, dim=1)  # [num, N, rank]
    es = normal(num, ts.shape[0], params.obs_dim)
    return zs, zs @ params.b.T + es @ lambda_matrix(params).T
