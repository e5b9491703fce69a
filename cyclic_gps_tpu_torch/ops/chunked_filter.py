"""Chunk-parallel conditional Kalman filter: the O(N r^2 q) solve of the
celerite family (PyTorch).

Counterpart of ``cyclic_gps_tpu/ops/chunked_filter.py``.  The series is
cut into C chunks of s rows, as the partitioned engine cuts it.  Per
chunk a Kalman filter runs CONDITIONED on the unknown boundary latent z:
every filter mean is affine in z (m_j = a_j + F_j z) while the
covariances and gains are not, so the chunk's innovation quadratic is
z^T H z - 2 h^T z + c0, plus sum log|S_j|, and its end-of-chunk map is
z_next | z ~ N(a_s + F_s z, P_s).  The boundary latents then form a
C-node Gaussian chain whose block-tridiagonal precision is assembled
from (H, h, F_s, a_s, P_s^{-1}) and finished by the partitioned engine
(`boundary_loglik`, `boundary_loglik_em`).  Only Q -- never Q^{-1} --
appears, so masked or padded gaps (e = I, Q = 0) are exact no-op steps.

`conditional_filter_plain`, `_collect_plain` and `_adjoint_plain` are the
JAX package's XLA twins (``conditional_filter_xla``,
``conditional_filter_collect_xla``, ``conditional_filter_adjoint_xla``);
`conditional_filter` is differentiable through the analytic O(r^2 q)
adjoint (one collect pass, then the descending adjoint), as the JAX
custom VJP is.  On the card the celerite family runs the same recursion
as CUDA kernels (ops/celerite_cuda.py); the boundary chain's engine runs
its sweep kernels at every ladder level (``backend``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import partitioned as pt
from . import smallblock as sb

Tensor = torch.Tensor


class ChunkFilterOut(NamedTuple):
    """Per-chunk conditional-filter sufficient statistics (batch-major).

    H [C, r, r], h [C, r], c0 [C], ld_s [C]: the innovation quadratic
    z^T H z - 2 h^T z + c0 and sum log|S_j| of chunk c as a function of
    its boundary latent z.  f_map [C, r, r], a_map [C, r], p_map
    [C, r, r]: the boundary map z_{b_{c+1}} | z_{b_c} = z ~
    N(a + F z, P) (row C-1's map crosses the series end and is unused).
    """

    H: Tensor
    h: Tensor
    c0: Tensor
    ld_s: Tensor
    f_map: Tensor
    a_map: Tensor
    p_map: Tensor


def _init_state(c: int, r: int, like: Tensor):
    z = like.new_zeros
    return (z((c, r)), torch.eye(r, dtype=like.dtype, device=like.device)
            .expand(c, r, r), z((c, r, r)), z((c, r, r)), z((c, r)), z((c,)),
            z((c,)))


def _update(bmat, lam, a0, F0, P0, y, v):
    """The masked innovation update of one step (every chunk at once):
    the step's intermediates and the post-update (a, F, P)."""
    vv = v[:, None, None]
    S = torch.einsum("ai,cij,bj->cab", bmat, P0, bmat) + lam[None]
    Si = torch.linalg.inv(S)
    resid = y - torch.einsum("ai,ci->ca", bmat, a0)
    Gj = torch.einsum("ai,cij->caj", bmat, F0)            # [C, q, r]
    SiG = torch.einsum("cab,cbj->caj", Si, Gj)
    Sr = torch.einsum("cab,cb->ca", Si, resid)
    PBt = torch.einsum("cij,aj->cia", P0, bmat)           # [C, r, q]
    K = torch.einsum("cia,cab->cib", PBt, Si)             # [C, r, q]
    a = a0 + v[:, None] * torch.einsum("cia,ca->ci", K, resid)
    F = F0 - vv * torch.einsum("cia,caj->cij", K, Gj)
    P = P0 - vv * torch.einsum("cia,cja->cij", K, PBt)
    return S, Si, resid, Gj, SiG, Sr, PBt, K, a, F, P


def _filter(e_cm, q_cm, bmat, lam, y_cm, valid_cm, collect: bool):
    s, c, r, _ = e_cm.shape
    a, F, P, H, h, c0, ld = _init_state(c, r, e_cm)
    hist = ([], [], [])
    for j in range(s):
        e, q, y, v = e_cm[j], q_cm[j], y_cm[j], valid_cm[j]
        if collect:
            for stack, x in zip(hist, (a, F, P)):
                stack.append(x)
        S, _, resid, Gj, SiG, Sr, _, _, a, F, P = _update(bmat, lam, a, F,
                                                          P, y, v)
        vv = v[:, None, None]
        H = H + vv * torch.einsum("cai,caj->cij", Gj, SiG)
        h = h + v[:, None] * torch.einsum("cai,ca->ci", Gj, Sr)
        c0 = c0 + v * torch.einsum("ca,ca->c", resid, Sr)
        ld = ld + v * torch.linalg.slogdet(S)[1]
        # predict through the following gap
        a = torch.einsum("cij,cj->ci", e, a)
        F = torch.einsum("cij,cjk->cik", e, F)
        P = torch.einsum("cij,cjk,clk->cil", e, P, e) + q
    out = ChunkFilterOut(H, h, c0, ld, F, a, P)
    if collect:
        return out, tuple(torch.stack(x, dim=0) for x in hist)
    return out


def conditional_filter_plain(e_cm: Tensor, q_cm: Tensor, bmat: Tensor,
                             lam: Tensor, y_cm: Tensor,
                             valid_cm: Tensor) -> ChunkFilterOut:
    """Batched conditional Kalman filters, one per chunk.

    e_cm / q_cm [s, C, r, r]: transition / process noise of the gap
    FOLLOWING row j of chunk c (row s-1's gap crosses into chunk c+1);
    invalid gaps MUST carry e = I, q = 0 (exact no-op).  y_cm [s, C, q]
    observations; valid_cm [s, C] 1.0 where row (j, c) is a real
    observation.  bmat [q, r], lam [q, q] observation model."""
    return _filter(e_cm, q_cm, bmat, lam, y_cm, valid_cm, collect=False)


def _collect_plain(e_cm, q_cm, bmat, lam, y_cm, valid_cm):
    """`conditional_filter_plain` that also returns the per-step
    pre-update states (a_j [s, C, r], F_j, P_j [s, C, r, r]) -- the
    residual stream the analytic adjoint consumes.  Run by the backward
    only."""
    return _filter(e_cm, q_cm, bmat, lam, y_cm, valid_cm, collect=True)


def _adjoint_plain(e_cm, q_cm, bmat, lam, y_cm, valid_cm, hist, cots):
    """Analytic adjoint of `conditional_filter_plain`, O(r^2 q) per step.
    ``hist`` is `_collect_plain`'s (a_j, F_j, P_j); ``cots`` a
    ChunkFilterOut of output cotangents.  Returns (ebar, qbar, Bbar,
    Lambar, ybar), the cotangents of (e_cm, q_cm, bmat, lam, y_cm).

    The accumulators (H, h, c0, ld) pass through every step, so their
    cotangents are step-constant; the carried (abar, Fbar, Pbar) run a
    reverse recursion whose coefficients are recomputed from the stored
    pre-update state.  Each line transposes one forward einsum."""
    Hb, hb, c0b, ldb, Fsb, asb, Psb = cots
    a_h, F_h, P_h = hist
    s = e_cm.shape[0]
    abar_n, Fbar_n, Pbar_n = asb, Fsb, Psb
    Bbar = torch.zeros_like(bmat)
    Lambar = torch.zeros_like(lam)
    ebars, qbars, ybars = [None] * s, [None] * s, [None] * s
    ein = torch.einsum
    for j in reversed(range(s)):
        e, y, v = e_cm[j], y_cm[j], valid_cm[j]
        a0, F0, P0 = a_h[j], F_h[j], P_h[j]
        vv = v[:, None, None]
        (_, Si, resid, Gj, SiG, Sr, PBt, K, a1, F1, P1) = _update(
            bmat, lam, a0, F0, P0, y, v)
        # ---- predict adjoint: a' = e a1, F' = e F1, P' = e P1 e^T + q
        qbars[j] = Pbar_n
        ebars[j] = (ein("ci,cj->cij", abar_n, a1)
                    + ein("cik,cjk->cij", Fbar_n, F1)
                    + ein("cik,ckl,cjl->cij", Pbar_n, e, P1)
                    + ein("cki,ckl,clj->cij", Pbar_n, e, P1))
        abar1 = ein("cji,cj->ci", e, abar_n)
        Fbar1 = ein("cji,cjk->cik", e, Fbar_n)
        Pbar1 = ein("cji,cjk,ckl->cil", e, Pbar_n, e)
        # ---- update adjoint ----
        Kbar = (ein("ci,ca->cia", abar1, resid)
                - ein("cij,caj->cia", Fbar1, Gj)
                - ein("cij,cja->cia", Pbar1, PBt)) * vv
        rbar = v[:, None] * (ein("cia,ci->ca", K, abar1)
                             + ein("cai,ci->ca", SiG, hb)
                             + 2.0 * c0b[:, None] * Sr)
        Gbar = vv * (-ein("cia,cij->caj", K, Fbar1)
                     + ein("cai,cij->caj", SiG, Hb + Hb.transpose(1, 2))
                     + ein("ca,ci->cai", Sr, hb))
        Sibar = (ein("cia,cib->cab", PBt, Kbar)
                 + vv * (ein("cai,cij,cbj->cab", Gj, Hb, Gj)
                         + ein("cai,ci,cb->cab", Gj, hb, resid)
                         + c0b[:, None, None] * ein("ca,cb->cab", resid,
                                                    resid)))
        PBtbar = (-vv * ein("cji,cja->cia", Pbar1, K)
                  + ein("cib,cab->cia", Kbar, Si))
        # slogdet grad = S^{-T}; inv grad = -S^{-T} Sibar S^{-T}
        SiT = Si.transpose(1, 2)
        Sbar = ((v * ldb)[:, None, None] * SiT
                - ein("cab,cbd,cde->cae", SiT, Sibar, SiT))
        abar_n = abar1 - ein("ai,ca->ci", bmat, rbar)
        Fbar_n = Fbar1 + ein("ai,caj->cij", bmat, Gbar)
        Pbar_n = (Pbar1 + ein("cia,aj->cij", PBtbar, bmat)
                  + ein("ai,cab,bj->cij", bmat, Sbar, bmat))
        ybars[j] = rbar
        Bbar = Bbar + (ein("cia,cij->caj", PBtbar, P0)
                       + ein("caj,cij->cai", Gbar, F0)
                       - ein("ca,ci->cai", rbar, a0)
                       + ein("cab,bi,cji->caj", Sbar, bmat, P0)
                       + ein("cba,bi,cij->caj", Sbar, bmat, P0)).sum(dim=0)
        Lambar = Lambar + Sbar.sum(dim=0)
    # the carry cotangents at j = 0 belong to the constant init and are
    # discarded
    st = torch.stack
    return st(ebars), st(qbars), Bbar, Lambar, st(ybars)


class _ConditionalFilter(torch.autograd.Function):
    """`conditional_filter_plain` with the analytic adjoint (the JAX
    ``_cf_fwd`` / ``_cf_bwd``): the forward stores only its inputs; the
    backward re-runs one collect pass, then `_adjoint_plain`."""

    @staticmethod
    def forward(ctx, e_cm, q_cm, bmat, lam, y_cm, valid_cm):
        ctx.save_for_backward(e_cm, q_cm, bmat, lam, y_cm, valid_cm)
        return tuple(conditional_filter_plain(e_cm, q_cm, bmat, lam, y_cm,
                                              valid_cm))

    @staticmethod
    def backward(ctx, *cots):
        ins = ctx.saved_tensors
        _, hist = _collect_plain(*ins)
        ebar, qbar, Bbar, Lambar, ybar = _adjoint_plain(*ins, hist, cots)
        return ebar, qbar, Bbar, Lambar, ybar, None


def conditional_filter(e_cm: Tensor, q_cm: Tensor, bmat: Tensor,
                       lam: Tensor, y_cm: Tensor,
                       valid_cm: Tensor) -> ChunkFilterOut:
    """Differentiable `conditional_filter_plain`: gradients run the
    analytic O(r^2 q) adjoint instead of autograd through the step loop."""
    return ChunkFilterOut(*_ConditionalFilter.apply(e_cm, q_cm, bmat, lam,
                                                    y_cm, valid_cm))


def boundary_loglik(out: ChunkFilterOut, nq_total, jitter: float = 0.0,
                    backend: str = "auto") -> Tensor:
    """Finish the marginal log-likelihood from per-chunk statistics.

    Integrates the boundary-latent chain exactly: a C-node Gaussian
    chain with block-tridiagonal precision assembled from the chunk
    quadratics and maps, solved by the partitioned engine (its sweep
    kernels on CUDA tensors unless ``backend="torch"``).  ``nq_total``
    is the number of observed SCALARS (valid rows times obs_dim) for the
    2-pi normalisation."""
    H, h, c0, ld_s, F, a, P = out
    c, r, _ = H.shape
    log2pi = math.log(2.0 * math.pi)
    eye_r = torch.eye(r, dtype=H.dtype, device=H.device)

    Pm, Fm, am = P[:-1], F[:-1], a[:-1]
    chol = torch.linalg.cholesky(Pm + jitter * eye_r[None])
    ld_p = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)
    pinv = torch.cholesky_solve(eye_r.expand_as(Pm), chol)
    pi_f = torch.einsum("cij,cjk->cik", pinv, Fm)
    pi_a = torch.einsum("cij,cj->ci", pinv, am)

    pad = H.new_zeros((1, r, r))
    eye0 = torch.cat([eye_r[None], H.new_zeros((c - 1, r, r))], dim=0)
    diag = (H + eye0                                  # prior z_0 ~ N(0, I)
            + torch.cat([torch.einsum("cki,ckj->cij", Fm, pi_f), pad], dim=0)
            + torch.cat([pad, pinv], dim=0))
    off = -pi_f                                       # block (c+1, c)
    vpad = h.new_zeros((1, r))
    rhs = (h + torch.cat([-torch.einsum("cki,ck->ci", Fm, pi_a), vpad], dim=0)
           + torch.cat([vpad, pi_a], dim=0))

    const = (nq_total * log2pi + r * log2pi
             + torch.sum(c0) + torch.sum(ld_s)
             + torch.sum(torch.einsum("ci,ci->c", am, pi_a))
             + torch.sum(ld_p) + (c - 1) * r * log2pi)
    mah, ld_k = pt.mahal_and_logdet(diag, off, rhs, jitter=jitter,
                                    backend=backend)
    return -0.5 * (const + ld_k - mah) + 0.5 * c * r * log2pi


def boundary_loglik_em(stats_em, nq_total, jitter: float = 0.0,
                       backend: str = "auto") -> Tensor:
    """`boundary_loglik` on ELEMENT-MAJOR per-chunk statistics.

    stats_em = (H [r, r, C], h [r, C], c0 [C], ld_s [C], F [r, r, C],
    a [r, C], P [r, r, C]) -- the layout the filter kernels produce.  Same
    math as `boundary_loglik`, with the element-major small-block algebra
    (floored float32 pivots) in place of the batched dense linalg."""
    H, h, c0, ld_s, F, a, P = stats_em
    r, _, c = H.shape
    log2pi = math.log(2.0 * math.pi)

    Pm, Fm, am = P[..., :-1], F[..., :-1], a[..., :-1]
    lp, invd = sb.cholesky(Pm, jitter=jitter)
    ld_p_total = 2.0 * sb.chol_log_diag_sum(lp)
    pinv = sb.solve_lower_t(
        lp, invd, sb.solve_lower(lp, invd, sb.identity_like(Pm)))
    pi_f = sb.matmul(pinv, Fm)
    pi_a = sb.solve_lower_t_vec(lp, invd, sb.solve_lower_vec(lp, invd, am))

    def pad_right(x):
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)

    def pad_left(x):
        return torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x], dim=-1)

    eye0 = torch.cat([sb.eye_em(r, H), H.new_zeros((r, r, c - 1))],
                     dim=-1)                         # prior z_0 ~ N(0, I)
    diag = H + eye0 + pad_right(sb.matmul(Fm, pi_f, ta=True)) \
        + pad_left(pinv)
    off = -pi_f                                      # block (c+1, c)
    rhs = h + pad_right(-sb.matvec(Fm, pi_a, ta=True)) + pad_left(pi_a)

    const = (nq_total * log2pi + r * log2pi
             + torch.sum(c0) + torch.sum(ld_s)
             + torch.sum(am * pi_a)
             + ld_p_total + (c - 1) * r * log2pi)
    mah, ld_k = pt.mahal_and_logdet(
        sb.from_em(diag), sb.from_em(off), sb.vec_from_em(rhs),
        jitter=jitter, backend=backend)
    return -0.5 * (const + ld_k - mah) + 0.5 * c * r * log2pi
