"""Kalman filtering for the LEG <-> SSM bridge (PyTorch): the filter
losses the float32 training default picks.

Counterpart of ``cyclic_gps_tpu/baselines/kalman.py`` (its SSM bridge,
sequential and parallel filters, blocked filter and steady-state check;
the smoothers are ROADMAP.md Queue 1 item 3b).  The LEG model on a grid
is exactly a discrete-time linear-Gaussian SSM:

    z_{k+1} = A z_k + w_k,   A = expm(-0.5 dt G),  Cov(w) = Q = I - A A^T
    x_k     = H z_k + e_k,   H = B,                Cov(e) = R = Lambda Lambda^T

(first-order variant: A = I - 0.5 dt G, Q = dt N N^T).

* `filter_sequential`: the classic O(T) filter, a Python loop over the
  steps; the exact oracle of the tests.
* `filter_parallel`: the O(log T)-depth associative-scan filter
  (Sarkka & Garcia-Fernandez, IEEE TAC 2021) on element-major ([r, r, T])
  tensors.  torch has no ``jax.lax.associative_scan``; `associative_scan`
  below builds JAX's own combination tree, so float32 results are grouped
  as the JAX package groups them.
* `filter_parallel_blocked` / `log_likelihood_blocked`: the same filter
  in blocks of `SMOOTHER_BLOCK` steps composed through the exact filtered
  (m, P) carry, each block under ``torch.utils.checkpoint`` (JAX:
  ``jax.checkpoint``), so value and gradient run in O(block) memory.

Per-step transition matrices (A, Q stacked [T, r, r]) let irregular grids
work; `leg_to_ssm` builds them from LEG parameters, where on the card at
float32 every gap's (A, Q) comes from the (e, Q) kernel
(``leg.transition_and_noise``: kernel 2, ``csrc/gap_emission.cu``; its
gradient replays the structured Pade-7).  The caller's ``backend`` is
threaded down to it (the JAX function reads ``resolve_backend("auto")``).
Initial state: m0 = 0, P0 = I; the first step predicts before updating.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import smallblock as sb
from cyclic_gps_tpu_torch.ops.expm_em import lu_solve_pivoted

Tensor = torch.Tensor


class SSM(NamedTuple):
    a: Tensor  # [T, r, r] per-step transition
    q: Tensor  # [T, r, r] per-step process noise
    h: Tensor  # [obs, r] observation matrix
    r: Tensor  # [obs, obs] observation noise


@leg._highest_precision
def leg_to_ssm(params: leg.LEGParams, ts: Tensor,
               use_approximation: bool = False, regular: bool = False,
               gap_mask: Optional[Tensor] = None,
               backend: str = "auto") -> SSM:
    """SSM matrices for the LEG model on grid ``ts``.

    The first "gap" (into step 0 from the stationary past) uses the gap
    between the first two points; the exact branch's predict from P0 = I
    lands back at the stationary I whatever it is.  ``regular=True``
    asserts a constant gap ts[1] - ts[0]: one (e, Q) broadcast over the
    grid.  ``gap_mask`` (natural [T]; gap i couples points i and i+1):
    transitions into masked-gap successors become (A = 0, Q = I), so the
    filter restarts per series; masked gaps' diffs are clamped to 1 first.
    Gaps are formed at the timestamps' precision, then cast to the model's
    dtype (float64 timestamps under a float32 model).
    """
    g = leg.g_matrix(params)
    rank = params.rank
    t = ts.shape[0]
    dtype = g.dtype
    tm = None
    if gap_mask is not None:
        # the transition INTO point j rides gap j-1; entry 0 (the
        # stationary pseudo-gap) stays unmasked
        tm = torch.cat([torch.ones(1, dtype=dtype, device=g.device),
                        gap_mask.to(dtype)[:t - 1]])

    def masked(a, q):
        if tm is None:
            return a, q
        eye = torch.eye(rank, dtype=dtype, device=g.device)[None]
        t3 = tm[:, None, None]
        return a * t3, q * t3 + (1.0 - t3) * eye

    def approx(d):
        eye = torch.eye(rank, dtype=dtype, device=g.device)[None]
        n_mat = leg.n_matrix(params)
        return (eye - 0.5 * d[:, None, None] * g[None],
                d[:, None, None] * (n_mat @ n_mat.T)[None])

    if regular:
        dt = (ts[1] - ts[0]).to(dtype)[None]
        if use_approximation:
            a1, q1 = approx(dt)
        else:
            a1, q1 = leg.transition_and_noise(g, dt, backend)
        a, q = masked(a1.expand(t, rank, rank), q1.expand(t, rank, rank))
        return SSM(a, q, params.b, leg.lambda_lambda_t(params))
    diffs = ts[1:] - ts[:-1]
    diffs = torch.cat([diffs[:1], diffs]).to(dtype)  # [T]
    if tm is not None:
        diffs = diffs * tm + (1.0 - tm)
    if use_approximation:
        a, q = approx(diffs)
    else:
        # the cancellation-free (A, Q = I - A A^T)
        a, q = leg.transition_and_noise(g, diffs, backend)
    a, q = masked(a, q)
    return SSM(a, q, params.b, leg.lambda_lambda_t(params))


def _mvn_logpdf(x: Tensor, cov: Tensor) -> Tensor:
    chol = torch.linalg.cholesky(cov)
    sol = torch.linalg.solve_triangular(chol, x[:, None], upper=False)[:, 0]
    d = x.shape[-1]
    return -0.5 * (torch.sum(sol ** 2) + d * math.log(2 * math.pi)
                   + 2 * torch.sum(torch.log(torch.diagonal(chol))))


@leg._highest_precision
def filter_sequential(ssm: SSM, xs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Kalman filter, one step at a time: (filtered means [T, r], covs
    [T, r, r], total log-likelihood).  Joseph-form covariance update."""
    rank = ssm.h.shape[1]
    eye = torch.eye(rank, dtype=ssm.a.dtype, device=ssm.a.device)
    m = torch.zeros(rank, dtype=ssm.a.dtype, device=ssm.a.device)
    p = eye
    ms, ps, lls = [], [], []
    for a, q, y in zip(ssm.a, ssm.q, xs):
        # predict
        m = a @ m
        p = a @ p @ a.T + q
        # update
        innov = y - ssm.h @ m
        s = ssm.h @ p @ ssm.h.T + ssm.r
        k = torch.linalg.solve(s.T, (p @ ssm.h.T).T).T
        lls.append(_mvn_logpdf(innov, s))
        m = m + k @ innov
        ikh = eye - k @ ssm.h
        p = ikh @ p @ ikh.T + k @ ssm.r @ k.T
        ms.append(m)
        ps.append(p)
    return torch.stack(ms), torch.stack(ps), torch.sum(torch.stack(lls))


def log_likelihood_sequential(ssm: SSM, xs: Tensor) -> Tensor:
    """Marginal log-likelihood via the sequential filter."""
    return filter_sequential(ssm, xs)[2]


# ---------------------------------------------------------------------------
# Parallel (associative-scan) filtering.
# ---------------------------------------------------------------------------


def _interleave(a: Tensor, b: Tensor) -> Tensor:
    """out[..., 0::2] = a, out[..., 1::2] = b along the last axis; a has
    as many entries as b or one more."""
    if a.shape[-1] == b.shape[-1]:
        return sb.interleave(a, b)
    return torch.cat([sb.interleave(a[..., :-1], b), a[..., -1:]], dim=-1)


def associative_scan(fn: Callable, elems: Tuple[Tensor, ...]
                     ) -> Tuple[Tensor, ...]:
    """Inclusive scan of ``elems`` (a tuple of tensors, scanned along
    their last axis) under the associative ``fn(a, b)``: entry k is
    a_0 . a_1 . ... . a_k.

    The combination tree of ``jax.lax.associative_scan`` (its ``_scan``):
    combine adjacent pairs, scan the half-length result recursively (the
    odd entries), then combine each odd entry with the next even input
    (the even entries), and interleave.  Each entry is therefore grouped
    as JAX groups it, so float32 results match the JAX package's up to the
    rounding of ``fn`` itself."""
    n = elems[0].shape[-1]
    if n < 2:
        return tuple(elems)
    reduced = fn(tuple(e[..., 0:n - 1:2] for e in elems),
                 tuple(e[..., 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[..., :-1] for e in odd),
                  tuple(e[..., 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _solve_spd(m_em: Tensor, rhs_em: Tensor) -> Tensor:
    """Per-block SPD solve M X = RHS in element-major layout."""
    l, inv = sb.cholesky(m_em)
    return sb.solve_lower_t(l, inv, sb.solve_lower(l, inv, rhs_em))


def _solve_spd_vec(m_em: Tensor, rhs_em: Tensor) -> Tensor:
    l, inv = sb.cholesky(m_em)
    return sb.solve_lower_t_vec(l, inv, sb.solve_lower_vec(l, inv, rhs_em))


def _filter_combine_em(ei, ej):
    """Associative composition of filtering elements, element-major
    ([.., T] leaves; Sarkka & Garcia-Fernandez 2021, eqs. 10-11)."""
    a_i, b_i, c_i, eta_i, j_i = ei  # b, eta carried as [r, 1, T]
    a_j, b_j, c_j, eta_j, j_j = ej
    d = a_i.shape[0]
    eye = torch.eye(d, dtype=a_i.dtype, device=a_i.device)[:, :, None]
    lhs = eye + sb.matmul(c_i, j_j)
    # (I + C J) is nonsymmetric with eigenvalues >= 1 but no bound on the
    # leading pivot; partial pivoting keeps the float32 combine stable
    ajli = sb.transpose(
        lu_solve_pivoted(sb.transpose(lhs), sb.transpose(a_j)))
    a_new = sb.matmul(ajli, a_i)
    b_new = sb.matmul(ajli, b_i + sb.matmul(c_i, eta_j)) + b_j
    c_new = sb.matmul(sb.matmul(ajli, c_i), a_j, tb=True) + c_j
    lhs2 = eye + sb.matmul(j_j, c_i)
    atli2 = sb.transpose(lu_solve_pivoted(sb.transpose(lhs2), a_i))
    eta_new = sb.matmul(atli2, eta_j - sb.matmul(j_j, b_i)) + eta_i
    j_new = sb.matmul(sb.matmul(atli2, j_j), a_i) + j_i
    # C and J are mathematically symmetric; re-symmetrise so float32
    # roundoff cannot drift them indefinite over long compositions
    c_new = 0.5 * (c_new + sb.transpose(c_new))
    j_new = 0.5 * (j_new + sb.transpose(j_new))
    return a_new, b_new, c_new, eta_new, j_new


def _filter_elements(a, q, h, r_em, y, m_in, p_in):
    """The filtering elements of one run of steps, given the filtered
    moments (m_in, p_in) of the state before its first step (the prior
    covariance entering each step is Q, and A p_in A^T + Q at the first;
    m_in rides in b).  Element-major: a, q [r, r, T], h [obs, r, T],
    r_em [obs, obs, T], y [obs, T]."""
    tb = y.shape[-1]
    rank = a.shape[0]
    eye_r = sb.eye_em(rank, a)
    first = (torch.arange(tb, device=a.device) == 0).to(a.dtype)[None, None]
    not_first = 1.0 - first
    pp = q + first * sb.matmul(sb.matmul(a, p_in[:, :, None]), a, tb=True)
    s = sb.matmul(sb.matmul(h, pp), h, tb=True) + r_em
    hp = sb.matmul(h, pp)
    k = sb.transpose(_solve_spd(s, hp))  # pp H^T S^{-1}  [r, o, T]
    ikh = eye_r - sb.matmul(k, h)
    ha = sb.matmul(h, a)
    s_inv_y = _solve_spd_vec(s, y)
    a_el = not_first * sb.matmul(ikh, a)
    b_el = sb.matvec(k, y)
    if m_in is not None:
        b_el = b_el + first[0] * sb.matvec(
            sb.matmul(ikh, a), m_in[:, None].expand(rank, tb))
    c_el = sb.matmul(ikh, pp)
    eta = not_first[0] * sb.matvec(ha, s_inv_y, ta=True)
    j_el = not_first * sb.matmul(ha, _solve_spd(s, ha), ta=True)
    return a_el, b_el[:, None, :], c_el, eta[:, None, :], j_el


def _predictive_chol(a, q, h, r_em, y, ms, ps, m_in, p_in):
    """Cholesky of the one-step-ahead innovation covariances and the
    whitened innovations, from the filtered moments (ms, ps) of the run
    and those before it (m_in, p_in)."""
    first = (torch.arange(y.shape[-1], device=a.device) == 0).to(
        a.dtype)[None, None]
    m_prev = sb.shift_down(ms)
    if m_in is not None:
        m_prev = m_prev + first[0] * m_in[:, None]
    p_prev = sb.shift_down(ps) + first * p_in[:, :, None]
    mp = sb.matvec(a, m_prev)
    ppd = sb.matmul(sb.matmul(a, p_prev), a, tb=True) + q
    s2 = sb.matmul(sb.matmul(h, ppd), h, tb=True) + r_em
    innov = y - sb.matvec(h, mp)
    l2, inv2 = sb.cholesky(s2)
    return l2, sb.solve_lower_vec(l2, inv2, innov)


@leg._highest_precision
def filter_parallel(ssm: SSM, xs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """O(log T)-depth Kalman filter via `associative_scan`, element-major
    ([r, r, T] leaves).  Returns (filtered means [T, r], covs [T, r, r],
    log-likelihood); the likelihood is assembled after the scan from the
    one-step-ahead predictives (innovation covariances bounded below by
    R: the numerically robust form)."""
    t, obs = xs.shape
    rank = ssm.h.shape[1]
    a = sb.to_em(ssm.a)
    q = sb.to_em(ssm.q)
    y = sb.vec_to_em(xs)  # [o, T]
    h = ssm.h[:, :, None].expand(obs, rank, t)
    r_em = ssm.r[:, :, None].expand(obs, obs, t)
    p0 = torch.eye(rank, dtype=a.dtype, device=a.device)
    # m0 = 0 collapses the initial mean terms to the generic k y form
    scanned = associative_scan(
        _filter_combine_em, _filter_elements(a, q, h, r_em, y, None, p0))
    ms, ps = scanned[1][:, 0, :], scanned[2]  # [r, T], [r, r, T]
    l2, z = _predictive_chol(a, q, h, r_em, y, ms, ps, None, p0)
    ll = -0.5 * (torch.sum(z * z) + t * obs * math.log(2 * math.pi)
                 + 2.0 * sb.chol_log_diag_sum(l2))
    return sb.vec_from_em(ms), sb.from_em(ps), ll


# ---------------------------------------------------------------------------
# Blocked (memory-bounded) parallel filtering: the associative-scan
# internals hold ~10 [r, r, T] work arrays.  Blocks run the parallel scan
# internally and compose sequentially through an O(1) carry, so peak
# memory is O(block).
# ---------------------------------------------------------------------------

SMOOTHER_BLOCK = 1 << 17  # default block length (and the flat-scan cap)


def _filter_block_em(a, q, h, r_em, y, m_in, p_in, valid):
    """Parallel filter over one block with general init (m_in, p_in) =
    filtered moments of the state BEFORE this block; ``valid`` masks
    padded steps out of the log-likelihood.  Returns (ms, ps, ll, ll_t,
    m_out, p_out)."""
    scanned = associative_scan(
        _filter_combine_em,
        _filter_elements(a, q, h, r_em, y, m_in, p_in))
    ms, ps = scanned[1][:, 0, :], scanned[2]
    l2, z = _predictive_chol(a, q, h, r_em, y, ms, ps, m_in, p_in)
    obs = y.shape[0]
    ll_t = -0.5 * (torch.sum(z * z, dim=0) + obs * math.log(2 * math.pi)
                   + 2.0 * sb.chol_log_diag_rows(l2)) * valid
    return ms, ps, torch.sum(ll_t), ll_t, ms[:, -1], ps[:, :, -1]


def _pad_ssm_blocks(ssm: SSM, xs: Tensor, block: int):
    """Pad (A, Q, y) to a block multiple with no-op steps (A = I, Q = 0,
    observation ignored via the valid mask): the filtered state passes
    through them unchanged."""
    t = xs.shape[0]
    nb = -(-t // block)
    pad = nb * block - t
    rank = ssm.h.shape[1]
    dtype, device = ssm.a.dtype, ssm.a.device
    valid = torch.cat([torch.ones(t, dtype=dtype, device=device),
                       torch.zeros(pad, dtype=dtype, device=device)])
    a, q = ssm.a, ssm.q
    if pad:
        eye = torch.eye(rank, dtype=dtype, device=device)
        a = torch.cat([a, eye.expand(pad, rank, rank)], dim=0)
        q = torch.cat([q, q.new_zeros((pad, rank, rank))], dim=0)
        xs = torch.cat([xs, xs.new_zeros((pad, xs.shape[1]))], dim=0)
    return a, q, xs, valid, nb, pad


def _blocks(ssm: SSM, xs: Tensor, block: int):
    """(per-block a, q [nb, r, r, block], y [nb, obs, block], valid
    [nb, block], h, r_em broadcast over a block, nb)."""
    rank = ssm.h.shape[1]
    obs = ssm.h.shape[0]
    a, q, xs_p, valid, nb, _ = _pad_ssm_blocks(ssm, xs, block)
    a_b = sb.to_em(a).reshape(rank, rank, nb, block).permute(2, 0, 1, 3)
    q_b = sb.to_em(q).reshape(rank, rank, nb, block).permute(2, 0, 1, 3)
    y_b = sb.vec_to_em(xs_p).reshape(obs, nb, block).permute(1, 0, 2)
    v_b = valid.reshape(nb, block)
    h = ssm.h[:, :, None].expand(obs, rank, block)
    r_em = ssm.r[:, :, None].expand(obs, obs, block)
    return a_b, q_b, y_b, v_b, h, r_em, nb


@leg._highest_precision
def filter_parallel_blocked(ssm: SSM, xs: Tensor, block: int = 1 << 17
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """`filter_parallel` with O(block) working memory: blocks of
    ``block`` steps, each an associative scan, composed in order through
    the exact filtered (m, P) carry.  The same outputs."""
    t = xs.shape[0]
    rank = ssm.h.shape[1]
    a_b, q_b, y_b, v_b, h, r_em, nb = _blocks(ssm, xs, block)
    m = xs.new_zeros((rank,))
    p = torch.eye(rank, dtype=xs.dtype, device=xs.device)
    ll = xs.new_zeros(())
    ms_b, ps_b = [], []
    for k in range(nb):
        ms, ps, ll_k, _, m, p = _filter_block_em(
            a_b[k], q_b[k], h, r_em, y_b[k], m, p, v_b[k])
        ll = ll + ll_k
        ms_b.append(ms)
        ps_b.append(ps)
    ms = torch.cat(ms_b, dim=-1)[:, :t]
    ps = torch.cat(ps_b, dim=-1)[..., :t]
    return sb.vec_from_em(ms), sb.from_em(ps), ll


@leg._highest_precision
def log_likelihood_blocked(ssm: SSM, xs: Tensor,
                           block: int = 1 << 17) -> Tensor:
    """Marginal log-likelihood with O(block) memory, value and gradient:
    the float32 training loss beyond the flat scan's memory.  Each block's
    filter runs under ``torch.utils.checkpoint``, so the backward keeps one
    (m, P, ll) carry per block and recomputes the block's interior.  Equal
    to ``filter_parallel(ssm, xs)[2]``."""
    rank = ssm.h.shape[1]
    a_b, q_b, y_b, v_b, h, r_em, nb = _blocks(ssm, xs, block)

    def body(m_in, p_in, a_k, q_k, y_k, v_k):
        _, _, ll_k, _, m_out, p_out = _filter_block_em(
            a_k, q_k, h, r_em, y_k, m_in, p_in, v_k)
        return m_out, p_out, ll_k

    m = xs.new_zeros((rank,))
    p = torch.eye(rank, dtype=xs.dtype, device=xs.device)
    ll = xs.new_zeros(())
    for k in range(nb):
        m, p, ll_k = checkpoint(body, m, p, a_b[k], q_b[k], y_b[k], v_b[k],
                                use_reentrant=False)
        ll = ll + ll_k
    return ll


# ---------------------------------------------------------------------------
# The steady-state check behind fit's default loss on long uniform grids.
# ---------------------------------------------------------------------------


def _riccati_step(a, q, h, r_obs, p):
    """One predicted-covariance Riccati step; returns
    (p_next, F, G, chol_S, logdet_S)."""
    rank = a.shape[0]
    s = h @ p @ h.T + r_obs
    sl = torch.linalg.cholesky(s)
    kt = torch.cholesky_solve(h @ p, sl)  # [obs, r] = K^T
    k = kt.T
    f = a @ (torch.eye(rank, dtype=a.dtype, device=a.device) - k @ h)
    g = a @ k
    p_next = a @ (p - k @ s @ k.T) @ a.T + q
    p_next = 0.5 * (p_next + p_next.T)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(sl)))
    return p_next, f, g, sl, ld


@leg._highest_precision
def steady_state_gap(a: Tensor, q: Tensor, h: Tensor, r_obs: Tensor,
                     t0: int = 512) -> float:
    """Relative sup-norm Riccati residual at the switch point t0: how far
    the predicted covariance still moves after t0 steps from P = I (the
    steady-state filter's constant-gain tail is exact to working
    precision once it is small)."""
    with torch.no_grad():
        p = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        for _ in range(t0 - 1):
            p = _riccati_step(a, q, h, r_obs, p)[0]
        p_last = _riccati_step(a, q, h, r_obs, p)[0]
        return float(torch.max(torch.abs(p_last - p))
                     / torch.clamp(torch.max(torch.abs(p_last)), min=1e-30))
