"""Kalman filtering and RTS smoothing for the LEG <-> SSM bridge
(PyTorch): the filter losses and the posterior route that the float32
defaults pick.

Counterpart of ``cyclic_gps_tpu/baselines/kalman.py`` (its SSM bridge,
sequential and parallel filters and smoothers, the blocked filter and
smoother, sampling and the steady-state filter).  The LEG model on a
grid is exactly a discrete-time linear-Gaussian SSM:

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
* `smooth_sequential`, `smooth_parallel(_full)` and
  `smooth_parallel_full_blocked`: the RTS smoother, one step at a time
  (the tests' oracle), as a reverse associative scan over the filtered
  moments, and in blocks composed in reverse through the smoothed carry.
* `log_likelihood_steady`: on a uniform grid, the exact filter for t0
  steps and then the constant-gain tail as dense products.

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


@leg._highest_precision
def smooth_sequential(ssm: SSM, xs: Tensor) -> Tuple[Tensor, Tensor]:
    """RTS smoother, one step at a time: (smoothed means [T, r], covs
    [T, r, r]).  Smoothing step k uses the transition into k+1."""
    ms, ps, _ = filter_sequential(ssm, xs)
    m_s, p_s = ms[-1], ps[-1]
    out_m, out_p = [m_s], [p_s]
    for k in range(xs.shape[0] - 2, -1, -1):
        m, p, a, q = ms[k], ps[k], ssm.a[k + 1], ssm.q[k + 1]
        pp = a @ p @ a.T + q  # predicted covariance into k+1
        gain = torch.linalg.solve(pp.T, (p @ a.T).T).T
        m_s = m + gain @ (m_s - a @ m)
        p_s = p + gain @ (p_s - pp) @ gain.T
        out_m.append(m_s)
        out_p.append(p_s)
    return torch.stack(out_m[::-1]), torch.stack(out_p[::-1])


# ---------------------------------------------------------------------------
# Parallel (associative-scan) filtering.
# ---------------------------------------------------------------------------


def _interleave(a: Tensor, b: Tensor) -> Tensor:
    """out[..., 0::2] = a, out[..., 1::2] = b along the last axis; a has
    as many entries as b or one more."""
    if a.shape[-1] == b.shape[-1]:
        return sb.interleave(a, b)
    return torch.cat([sb.interleave(a[..., :-1], b), a[..., -1:]], dim=-1)


def associative_scan(fn: Callable, elems: Tuple[Tensor, ...],
                     reverse: bool = False) -> Tuple[Tensor, ...]:
    """Inclusive scan of ``elems`` (a tuple of tensors, scanned along
    their last axis) under the associative ``fn(a, b)``: entry k is
    a_0 . a_1 . ... . a_k.

    The combination tree of ``jax.lax.associative_scan`` (its ``_scan``):
    combine adjacent pairs, scan the half-length result recursively (the
    odd entries), then combine each odd entry with the next even input
    (the even entries), and interleave.  Each entry is therefore grouped
    as JAX groups it, so float32 results match the JAX package's up to the
    rounding of ``fn`` itself.  ``reverse=True`` is JAX's reverse scan:
    every input flipped along the axis, the same tree with ``fn``
    unchanged, the outputs flipped back (so ``fn`` receives (accumulated
    suffix, current))."""
    if reverse:
        out = associative_scan(fn, tuple(torch.flip(e, (-1,))
                                         for e in elems))
        return tuple(torch.flip(e, (-1,)) for e in out)
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


def _smoother_combine_em(ea, eb):
    """Composition for the reverse suffix scan (element-major).  With
    ``reverse=True`` the scan hands over (accumulated suffix, current),
    and the result is the current element composed with the suffix:
    m_s(i) = E_i m_s(i+1) + g_i applied outermost."""
    e_a, g_a, l_a = ea  # g carried as [r, 1, T]
    e_b, g_b, l_b = eb
    e = sb.matmul(e_b, e_a)
    g = sb.matmul(e_b, g_a) + g_b
    ell = sb.matmul(sb.matmul(e_b, l_a), e_b, tb=True) + l_b
    return e, g, ell


def _smoother_elements(ms, ps, a, q):
    """The smoothing elements from the filtered moments, element-major
    (ms [r, T], ps, a, q [r, r, T]; a and q the transitions INTO each
    step).  Returns (gain, e, g, ell): gain_k = P_k A_{k+1}^T
    (A_{k+1} P_k A_{k+1}^T + Q_{k+1})^{-1}, and at the last step e = 0,
    g = m, ell = P (it has no successor)."""
    t = ms.shape[-1]
    last = (torch.arange(t, device=ms.device) == t - 1).to(ms.dtype)
    not_last = (1.0 - last)[None, None]
    a_n = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    q_n = torch.cat([q[..., 1:], q[..., -1:]], dim=-1)
    pp = sb.matmul(sb.matmul(a_n, ps), a_n, tb=True) + q_n
    gain = sb.transpose(_solve_spd(pp, sb.matmul(a_n, ps)))  # p a_n^T pp^-1
    e = not_last * gain
    g = ms - not_last[0] * sb.matvec(gain, sb.matvec(a_n, ms))
    ell = ps - not_last * sb.matmul(sb.matmul(gain, pp), gain, tb=True)
    return gain, e, g, ell


def _smooth_flat(ssm: SSM, xs: Tensor):
    """(smoothed means [r, T], covs [r, r, T], gains [r, r, T]): the
    filter, then one reverse associative scan over the smoothing
    elements."""
    ms, ps, _ = filter_parallel(ssm, xs)
    gain, e, g, ell = _smoother_elements(
        sb.vec_to_em(ms), sb.to_em(ps), sb.to_em(ssm.a), sb.to_em(ssm.q))
    _, g_s, ell_s = associative_scan(_smoother_combine_em,
                                     (e, g[:, None, :], ell), reverse=True)
    return g_s[:, 0, :], ell_s, gain


@leg._highest_precision
def smooth_parallel(ssm: SSM, xs: Tensor) -> Tuple[Tensor, Tensor]:
    """O(log T)-depth RTS smoother: (smoothed means [T, r], covs
    [T, r, r]), by a reverse associative scan over the filtered moments
    (element-major internals, as `filter_parallel`)."""
    means, covs, _ = _smooth_flat(ssm, xs)
    return sb.vec_from_em(means), sb.from_em(covs)


@leg._highest_precision
def smooth_parallel_full(ssm: SSM, xs: Tensor
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """`smooth_parallel` plus the lag-1 cross-covariances
    Cov(z_{k+1}, z_k | x) = P^s_{k+1} G_k^T (G_k the smoother gain):
    (means [T, r], covs [T, r, r], cross [T-1, r, r]), everything the LEG
    in-sample posterior needs.  Robust at float32 (innovation-form
    recursions), where the precision form's selected inversion is not
    for very smooth processes."""
    means, covs, gain = _smooth_flat(ssm, xs)
    cross = sb.matmul(covs[..., 1:], gain[..., :-1], tb=True)
    return sb.vec_from_em(means), sb.from_em(covs), sb.from_em(cross)


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


@leg._highest_precision
def log_likelihood_rows_blocked(ssm: SSM, xs: Tensor,
                                block: int = 1 << 17) -> Tensor:
    """The per-step log-likelihood terms [T] (one-step-ahead predictive
    log-densities), in O(block) memory like `log_likelihood_blocked`
    (their sum is its scalar).  On a boundary-masked SSM
    (`leg_to_ssm(gap_mask=...)`, stacked series) segment sums of the rows
    by series id are each series' exact filter log-likelihood."""
    t = xs.shape[0]
    block = min(block, 1 << max(t - 1, 1).bit_length())  # no giant pad
    rank = ssm.h.shape[1]
    a_b, q_b, y_b, v_b, h, r_em, nb = _blocks(ssm, xs, block)

    def body(m_in, p_in, a_k, q_k, y_k, v_k):
        _, _, _, ll_t, m_out, p_out = _filter_block_em(
            a_k, q_k, h, r_em, y_k, m_in, p_in, v_k)
        return m_out, p_out, ll_t

    m = xs.new_zeros((rank,))
    p = torch.eye(rank, dtype=xs.dtype, device=xs.device)
    rows = []
    for k in range(nb):
        m, p, ll_t = checkpoint(body, m, p, a_b[k], q_b[k], y_b[k], v_b[k],
                                use_reentrant=False)
        rows.append(ll_t)
    return torch.cat(rows)[:t]


@leg._highest_precision
def smooth_parallel_full_blocked(ssm: SSM, xs: Tensor, block: int = 1 << 17
                                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """`smooth_parallel_full` with O(block) scan memory: the blocked
    filter forward, then the blocks in reverse order, each a reverse
    associative scan, composed through the smoothed (m, P) of the next
    block's first state.  Padded steps (A = I, Q = 0) carry the last
    real filtered state, and the links into them are the identity
    (gain = I, g = 0, ell = 0), so the carry passes through them
    unchanged.  Those links are set exactly, not solved for: in float32
    the solved ones are the identity only to roundoff, which the scan
    sums over the padded tail (up to block - 1 steps; ~1e-3 of scale
    after 48,576 steps at rank 5).  The same outputs as the flat
    smoother."""
    t = xs.shape[0]
    rank = ssm.h.shape[1]
    ms_nat, ps_nat, _ = filter_parallel_blocked(ssm, xs, block=block)
    a, q, _, _, nb, pad = _pad_ssm_blocks(ssm, xs, block)
    ms, ps = sb.vec_to_em(ms_nat), sb.to_em(ps_nat)
    if pad:
        ms = torch.cat([ms, ms[:, -1:].expand(rank, pad)], dim=-1)
        ps = torch.cat([ps, ps[:, :, -1:].expand(rank, rank, pad)], dim=-1)
    gain, e, g, ell = _smoother_elements(ms, ps, sb.to_em(a), sb.to_em(q))
    if pad:
        # the links from the last real step into the padding, and through
        # it up to the last padded step, which has no successor
        idx = torch.arange(nb * block, device=ms.device)
        link = (idx >= t - 1) & (idx < nb * block - 1)
        eye = sb.eye_em(rank, ms)
        gain = torch.where(link, eye, gain)
        e = torch.where(link, eye, e)
        g = torch.where(link, 0.0, g)
        ell = torch.where(link, 0.0, ell)

    m_c = xs.new_zeros((rank,))  # smoothed first state of the NEXT block
    p_c = xs.new_zeros((rank, rank))
    outs = []
    for k in reversed(range(nb)):
        sl = slice(k * block, (k + 1) * block)
        es, gs, ells = associative_scan(
            _smoother_combine_em, (e[..., sl], g[:, None, sl], ell[..., sl]),
            reverse=True)
        m_s = sb.matvec(es, m_c[:, None].expand(rank, block)) + gs[:, 0, :]
        p_s = sb.matmul(sb.matmul(es, p_c[:, :, None]), es, tb=True) + ells
        # cross_j = P^s_{j+1} gain_j^T; the block's last entry uses the
        # carried first covariance of the next block
        p_next = torch.cat([p_s[..., 1:], p_c[:, :, None]], dim=-1)
        outs.append((m_s, p_s, sb.matmul(p_next, gain[..., sl], tb=True)))
        m_c, p_c = m_s[:, 0], p_s[:, :, 0]
    m_s, p_s, cross = (torch.cat(x, dim=-1) for x in zip(*outs[::-1]))
    return (sb.vec_from_em(m_s[:, :t]), sb.from_em(p_s[..., :t]),
            sb.from_em(cross[..., :t - 1]))


def _sample_path(ssm: SSM, ws: Tensor) -> Tensor:
    """The latent path z_k = A_k z_{k-1} + chol(Q_k) w_k from z = 0,
    given the standard-normal draws ws [T, r]."""
    rank = ssm.h.shape[1]
    chol_q = torch.linalg.cholesky(
        ssm.q + 1e-12 * torch.eye(rank, dtype=ssm.q.dtype,
                                  device=ssm.q.device))
    z = ws.new_zeros((rank,))
    zs = []
    for a, qc, w in zip(ssm.a, chol_q, ws):
        z = a @ z + qc @ w
        zs.append(z)
    return torch.stack(zs)


def sample_states(ssm: SSM, generator: torch.Generator) -> Tensor:
    """A latent sample path [T, r]: start at 0, then predict and inject
    process noise at every step.  ``generator`` takes the place of the
    JAX key (the two give different numbers from one seed); its draws are
    made on its own device and moved to the SSM's."""
    ws = torch.randn((ssm.a.shape[0], ssm.h.shape[1]), generator=generator,
                     dtype=ssm.a.dtype, device=generator.device)
    return _sample_path(ssm, ws.to(ssm.a.device))


# ---------------------------------------------------------------------------
# The steady-state filter behind fit's default loss on long uniform grids.
#
# On a uniform grid the Riccati recursion is data-independent and
# converges geometrically; past the switch point t0 the filter has
# constant (F, G, S):
#
#     m^-_{k+1} = F m^-_k + G y_k,     e_k = y_k - H m^-_k,
#     ll_k = -1/2 (e_k^T S^{-1} e_k + log|2 pi S|),
#
# a constant-coefficient affine recurrence whose solution is a
# convolution: the tail, cut into blocks of B steps, collapses into dense
# matrix products with the powers F^j and the block-Toeplitz response
# H F^{j-1-i} G, plus an [r, r] affine recurrence over the block carries.
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


def _powers(f: Tensor, n: int) -> Tensor:
    """[n + 1, r, r]: f^j for j = 0..n, by doubling (log2 n products of
    stacks)."""
    pows = torch.eye(f.shape[0], dtype=f.dtype, device=f.device)[None]
    cur = f
    while pows.shape[0] < n + 1:
        pows = torch.cat([pows, pows @ cur], dim=0)
        cur = cur @ cur
    return pows[:n + 1]


def _affine_prefix(fB: Tensor, u: Tensor, m0: Tensor,
                   b2: int = 128) -> Tensor:
    """The start values m_c [C, r] of m_{c+1} = fB m_c + u_c, m_0 = m0.
    Two levels: super-chunks of b2 steps through the powers of fB and one
    block-Toeplitz product, then a short recurrence over the ~C / b2
    super-chunk carries."""
    c, rank = u.shape
    c2 = -(-c // b2)
    u_pad = torch.cat([u, u.new_zeros((c2 * b2 - c, rank))]).reshape(
        c2, b2, rank)
    pows = _powers(fB, b2)  # pows[j] = fB^j
    # super-chunk carry inputs: u2_k = sum_i fB^{b2-1-i} u_{k,i}
    u2 = torch.einsum("irs,kis->kr", torch.flip(pows[:b2], (0,)), u_pad)
    m, starts = m0, []
    for k in range(c2):  # the super-chunk starts
        starts.append(m)
        m = pows[b2] @ m + u2[k]
    m2 = torch.stack(starts)
    # within a super-chunk: m_{k,j} = fB^j m2_k + sum_{i<j} fB^{j-1-i} u_i
    idx = torch.arange(b2, device=u.device)
    ji = idx[:, None] - 1 - idx[None, :]
    t4 = torch.where((ji >= 0)[:, :, None, None],
                     pows[torch.clamp(ji, 0, b2 - 1)], 0.0)
    m2mat = t4.permute(0, 2, 1, 3).reshape(b2 * rank, b2 * rank)
    conv = (u_pad.reshape(c2, b2 * rank) @ m2mat.T).reshape(c2, b2, rank)
    m_start = torch.einsum("jrs,ks->kjr", pows[:b2], m2) + conv
    return m_start.reshape(c2 * b2, rank)[:c]


@leg._highest_precision
def log_likelihood_steady(a: Tensor, q: Tensor, h: Tensor, r_obs: Tensor,
                          xs: Tensor, t0: int = 512,
                          block: int = 128) -> Tensor:
    """Marginal log-likelihood on a uniform grid via the steady-state
    filter: the exact transient for the first ``t0`` steps, then the
    constant-gain tail as dense products (chunked convolution).

    a, q [r, r] the per-step transition and process noise, h [obs, r],
    r_obs [obs, obs]; xs [T, obs] with T > t0.  Equal to
    ``filter_parallel(ssm, xs)[2]`` once the Riccati recursion has
    converged by t0 (`steady_state_gap`).  The transient runs the
    associative-scan filter (`filter_parallel`, log-depth) on t0 steps
    whose first transition is (A = 0, Q = I), so its first predictive
    covariance is exactly the JAX function's P = I; the JAX package runs
    t0 sequential Riccati steps there (the same moments)."""
    t, obs = xs.shape
    if t <= t0:
        raise ValueError(f"the steady-state filter needs more than t0 = {t0}"
                         f" steps, got {t}")
    rank = a.shape[0]
    dtype, device = a.dtype, a.device
    eye = torch.eye(rank, dtype=dtype, device=device)

    # ---- the transient: t0 filter steps, then the predicted moments at t0
    a_t = torch.cat([torch.zeros_like(a)[None],
                     a[None].expand(t0 - 1, rank, rank)])
    q_t = torch.cat([eye[None], q[None].expand(t0 - 1, rank, rank)])
    ms, ps, ll = filter_parallel(SSM(a_t, q_t, h, r_obs), xs[:t0])
    m_t0 = a @ ms[-1]
    p_inf = a @ ps[-1] @ a.T + q
    _, f_ss, g_ss, sl_ss, ld_ss = _riccati_step(a, q, h, r_obs, p_inf)

    # ---- the steady-state tail as a chunked convolution
    tp = t - t0
    b = block
    c = -(-tp // b)
    y_tail = torch.cat([xs[t0:], xs.new_zeros((c * b - tp, obs))])
    valid = (torch.arange(c * b, device=device) < tp).to(dtype)
    yc_flat = y_tail.reshape(c, b * obs)
    pows = _powers(f_ss, b)  # pows[j] = F^j
    pow_g = pows[:b] @ g_ss  # [B, r, obs]: F^j G
    hw = (h[None] @ pows[:b]).reshape(b * obs, rank)  # rows H F^j
    # chunk carry u_c = sum_i F^{B-1-i} G y_i
    u_mat = torch.flip(pow_g, (0,)).permute(1, 0, 2).reshape(rank, b * obs)
    u = yc_flat @ u_mat.T  # [C, r]
    # block-Toeplitz response through H: hM[j, i] = H F^{j-1-i} G, i < j
    hg = h[None] @ pow_g  # [B, obs, obs]
    idx = torch.arange(b, device=device)
    ji = idx[:, None] - 1 - idx[None, :]
    hm4 = torch.where((ji >= 0)[:, :, None, None],
                      hg[torch.clamp(ji, 0, b - 1)], 0.0)
    hM = hm4.permute(0, 2, 1, 3).reshape(b * obs, b * obs)
    # chunk-start means: m_0 = m_t0, m_{c+1} = F^B m_c + u_c
    m_start = _affine_prefix(pows[b], u, m_t0)
    # innovations through H: e = y - (m_start hw^T + yc hM^T)
    hm = m_start @ hw.T + yc_flat @ hM.T  # [C, B*obs]
    e = (yc_flat - hm).reshape(c * b, obs)
    # whitened innovations z = S^{-1/2} e through the [obs, obs] inverse of
    # chol(S): one product (a triangular solve with T right-hand sides runs
    # as many tiny batched solves on the card)
    sl_inv = torch.linalg.solve_triangular(
        sl_ss, torch.eye(obs, dtype=dtype, device=device), upper=False)
    z = e @ sl_inv.T
    quad = torch.sum(z * z, dim=1) * valid
    ll_tail = -0.5 * (torch.sum(quad)
                      + tp * (ld_ss + obs * math.log(2 * math.pi)))
    return ll + ll_tail
