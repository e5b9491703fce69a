#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (cyclic_gps_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line of output each (or more):
  1. device   the card's name and power limit; TF32 off for the model math.
  2. build    nvcc builds the package's CUDA kernels from csrc/; the
              compiler's registers / stack / spills at rank 5, of the
              celerite kernels at nblocks 2 and 8 (and of every instance
              of the filter adjoint, kernel 15), and of the wide and
              runtime-d kernels; the dynamic
              shared bytes per block of the six warp-per-lane kernels of
              block sizes 9-15 (the walks 20' and 22, the sweeps 17', 21,
              19' and kernel 1's runtime-d instance) at d = 9, 12 and 15,
              float32 and float64 (and a failure if any of them uses local
              memory), and of kernel 15 at nblocks 5-8; the seven warp-
              per-lane kernels of 9-15 now include kernel 16 (the wide
              likelihood sweep); kernel 12's warp-per-lane instance
              (nblocks 5-8) with its shared bytes, failing on local
              memory as well; kernels 1, 6 and 7 at block size 16 (one
              warp per chunk lane, csrc/forward_sweep.cu and
              csrc/backward_sweep.cu) with their shared bytes at both
              dtypes, and kernel 14's warp-per-lane instances (nblocks
              5-8, obs 1 and 2) with theirs, failing on local memory as
              well (on any stack or spill at all for 1 at 16 and 14);
              kernel 13's warp-per-lane instances beside 14's (one body)
              and kernel 18' (the solve's back-substitution at 9-15, one
              warp per lane) with its shared bytes, failing on any stack
              or spill; kernels 5 and 4 (the emission adjoint, each
              thread block's gaps sorted by branch and rounds; the fused
              emission sweep in tiles of 3 rows, producer and consumer
              warps) at every rank with their shared bytes, failing if
              kernel 5's rank-5 instance uses any stack or spill; kernel 3
              (one thread per gap, tiles of 32 lanes by 7 rows and a halo
              row) at every rank and kernel 7's split design (a chain
              warp and three output warps) at every rank and dtype, with
              their shared bytes, failing if kernel 7's float32 rank-5
              instance uses any stack or spill; kernels 9 and 11's split
              designs (a chain warp and three warps that stage rows) at
              every rank and dtype with their shared bytes; the split
              designs of the four elimination sweeps, kernels 6, 8, 1 and
              10 (csrc/pipeline.cuh's elim_split: lane groups of a chain
              warp and three output warps; 10 without the right-hand
              side) at every rank and dtype with their shared bytes and
              the thread blocks an SM holds, failing if a float32 rank-5
              instance uses any stack or spill, and their thread-per-lane
              instances (float64 ranks 7 and 8) with the table that routes
              to them (sweep_cuda.THREAD_F64); kernel 2 (the per-gap
              (e, Q)) in both its designs (R lanes a gap, a row each, at
              small M; one thread a gap above) at every rank, failing if
              a rank-5 instance uses any stack or spill.
  3. kernels  each kernel against its plain PyTorch twin on the card, at
              the main path's shapes (LEG rank 5, N = 1e6 irregular gaps,
              s = 128, C = 7,813), with the error against its tolerance,
              the median CUDA-event time of kernel and twin, and the
              card's least time for the same work (its bound); kernel 2's
              two designs each against the twin at the sizes the paths
              launch it at (M = C, 65,536, 2^17, 1e6; intercast's 4P in
              phase 7), timed in turns, with the profiler's device time a
              launch ([tn-pick]: failing where the table
              expm_cuda.TN_ROWS_MAX_M picks the slower design).
              The three backward kernels get the inputs the two-kernel route's
              backward hands them.  Kernel 5 gives the same bits on a
              second run; then kernels 5, 4, 2 and 3 at their edge shapes
              ([emission]: ranks 1, 5 and 8; gaps of 0-9 squaring rounds
              and both branches in every warp, padded gaps; C = 35 and 45
              lanes, s = 6 and 7 rows) against their twins, 5 and 3 also
              giving the same bits on a second run; and kernel 7 at its
              edge shapes ([walk]: ranks 1, 5 and 8, s = 2, 3 and 7, C =
              1, 35 and 45, float32 and float64, the same bits on a second
              run, every launch on the split design); and the four
              elimination sweeps, kernels 1, 6, 8 and 10, at theirs
              ([elim-edges]: ranks 1, 5 and 8; s = 2, 4, 15 and 128; C =
              1, 35, 45 and 70; float32 and float64; every output against
              the twin, the same bits on a second run, every launch on the
              design the table names); then both designs of the four at
              float64 ranks 7 and 8, N = 1e5, 4e5, 1e6 and 2e6
              ([elim-pick]: each against the twin, timed in turns, failing
              where the table picks the slower).
  4. path     the likelihood through the user entry points with
              backend="auto" (the kernels), launch counts reset just
              before and read just after, then each value against
              backend="torch" (plain tensor code on the same card) and a
              small case against the dense float64 oracle.
  5. grad     the likelihood gradient on every route, backend="auto"
              against backend="torch" on the card, and a float64 small
              case against autograd through the dense oracle.
  6. train    three Adam train steps on the fused N = 1e6 route, launch
              counts reset just before and read just after, every launch
              of kernels 4, 5, 3, 7 and 6 on their redesigned kernels and
              of kernels 2, 1, 6, 8 and 10 on the design the table names;
              then one step under torch.profiler (every launch of 6 split, of
              1, 6, 8, 10 on the table's design; its busy share against
              the profiled wall and against the unprofiled median; its ten
              largest device ops and every split kernel below them; the
              summed device time and launches of kernels 1, 6, 8 and 10);
              then the float32 default on this
              grid, the residual loss: log_likelihood_residual's value and
              gradient with backend="auto" against "torch", and two steps
              of fit(loss=None), which must pick "cr_residual", with the
              launch counts of kernels 2, 3, 5-9 (every launch of 9, 8 and
              6 on its split design, of 1, 6, 8, 10 on the table's, of 2
              on the design its table picks); then [kalman], the float32 defaults on
              smaller and uniform grids: "kalman" on an irregular grid of
              2^17 points and "kalman_regular" on a uniform one of 16,384
              (the pick, value and gradient against backend="torch",
              three fit(loss=None) steps with kernel 2's launches, one
              profiled step), the uniform grid one point longer, where
              fit must pick "kalman_ss" and train three steps,
              "kalman_ss" against "kalman_regular" on a uniform 2^17
              grid (value 1e-4, gradient leaves 1e-3), "kalman_ss" at
              N = 1e6 (value and gradient against backend="torch", a timed
              and a profiled step), and the blocked filter at N = 1e6
              (value, gradient, peak memory).
  7. posterior the four posterior kernels against their twins on the inputs
              one insample_posterior(method="precision") call hands them
              at N = 1e6; kernels 9 and 11 at their edge shapes
              ([post-walk]: ranks 1, 5 and 8, s = 2, 4 and 15 (9) or 3, 5
              and 12 (11), C = 1, 35 and 45, float32 and float64, the same
              bits on a second run, every launch on the split design);
              the solve of bench.py's system (N = 1e6, d = 5) with
              backend="auto" and "torch", every launch of kernels 9 and 8
              split (and of 1, 6, 8, 10 on the table's design); the
              posterior path (float32 irregular with launch counts reset
              just before and read just after, every launch of kernel 3
              tiled, of 8, 9 and 11 split and of 1, 6, 8, 10 on the
              table's design, float32 regular, float64 method="auto")
              and make_predictions (P = 1e6 targets, and a dense P = 4096
              grid on N = 1024), each against backend="torch"; a float64
              N = 48 predictive against the dense GP oracle; one profiled
              insample_posterior call (busy share against the profiled and
              the unprofiled wall; the summed device time and launches of
              kernels 1, 6, 8 and 10); then [smoother]: float32
              insample_posterior(method="auto"), the parallel RTS smoother
              with kernel 2 on every gap, at N = 2^17 (flat) and 1e6
              (blocked, 8 blocks) against backend="torch", the 2^17 one
              also against the float64 precision route, its wall and a
              profiled call, and make_predictions(method="auto") at
              N = 1024, P = 4096; then [stacked]: 64 series of seeded
              lengths (~1e6 points, boundaries inside chunks and on a wrap
              row), kernels 1-11 against their twins on the inputs the
              stacked likelihood, its gradient and
              insample_posterior_stacked hand them, the launch counts of
              one train_step_stacked and one insample_posterior_stacked
              (set to 0 just before), the stacked value against 8 of its
              series run alone, the walls and profiled calls, and on 64 x
              16,384 points log_likelihood_per_series,
              insample_posterior_stacked and make_predictions_batch (256
              targets a series) against backend="torch", and
              nll_loss_kalman_stacked at 2^17 points.
  8. celerite the celerite family at nblocks = 8 (rank 16), obs 1, N = 1e6
              on the bench grid (gaps randint(1, 5) * 0.125, float32): the
              four celerite kernels against their twins, and the engine's
              kernels 1, 6 and 7 at block size 16, on the inputs one
              gradient of each likelihood route hands them (one warp per
              chunk lane, at both levels of the boundary chain, C = 245
              and 8); both routes
              and their gradients with backend="auto" against "torch" at
              nblocks 2 and 8; one likelihood call and three Adam steps on
              nll_loss with launch counts reset just before and read just
              after, kernels 1, 6 and 7 at block size 16 and kernels 14
              and 15 taking their warp-per-lane kernel at every launch of
              the Adam steps; one profiled step;
              make_predictions(method=
              "precision") at nblocks 2; kernel 15's two instances (one
              thread per lane at nblocks 1-4, one warp per lane at 5-8)
              against their twin at nblocks 1, 2, 5 and 8, obs 1 and 2,
              on C = 9 chunks (a ragged last chunk and tile) and on one
              lane, and at nblocks 6, N = 1e6; kernel 14's two instances
              the same way (timed at nblocks 2 in turns and at 6); kernel
              13's two instances the same way, its warp statistics equal
              to kernel 14's bit for bit (timed at nblocks 2 and 4 in
              turns and at 6; its launches over the Adam steps must all
              take the warp-per-lane kernel); kernel
              12's two instances
              (one thread per lane at nblocks 1-4, one warp per lane at
              5-8, which the likelihood call must take at nblocks 8)
              against their twin at nblocks 1, 2, 4, 5 and 8 on C = 9
              chunks (masked gaps and unobserved rows in the ragged last
              chunk) and on that last lane, both timed at nblocks 2 and
              4, N = 1e6, and the routed one at nblocks 6, N = 1e6;
              kernels 1, 6 and 7 at block size 16 at their edge shapes
              (s = 3 on C = 1, 8 and 9; s = 32 on C = 245; float32 and
              float64) on the inputs one mahal_and_logdet_cm (1) or
              solve_and_inverse_cm (6, 7) hands them.
  9. wide     block sizes 9-15 on the wide route (kernels 16, 21, 22):
              the natural mahal_and_logdet at N = 1e6 on the well-
              conditioned system of tests/test_wideblock.py, value and
              gradient of 0.3 mh + 0.7 ld with backend="auto" against
              "torch" at d = 12, the three wide kernels against their twins
              at d = 9, 12 and 15 on the inputs one gradient hands them,
              launch counts over one gradient; celerite nblocks 6 (rank
              12) at N = 1e6 on the bench grid: the three wide kernels
              against their twins on the inputs its boundary chain hands
              them (d = 12, C = 245), the filter route's value and
              gradient against "torch", three Adam steps on nll_loss
              with the launch counts of kernels 13-16, 21 and 22, one
              profiled step; nblocks 5 and 7 at N = 1e5: the wide kernels
              on their chain's inputs (d = 10 and 14), value and gradient
              against "torch"; kernels 22 and 21 against their twins at
              their edge shapes (s = 3; C = 1 and 9; d = 9 and 15; float32
              and float64) on the inputs one solve_and_inverse_cm hands
              them, and kernel 16 at the same shapes on the inputs of
              mahal_and_logdet_wide.
 10. solve-rt block sizes 9-15 of the natural solve and selected inversion
              (kernels 17-20: the runtime-d instances behind the wrappers
              of kernels 8-11; 21 and 22 in the solve's backward): the
              four kernels against their twins at d = 12 (recorded), 9
              and 15 on the inputs one solve_and_logdet value + gradient
              and one inverse_blocks call hand them at N = 1e6, and at
              float64, d = 12, N = 1e5; at N = 1e6, d = 12 the value,
              the gradient of sum(x w) + 0.7 ld and inverse_blocks with
              backend="auto" against "torch", with the launch counts of
              one call each; kernels 20', 17' and 18' against their
              twins at their edge shapes (s = 3; C = 1 and 9; d = 9 and
              15; float32 and float64) on the inputs one
              inverse_blocks_cm (20') or solve_cm (17', 18') call hands
              them; kernel 19' at the same edge shapes on the inputs of
              inverse_blocks_cm.
 11. sweep-rt kernel 1 at block sizes 9-15 (csrc/rt_solve.cu's runtime-d
              sweep) against its twin at d = 9, 12 (recorded), 15,
              N = 1e6 and at float64, d = 12, N = 1e5, on the inputs one
              mahal_and_logdet_cm call hands it; at d = 12, N = 1e6
              mahal_and_logdet_cm's value and gradient and logdet_rows_cm
              with backend="auto" against "torch" and the launch counts
              of one call each; celerite's precision route (value and
              gradient) at nblocks 6, N = 1e6 against "torch"; the kernel
              at the edge shapes of [solve-rt].
 12. a JSON line of the kernels, then the final JSON status line.

A [clock] line before each phase gives the seconds since the start.
Any failure exits non-zero before the final line.  There is no CPU path:
without a CUDA device, or without the package beside this script, it
fails.

    python3 chip_smoke.py --sweeps [--root DIR] [--label TEXT]

times only the four elimination sweeps (kernels 1, 6, 8, 10) on the LEG
main path (sweeps_main), with the port imported from DIR (an unpacked
``git archive`` of another commit) or from this checkout: run parent,
change, change, parent in one call to compare two commits on one card.

    python3 chip_smoke.py --tn [--root DIR] [--label TEXT]

times only kernel 2, through its wrapper, at the sizes the paths launch it
at (tn_main), in the same way.
"""

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

N_BIG = 1_000_000
N_SMALL = 48
RANK, OBS = 5, 2
CEL_NB, CEL_NB_SMALL = 8, 2  # celerite: rank 16 (the full width) and 4
REPS = 7  # timed runs per kernel (median reported; a twin's one run)
TRAIN_STEPS = 3
# published peaks of one H100 SXM (the bound's denominators)
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS, warm=True):
    """Median CUDA-event time of fn() in ms, after one warm-up run (none
    with ``warm=False``, for a function that has just run)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def profiled(fn, cpu=True):
    """(wall ms with the profiler on, {device op name: (ms, calls)}) of
    fn() under torch.profiler; ``cpu=False`` records the device activity
    alone (for tens of thousands of ops, where sorting out the host's
    events would take tens of seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    return wall, by_name


def host_ms(fn, reps=3):
    """Median host-clock time of fn() in ms (synchronised), after one
    warm-up run; returns (ms, last value)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def compare(label, got, ref, rtol, atol, atol_of_scale=False, atols=None):
    """allclose-style check of every output pair; returns the largest
    absolute difference.  With ``atol_of_scale`` the absolute tolerance
    is a fraction of each output's largest |ref|; ``atols`` {output
    index: absolute tolerance} overrides it per output.  Fails on a
    non-finite value or a mismatch."""
    worst_abs = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        a = a.detach().double()
        b = b.detach().double()
        if a.shape != b.shape:
            fail(f"{label} output {i}: shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label} output {i}: non-finite values")
        tol = atol * float(b.abs().max()) if atol_of_scale else atol
        if atols and i in atols:
            tol = atols[i]
        diff = (a - b).abs()
        # an exact match is no error even where the tolerance is zero (an
        # output that underflows to zero in both, e.g. W0 after 31 decaying
        # steps of the boundary chain)
        ratio = float(torch.where(diff == 0, 0.0,
                                  diff / (tol + rtol * b.abs())).max())
        max_abs = float(diff.max())
        worst_abs = max(worst_abs, max_abs)
        ok = ratio <= 1.0
        say(f"  {label} out[{i}] {tuple(a.shape)}: max_abs={max_abs:.3e} "
            f"max|ref|={float(b.abs().max()):.3e} "
            f"err/tol={ratio:.3e} (rtol={rtol:g}, atol={tol:.3g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label} output {i} disagrees with its reference")
    return worst_abs


# ---------------------------------------------------------------------------
# The card's least time for each kernel's work: max(bytes / memory rate,
# float32 operations / peak rate).  Bytes: every input read once, every
# output written once (of the wide kernels' inputs only the parts they
# must read, _wide_read_bytes).  Operations: counted from each kernel's
# code, with an R x R product as 2 R^3 and the data-dependent squaring
# rounds of the gap emission counted per gap from this run's gaps.
# ---------------------------------------------------------------------------


def _flat(xs):
    """The tensors of a (nested) tuple of arguments or outputs."""
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flat(x)
        elif isinstance(x, torch.Tensor):
            yield x


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in _flat(tensors))


def _rounds(g, dt):
    """(squaring rounds per gap, Van Loan-regime mask): the scaling rule
    of csrc/gapsmem.cuh (rounds, van_loan), on this run's gaps."""
    from cyclic_gps_tpu_torch.ops import expm_cuda

    _, half, augn = expm_cuda._generator_norms(g.double())
    dt = dt.double()
    nsq = torch.clamp(torch.ceil(torch.log2(torch.clamp(
        dt * augn / expm_cuda._THETA7, min=1.0))), 0, expm_cuda._MAXSQ)
    return nsq, dt * half < 1.0


def _tn_flops(g, dt):
    """Operations the per-gap (e, Q1) forward needs: where dt ||G/2|| < 1
    (Van Loan) the structured Pade-7 (13 products, LU solves with R and 2R
    right-hand sides), 4 products a squaring round and Q from g1 f1^T;
    elsewhere only e's Pade-7 (a2, a4, a6, a p: 4 products, an LU solve
    with R right-hand sides), 1 product a round and Q = I - e e^T."""
    r = g.shape[0]
    nsq, small = _rounds(g, dt)
    per_round = torch.where(small, 8.0, 2.0) * r ** 3
    pade = torch.where(small, 26 + 2 / 3 + 2 + 2 / 3 + 4,
                       8 + 2 / 3 + 2) * r ** 3
    return float((pade + 2 * r ** 3 + nsq * per_round).sum())


def _q1_terms_flops(r):
    # Cholesky of Q1, two triangular solves for Q1^{-1} e, L^{-1}, and
    # the two products d_left, d_right
    return (1 / 3 + 2 + 1 + 4) * r ** 3


def _sweep_row_flops(r):
    # one elimination row: C C^T, Cholesky, W0 (product + solve), w,
    # C_j (solve), W0^T W0, W0^T w
    return (2 + 1 / 3 + 3 + 1 + 2) * r ** 3 + 5 * r ** 2


def _adjoint_flops(g, dt):
    """Kernel 5 per gap: the forward recompute (as _tn_flops), Cholesky,
    five Q1^{-1} solves, four products of the q1-terms adjoint, two of
    the Q branch, the reversed rounds (8 products in the Van Loan regime,
    else 2) and the Pade-7 adjoint (~32 products, LU solves with 2R and
    R right-hand sides)."""
    r = g.shape[0]
    nsq, small = _rounds(g, dt)
    per_gap = (1 / 3 + 10 + 8 + 4 + 64 + 2 / 3 + 4 + 2 / 3 + 2) * r ** 3
    back = (nsq * torch.where(small, 16.0, 4.0) * r ** 3).sum()
    return _tn_flops(g, dt) + float(dt.numel() * per_gap + back)


# operations of one oscillator's closed-form gap terms (celerite.cuh
# osc_core: ~60 with each transcendental counted once) and of turning them
# into the precision row terms (adjugate inverse, off, d_right, d_left)
_OSC_FLOPS, _OSC_ROW_FLOPS = 60, 30


def _celerite_flops(kernel, args):
    """Operations of the celerite kernels, per step from each kernel's
    code, times the s * C steps of this call."""
    nb = args[0].shape[0]
    r = 2 * nb
    if kernel == "celerite_gap_mahal_sweep":
        steps = args[2].numel()
        # closed forms and row terms, K row, one elimination row
        return steps * (nb * (_OSC_FLOPS + _OSC_ROW_FLOPS) + 3 * r * r
                        + _sweep_row_flops(r))
    q = args[1].shape[0]
    steps = args[3].numel()
    if kernel == "celerite_filter_adjoint":
        # recompute (4q), P1 (2q), ebar blocks (4q + 10), the e^T
        # transforms (9), Kbar and PBtbar (6q), Gbar (5q), Sibar (2q^2),
        # the B cotangent (4q), the carry (6q), all times r^2
        per = (31 * q + 2 * q * q + 19) * r * r
    else:
        # B P, B F (4q), the H, F, P updates (6q), the predict's row and
        # column mixes (9), all times r^2
        per = (10 * q + 9) * r * r
    return steps * (per + nb * _OSC_FLOPS)


def _wide_read_bytes(kernel, args):
    """Bytes a wide kernel must read: of each wide block its a11 and the
    A21, A12^T and A22[:, :e] parts of its strips (64 + 16e + e^2 numbers;
    the strips' padding columns are never read), of each stack only the
    rows the function uses."""
    e = args[1].shape[1] // 3
    d, blk, c = 8 + e, 64 + 16 * e + e * e, args[0].shape[-1]
    if kernel == "backward_solve_takahashi_wide":
        sm1 = args[0].shape[0]
        # hat_C rows 0..s-3 (the last row's is not used), hat_W0 and pinv
        # all rows, hw1 and p00, p01, p10, p11 once; hat_w rows, xb, xb_next
        n = (sm1 - 1 + 2 * sm1 + 5) * blk + (sm1 + 2) * d
    else:
        s = args[0].shape[0]
        # R and y rows 1..s-1; O rows 0..s-1 for kernel 21 (its last hat_C
        # uses O_{s-1}), 0..s-2 for kernel 16
        o_rows = s if kernel == "forward_sweep_solveinv_wide" else s - 1
        n = (s - 1 + o_rows) * blk + (s - 1) * d
    return n * c * args[0].element_size()


def _elim_read_bytes(args):
    """Bytes an elimination sweep (kernels 1, 6, 8, 10) must read: of R
    only the lower triangle of rows 1..s-1 (row 0 is not eliminated and
    the Cholesky reads no more), O all rows (O_0 seeds row 1), y rows
    1..s-1; kernel 10 has no y."""
    s, r, _, c = args[0].shape
    n = (s - 1) * r * (r + 1) // 2 + s * r * r
    if len(args) > 2 and isinstance(args[2], torch.Tensor):
        n += (s - 1) * r
    return n * c * args[0].element_size()


def bound(kernel, args, outs, g=None, dt=None):
    """(least ms, "bytes" or "operations") for one kernel call."""
    # a runtime-d instance does the work of its rank-templated counterpart
    kernel = kernel.removesuffix("_rt")
    if kernel == "takahashi_backward":
        args = args[:11]  # the step s-1 a0 / a1 are not read
    if kernel.endswith("_wide"):
        # outputs at their full (padded) size: the kernels write it all
        nbytes = _wide_read_bytes(kernel, args) + _nbytes(outs)
    elif kernel in ELIM_KERNELS.values():
        nbytes = _elim_read_bytes(args) + _nbytes(outs)
    else:
        nbytes = _nbytes(args) + _nbytes(outs)
    if kernel.startswith("celerite"):
        flops = _celerite_flops(kernel, args)
    elif kernel == "transition_and_noise":
        flops = _tn_flops(g, dt)
    elif kernel == "k_system":
        r = g.shape[0]
        flops = _tn_flops(g, dt) + dt.numel() * _q1_terms_flops(r)
    elif kernel == "gap_mahal_sweep":
        r = g.shape[0]
        flops = _tn_flops(g, dt) + dt.numel() * (_q1_terms_flops(r)
                                                 + _sweep_row_flops(r))
    elif kernel == "k_system_adjoint":
        flops = _adjoint_flops(g, dt)
    elif kernel.endswith("_wide"):
        # wide pairs: args[0] is the a11 stack [s, 8, 8, C] of R (the
        # sweeps) or of hat_C [s-1, ...] (the descending walk), args[1]
        # the strips [., 3e, 8, C]; d = 8 + e
        s0, c = args[0].shape[0], args[0].shape[-1]
        d = 8 + args[1].shape[1] // 3
        walk = kernel == "backward_solve_takahashi_wide"
        per_row = {"forward_sweep_wide": _sweep_row_flops(d),
                   "forward_sweep_solveinv_wide": _sweep_row_flops(d)
                   + 7 * d ** 3 + 2 * d ** 2,
                   "backward_solve_takahashi_wide": 26 * d ** 3
                   + 4 * d ** 2}[kernel]
        flops = c * (s0 if walk else s0 - 1) * per_row
    else:
        # rows walked: args[0] is R_cm [s, ...] for the sweeps, a stack
        # [s-1, ...] for the descending walks (Takahashi: its rows s-3..0)
        s0, r, _, c = args[0].shape
        rows = c * {"backward_solve_takahashi": s0, "backward_substitute": s0,
                    "takahashi_backward": s0 - 1}.get(kernel, s0 - 1)
        per_row = {"forward_sweep": _sweep_row_flops(r),
                   "forward_sweep_solveinv": _sweep_row_flops(r)
                   + 7 * r ** 3 + 2 * r ** 2,
                   "backward_solve_takahashi": 26 * r ** 3 + 4 * r ** 2,
                   # the sweep plus two back substitutions and a vector one
                   "forward_sweep_collect": _sweep_row_flops(r)
                   + 2 * r ** 3 + r ** 2,
                   # two matrix-vector products and two subtractions
                   "backward_substitute": 4 * r ** 2 + 2 * r,
                   # the sweep without its right-hand side
                   "forward_sweep_inverse": (8 + 1 / 3) * r ** 3,
                   # D^{-1}, 14 products, two back substitutions (with the
                   # four of Sigma_BB U^T)
                   "takahashi_backward": 33 * r ** 3 + 6 * r ** 2}
        flops = rows * per_row[kernel]
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def make_system_cm(n, d, dev, seed=0):
    """bench.py's system (make_system_cm there): a diagonally dominant SPD
    block-tridiagonal system, condition number O(1) at any N, built with
    numpy in chunk-major layout [s, d, d, C] / [s, d, C], float32."""
    import numpy as np

    s = 32 if n < 32768 else 128  # partitioned.default_chunk_len
    rng = np.random.RandomState(seed)
    c = -(-n // s)
    m = c * s
    q = rng.randn(n, d, d).astype(np.float32)
    diag = np.broadcast_to(np.eye(d, dtype=np.float32), (m, d, d)).copy()
    diag[:n] = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d, dtype=np.float32)
    off = np.zeros((m, d, d), dtype=np.float32)
    off[: n - 1] = (rng.randn(n - 1, d, d) / d).astype(np.float32)
    v = np.zeros((m, d), dtype=np.float32)
    v[:n] = rng.randn(n, d).astype(np.float32)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev) for a in (
        diag.reshape(c, s, d, d).transpose(1, 2, 3, 0),
        off.reshape(c, s, d, d).transpose(1, 2, 3, 0),
        v.reshape(c, s, d).transpose(1, 2, 0)))


def dense_latent_predictive(leg, params, ts, xs, t_star):
    """Exact dense GP predictive (mean [r], cov [r, r]) of the latent at
    t_star, float64 (the oracle of tests/test_models.py)."""
    g = leg.g_matrix(params)
    b = params.b
    llt = leg.lambda_lambda_t(params)
    n, rank = ts.shape[0], params.rank

    def cross_cov(t1, t2):
        """Cov(z(t1_i), z(t2_j)) as the [len(t1) r, len(t2) r] block
        matrix: expm(-0.5 d G) for d = t1 - t2 >= 0, its transpose else."""
        dt = t1[:, None] - t2[None, :]
        e = torch.linalg.matrix_exp(-0.5 * dt.abs()[..., None, None] * g)
        e = torch.where((dt >= 0)[..., None, None], e, e.transpose(-1, -2))
        return e.permute(0, 2, 1, 3).reshape(t1.shape[0] * rank,
                                             t2.shape[0] * rank)

    eye_n = torch.eye(n, dtype=g.dtype, device=g.device)
    b_tilde = torch.kron(eye_n, b)
    cov_xx = (b_tilde @ cross_cov(ts, ts) @ b_tilde.T
              + torch.kron(eye_n, llt))
    cov_zx = cross_cov(t_star[None], ts) @ b_tilde.T
    mean = cov_zx @ torch.linalg.solve(cov_xx, xs.reshape(-1))
    cov = torch.eye(rank, dtype=g.dtype, device=g.device) - cov_zx @ \
        torch.linalg.solve(cov_xx, cov_zx.T)
    return mean, cov


def bench_grid(n, dev, seed=0):
    """examples/bench_celerite_train.py's grid: gaps randint(1, 5) * 0.125
    (float32 timestamps exact up to 2^24 * 0.125) and standard normal
    observations, obs_dim 1, float32."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ts = np.cumsum(rng.randint(1, 5, n) * 0.125)
    xs = rng.randn(n, 1)
    return (torch.as_tensor(ts, dtype=torch.float32).to(dev),
            torch.as_tensor(xs, dtype=torch.float32).to(dev))


def rel_inf(a, b):
    """||a - b||_inf / ||b||_inf."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


# the kernels of block sizes 9-15 that run one warp per chunk lane
# (csrc/rtcoop.cuh): the two Takahashi walks, kernels 20' and 22, the two
# collecting sweeps, kernels 17' and 21, the likelihood's sweep at d = 9-15
# (kernel 1's runtime-d instance), the selected inversion's sweep, kernel
# 19', and the wide likelihood sweep, kernel 16
WARP_KERNELS = ("rt_takahashi_kernel", "wide_backward_kernel",
                "rt_collect_kernel", "wide_solveinv_kernel",
                "rt_sweep_kernel", "rt_inverse_sweep_kernel",
                "wide_sweep_kernel")
WARP_DS = (9, 12, 15)  # block sizes of their shared-memory report
# kernels 6 and 7 at block size 16 (csrc/backward_sweep.cu), one warp per
# chunk lane on rtcoop.cuh
WARP16_KERNELS = ("solveinv_warp_kernel", "backsolve_warp_kernel")
# kernel 1 at block size 16 (csrc/forward_sweep.cu), kernels 14 and 13 at
# nblocks 5-8 (csrc/celerite_filter.cu) and kernel 18' (the solve's
# back-substitution at d = 9-15, csrc/rt_solve.cu), one warp per chunk
# lane: no local memory at all
WARP_NEW_KERNELS = ("forward_sweep_warp_kernel",
                    "celerite_filter_collect_warp_kernel",
                    "celerite_filter_warp_kernel", "rt_backsub_warp_kernel")
EDGES = ((9, 3, 1), (9, 3, 9), (15, 3, 1), (15, 3, 9))  # (d, s, C)
# 1, 6 and 7 at 16: the shortest chunk on a lone lane, one whole float32
# tile and a ragged one, and the chain's chunk length on its C = 245
EDGES16 = ((16, 3, 1), (16, 3, 8), (16, 3, 9), (16, 32, 245))
# each kernel's edge check: (module, wrapper, source, the TPU kernel, the
# entry whose top level hands it its inputs, what s = 3 gives it)
_TWO_ROWS = "two elimination rows, the first and one that carries"
EDGE_KERNELS = {
    "takahashi_backward_rt": (
        "sweep_cuda", "takahashi_backward_cuda", "rt_inverse.cu",
        "pallas_wide.py:812", "inverse_blocks_cm", "one recursion row"),
    "backward_solve_takahashi_wide": (
        "wide_cuda", "backward_solve_takahashi_wide_cuda", "wide_backward.cu",
        "pallas_wide.py:1199", "solve_and_inverse_cm",
        "two rows of the back-substitution and the walk"),
    "forward_sweep_collect_rt": (
        "sweep_cuda", "forward_sweep_collect_cuda", "rt_solve.cu",
        "pallas_wide.py:366", "solve_cm", _TWO_ROWS),
    "backward_substitute_rt": (
        "sweep_cuda", "backward_substitute_cuda", "rt_solve.cu",
        "pallas_wide.py:496", "solve_cm",
        "two rows, the first from hat_W1, the second carrying x"),
    "forward_sweep_solveinv_wide": (
        "wide_cuda", "forward_sweep_solveinv_wide_cuda", "wide_sweep.cu",
        "pallas_wide.py:998", "solve_and_inverse_cm", _TWO_ROWS),
    "forward_sweep_inverse_rt": (
        "sweep_cuda", "forward_sweep_inverse_cuda", "rt_inverse.cu",
        "pallas_wide.py:641", "inverse_blocks_cm", _TWO_ROWS),
    "forward_sweep_rt": (
        "sweep_cuda", "forward_sweep_cuda", "rt_solve.cu",
        "pallas_sweep.py:248", "mahal_and_logdet_cm", _TWO_ROWS),
    "forward_sweep": (
        "sweep_cuda", "forward_sweep_cuda", "forward_sweep.cu",
        "pallas_sweep.py:248", "mahal_and_logdet_cm", _TWO_ROWS),
    "forward_sweep_wide": (
        "wide_cuda", "forward_sweep_wide_cuda", "wide_sweep.cu",
        "pallas_wide.py:166", "mahal_and_logdet_wide", _TWO_ROWS),
    "forward_sweep_solveinv": (
        "sweep_cuda", "forward_sweep_solveinv_cuda", "backward_sweep.cu",
        "pallas_sweep.py:772", "solve_and_inverse_cm", _TWO_ROWS),
    "backward_solve_takahashi": (
        "sweep_cuda", "backward_solve_takahashi_cuda", "backward_sweep.cu",
        "pallas_sweep.py:918", "solve_and_inverse_cm",
        "two rows of the back-substitution and the walk"),
}


def run_edges(dev, phase, captured, capture, check_kernel, pt, kernels,
              edges=EDGES):
    """Each of ``kernels`` (keys of EDGE_KERNELS: 20', 17', 19' and 18' in
    [solve-rt], 22 and 21 in [wide], kernel 1's runtime-d instance in
    [sweep-rt], 1, 6 and 7 at block size 16 in [celerite]) against its twin
    at the edge shapes (d, s, C) of the warp-per-lane kernels: by default
    (EDGES) s = 3, shorter than any chunk the engine hands them (32 or
    128); C = 1, a lone lane, and C = 9, a ragged second tile of 8
    (float32) or 4 (float64) lanes; d = 9 and 15 (EDGES16 at d = 16 adds
    C = 8, one whole float32 tile, and s = 32 on C = 245); float32 and
    float64; on the inputs the top level of one call of the kernel's
    entry (inverse_blocks_cm, solve_and_inverse_cm, solve_cm,
    mahal_and_logdet_cm, or mahal_and_logdet_wide on the same blocks in
    the wide layout) hands it, under no_grad."""
    from cyclic_gps_tpu_torch.ops import sweep_cuda, wide_cuda

    modules = {"sweep_cuda": sweep_cuda, "wide_cuda": wide_cuda}
    for kernel in kernels:
        mod_name, attr, src, tpu, entry, why = EDGE_KERNELS[kernel]
        module = modules[mod_name]
        twin = getattr(module, attr.replace("_cuda", "_plain"))
        run = getattr(pt, entry)
        for d, s, c in edges:
            n = s * c
            system = nat_system(n + 1, d, dev, seed=60 + d + c)
            for dtype, (rtol, atol) in ((torch.float32, (1e-3, 1e-4)),
                                        (torch.float64, (1e-9, 1e-10))):
                diag, off, y = (t.to(dtype) for t in system)
                R_cm, O_cm, y_cm, _ = pt._chunk_layout(
                    diag[:n], off[:n - 1], y[:n], s)
                captured.clear()
                orig = capture(module, attr)
                try:
                    with torch.no_grad():
                        if entry == "inverse_blocks_cm":
                            run(R_cm, O_cm)
                        elif entry == "mahal_and_logdet_wide":
                            run(*pt._to_wide_stack(R_cm),
                                *pt._to_wide_stack(O_cm), y_cm)
                        else:
                            run(R_cm, O_cm, y_cm)
                    torch.cuda.synchronize()
                finally:
                    setattr(module, attr, orig)
                args_k, kw_k = captured[attr]
                check_kernel(
                    kernel, f"cyclic_gps_tpu_torch/csrc/{src}",
                    f"cyclic_gps_tpu/ops/{tpu}",
                    getattr(module, attr), twin, args_k, rtol, atol,
                    f"edge: d = {d}, s = {s}, C = {c}, {dtype}; "
                    f"{why if s == 3 else 'the chain chunk length'}; atol "
                    f"{atol:g} of each output's scale",
                    kw=kw_k, atol_of_scale=True, record=False, phase=phase,
                    reps=1)
                captured.clear()


WIDE_DS = (9, 12, 15)  # the wide block sizes checked; 12 is recorded
WIDE_D = 12
CEL_NB_WIDE = 6  # celerite at rank 12: the wide route on its boundary chain
N_WIDE_SMALL = 100_000  # celerite nblocks 5 and 7


def nat_system(n, d, dev, seed):
    """tests/test_wideblock.py's well-conditioned block-tridiagonal system
    (q q^T / d + 4 I on the diagonal, off-diagonal blocks / d, standard
    normal right-hand side), float32, drawn on the card from a seeded
    generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(n, d, d, generator=g, device=dev)
    diag = q @ q.transpose(1, 2) / d + 4 * torch.eye(d, device=dev)
    off = torch.randn(n - 1, d, d, generator=g, device=dev) / d
    y = torch.randn(n, d, generator=g, device=dev)
    return diag, off, y


def run_wide_phase(dev, rows, captured, capture, check_kernel, profiled,
                   grad_bar, celerite, loop, pt, ts_c, xs_c):
    """Phase 9: the natural engine at d = 9-15 and the celerite filter route
    at nblocks 5-7, through the wide kernels 16, 21 and 22."""
    from cyclic_gps_tpu_torch.ops import wide_cuda

    names = ("forward_sweep_wide", "forward_sweep_solveinv_wide",
             "backward_solve_takahashi_wide")
    wrappers = {k: getattr(wide_cuda, f"{k}_cuda") for k in names}
    meta = {  # source, line of the TPU kernel, tolerance reason (of s, C)
        "forward_sweep_wide": (
            "wide_sweep.cu", 166,
            lambda s, c: f"{s - 1} dependent elimination steps; mh and ld "
            f"summed over {s * c} rows in another order"),
        "forward_sweep_solveinv_wide": (
            "wide_sweep.cu", 998,
            lambda s, c: f"kernel 16's {s - 1} steps plus the triangular "
            "inverse behind pinv = P^{-1}"),
        "backward_solve_takahashi_wide": (
            "wide_backward.cu", 1199,
            lambda s, c: f"{s - 1} dependent multiply-add steps of the "
            "back-substitution and the Takahashi walk"),
    }

    def check_on_inputs(run, label, record, reps):
        """Hold kernels 16, 21 and 22 against their twins on the inputs
        ``run()`` hands them (each wrapper's largest call: the top level
        of the wide route); ``record`` adds the rows of the kernels line."""
        captured.clear()
        origs = [(wide_cuda, f"{k}_cuda", capture(wide_cuda, f"{k}_cuda"))
                 for k in names]
        run()
        torch.cuda.synchronize()
        for module, attr, orig in origs:
            setattr(module, attr, orig)
        if len(captured) != 3:
            fail(f"the wide route of {label} reached only "
                 f"{sorted(captured)}")
        for key in names:
            args_k, kw_k = captured[f"{key}_cuda"]
            src, line, why = meta[key]
            s = args_k[0].shape[0] + (key == "backward_solve_takahashi_wide")
            c = args_k[0].shape[-1]
            check_kernel(
                key, f"cyclic_gps_tpu_torch/csrc/{src}",
                f"cyclic_gps_tpu/ops/pallas_wide.py:{line}", wrappers[key],
                getattr(wide_cuda, f"{key}_plain"), args_k, 1e-3, 1e-4,
                f"{label}: d = {8 + args_k[1].shape[1] // 3}, s = {s}, "
                f"C = {c}; {why(s, c)}; atol 1e-4 of each output's scale",
                kw=kw_k, atol_of_scale=True, record=record, phase="wide",
                reps=reps)
        captured.clear()

    def loss_and_grads(system, backend):
        leaves = [t.clone().requires_grad_() for t in system]
        mh, ld = pt.mahal_and_logdet(*leaves, backend=backend)
        g = torch.autograd.grad(0.3 * mh + 0.7 * ld, leaves)
        return mh.detach(), ld.detach(), g

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    torch.cuda.empty_cache()
    say(f"[wide] the natural mahal_and_logdet at N {N_BIG}, d {WIDE_DS}: "
        "tests/test_wideblock.py's system (q q^T / d + 4 I, off / d), "
        "float32, seeded on the card; loss 0.3 mh + 0.7 ld")
    for d in WIDE_DS:
        system = nat_system(N_BIG, d, dev, seed=d)
        # the kernels' inputs as one gradient hands them
        check_on_inputs(lambda: loss_and_grads(system, "auto"),
                        f"the engine at N {N_BIG}", record=d == WIDE_D,
                        reps=3 if d == WIDE_D else 1)
        if d == WIDE_D:
            # the engine path: one gradient with backend="auto", counts
            # reset just before and read just after, then "torch"
            for w in wrappers.values():
                w.launches = 0
            ms_a, (mh_a, ld_a, g_a) = timed(
                lambda: loss_and_grads(system, "auto"))
            counts = {k: w.launches for k, w in wrappers.items()}
            say(f"[wide] launches in one backend='auto' value + gradient at "
                f"d {d}: {counts}")
            for k, n in counts.items():
                if n <= 0:
                    fail(f"kernel {k} was not launched by the wide engine")
            ms_t, (mh_t, ld_t, g_t) = timed(
                lambda: loss_and_grads(system, "torch"))
            rels = [abs(float(a) - float(b)) / abs(float(b))
                    for a, b in ((mh_a, mh_t), (ld_a, ld_t))]
            g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
            ok = (max(rels) <= 1e-4 and max(g_rels) <= grad_bar
                  and all(bool(torch.isfinite(t).all()) for t in g_a))
            say(f"[wide] d {d}: mh {float(mh_a):.6f} / {float(mh_t):.6f}, "
                f"ld {float(ld_a):.6f} / {float(ld_t):.6f} (auto / torch), "
                f"rel diff {rels[0]:.3e}, {rels[1]:.3e} <= 1e-4; gradient "
                f"per-leaf rel diff diag {g_rels[0]:.2e}, off "
                f"{g_rels[1]:.2e}, y {g_rels[2]:.2e} <= {grad_bar:g}; "
                f"value + gradient auto {ms_a:.1f} ms, torch {ms_t:.1f} ms "
                f"(host clock) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"the wide route at d = {d} disagrees with 'torch'")
            del g_a, g_t
            wall, by_kernel = profiled(lambda: loss_and_grads(system,
                                                              "auto"))
            if by_kernel:
                dev_ms = sum(ms for ms, _ in by_kernel.values())
                say(f"[wide] profiled value + gradient at d {d}: wall "
                    f"{wall:.2f} ms (profiler on), "
                    f"{sum(n for _, n in by_kernel.values())} device ops, "
                    f"device {dev_ms:.2f} ms, busy share "
                    f"{dev_ms / wall:.3f}")
            for key, (ms, n) in sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1][0])[:6]:
                say(f"[wide]   {key[:80]}: {ms:.3f} ms, {n} calls")
        del system
        torch.cuda.empty_cache()

    # celerite nblocks 6 (rank 12): the filter route's boundary chain
    # (7,813 -> 245 -> 8 blocks) runs kernel 16 at C = 245 and 8
    p6 = celerite.init_params(CEL_NB_WIDE, 1, generator=torch.Generator()
                              .manual_seed(0), device=dev)
    cel_leaves = ("n_diag", "n_sub", "r_sub", "lambda_params", "b")

    def cel_check(label, p, t, x, reps):
        # kernels 16, 21 and 22 on the inputs the boundary chain of one
        # gradient hands them (its top wide level)
        check_on_inputs(lambda: torch.autograd.grad(
            celerite.log_likelihood_filter(p, t, x), list(p.parameters())),
            f"celerite {label}", record=False, reps=reps)
        with torch.no_grad():
            ms_a, v_a = host_ms(lambda: celerite.log_likelihood_filter(
                p, t, x), reps=1)
            ms_t, v_t = host_ms(lambda: celerite.log_likelihood_filter(
                p, t, x, backend="torch"), reps=1)
        rel = abs(float(v_a) - float(v_t)) / abs(float(v_t))

        def grads(**kw):
            return torch.autograd.grad(
                celerite.log_likelihood_filter(p, t, x, **kw),
                list(p.parameters()))

        gms_a, g_a = host_ms(grads, reps=1)
        gms_t, g_t = host_ms(lambda: grads(backend="torch"), reps=1)
        g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
        ok = (bool(torch.isfinite(v_a)) and rel <= 1e-4
              and max(g_rels) <= grad_bar
              and all(bool(torch.isfinite(a).all()) for a in g_a))
        say(f"[wide] celerite {label}: log_likelihood_filter auto "
            f"{float(v_a):.6f} ({ms_a:.2f} ms), torch {float(v_t):.6f} "
            f"({ms_t:.2f} ms), rel diff {rel:.3e} <= 1e-4; gradient auto "
            f"{gms_a:.1f} ms, torch {gms_t:.1f} ms, per-leaf rel diff "
            + ", ".join(f"{k} {v:.2e}" for k, v in zip(cel_leaves, g_rels))
            + f" <= {grad_bar:g} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"celerite {label}: backend='auto' disagrees with 'torch'")

    cel_check(f"nblocks {CEL_NB_WIDE}, N {N_BIG}", p6, ts_c, xs_c, REPS)

    # the path: three Adam steps on nll_loss, counts reset just before and
    # read just after
    path = ("celerite_filter", "celerite_filter_collect",
            "celerite_filter_adjoint") + names
    counters = {r["name"]: r["kernel"] for r in rows}
    opt = loop.make_optimizer("adam", 1e-3, reduce_on_plateau=False)

    def adam_step():
        loss = celerite.nll_loss(p6, ts_c, xs_c)
        for t in p6.parameters():
            t.grad = None
        loss.backward()
        opt.step(p6, loss.item())
        return loss.item()

    for r in rows:
        r["kernel"].launches = 0
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        ms, loss = timed(adam_step)
        step_ms.append(ms)
        losses.append(loss)
    counts = {k: counters[k].launches for k in path}
    say(f"[wide] launches in {TRAIN_STEPS} Adam steps on nll_loss at "
        f"nblocks {CEL_NB_WIDE}: {counts}")
    for k in path:
        if counts[k] <= 0:
            fail(f"kernel {k} was not launched by the celerite nblocks "
                 f"{CEL_NB_WIDE} path")
    for r in rows:
        if r["name"] in names:
            r["launches"] = counts[r["name"]]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite celerite loss at nblocks {CEL_NB_WIDE}: {losses}")
    say(f"[wide] Adam losses {losses}; step ms "
        f"{[round(t, 2) for t in step_ms]}, median "
        f"{statistics.median(step_ms):.2f} ms (host clock, synchronised; "
        "the first step includes warm-up)")
    wall, by_kernel = profiled(adam_step)
    if not by_kernel:
        say("[wide] profiled step: the profiler saw no device events; "
            "device ops and busy share not measured")
    else:
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        n_ops = sum(n for _, n in by_kernel.values())
        say(f"[wide] profiled Adam step at nblocks {CEL_NB_WIDE}: wall "
            f"{wall:.2f} ms (profiler on), {n_ops} device ops, device "
            f"{dev_ms:.2f} ms, busy share {dev_ms / wall:.3f}")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :10]:
        say(f"[wide]   {key[:80]}: {ms:.3f} ms, {n} calls")

    # nblocks 5 and 7 (rank 10 and 14), value and gradient
    ts_s, xs_s = bench_grid(N_WIDE_SMALL, dev, seed=3)
    for nb in (5, 7):
        p = celerite.init_params(nb, 1, generator=torch.Generator()
                                 .manual_seed(nb), device=dev)
        cel_check(f"nblocks {nb}, N {N_WIDE_SMALL}", p, ts_s, xs_s, 1)

    # kernels 22, 21 and 16 at their edge shapes
    run_edges(dev, "wide", captured, capture, check_kernel, pt,
              ("backward_solve_takahashi_wide", "forward_sweep_solveinv_wide",
               "forward_sweep_wide"))


SOLVE_RT_DS = (9, 12, 15)  # the runtime-d block sizes checked; 12 recorded
N_RT64 = 100_000  # the float64 check of the runtime-d kernels


def run_solve_rt_phase(dev, rows, captured, capture, check_kernel, grad_bar,
                       pt):
    """Phase 10: the natural solve and selected inversion at d = 9-15
    through the runtime-d kernels 17-20 (the wrappers of kernels 8-11 at
    those sizes) and, in the solve's backward, the wide kernels 21, 22."""
    from cyclic_gps_tpu_torch.ops import sweep_cuda, wide_cuda

    names = ("forward_sweep_collect", "backward_substitute",
             "forward_sweep_inverse", "takahashi_backward")
    wrappers = {k: getattr(sweep_cuda, f"{k}_cuda") for k in names}
    backward = {k: getattr(wide_cuda, f"{k}_cuda") for k in (
        "forward_sweep_solveinv_wide", "backward_solve_takahashi_wide")}
    meta = {  # source, line of the TPU kernel, tolerance reason (of s)
        "forward_sweep_collect": (
            "rt_solve.cu", 366,
            lambda s: f"{s - 1} dependent elimination steps plus three back "
            "substitutions per row"),
        "backward_substitute": (
            "rt_solve.cu", 496,
            lambda s: f"{s - 1} dependent rows of two matrix-vector "
            "products, one warp per chunk lane"),
        "forward_sweep_inverse": (
            "rt_inverse.cu", 641,
            lambda s: f"{s - 1} dependent elimination steps"),
        "takahashi_backward": (
            "rt_inverse.cu", 812,
            lambda s: f"{s - 2} dependent steps of ~15 products each"),
    }
    ld_weight = 0.7
    t_phase = time.perf_counter()

    def weights(x):
        g = torch.Generator(device=x.device).manual_seed(7)
        return torch.randn(x.shape, generator=g, device=x.device,
                           dtype=x.dtype)

    def solve_grads(system, backend):
        leaves = [t.clone().requires_grad_() for t in system]
        x, ld = pt.solve_and_logdet(*leaves, backend=backend)
        g = torch.autograd.grad(torch.sum(x * weights(x)) + ld_weight * ld,
                                leaves)
        return x.detach(), ld.detach(), g

    def inverse(system, backend):
        with torch.no_grad():
            return pt.inverse_blocks(system[0], system[1], backend=backend)

    def check_on_inputs(system, label, record, reps, bars):
        """Hold kernels 17-20 against their twins on the inputs one solve
        value + gradient and one inverse_blocks call hand the wrappers
        (each wrapper's largest call: the top level)."""
        captured.clear()
        origs = [(sweep_cuda, f"{k}_cuda", capture(sweep_cuda, f"{k}_cuda"))
                 for k in names]
        solve_grads(system, "auto")
        inverse(system, "auto")
        torch.cuda.synchronize()
        for module, attr, orig in origs:
            setattr(module, attr, orig)
        if len(captured) != 4:
            fail(f"the solve and selected inversion of {label} reached only "
                 f"{sorted(captured)}")
        rtol, atol = bars
        for key in names:
            args_k, kw_k = captured[f"{key}_cuda"]
            src, line, why = meta[key]
            # the descending walks take [s-1, ...] stacks
            walk = key in ("backward_substitute", "takahashi_backward")
            s = args_k[0].shape[0] + walk
            check_kernel(
                f"{key}_rt", f"cyclic_gps_tpu_torch/csrc/{src}",
                f"cyclic_gps_tpu/ops/pallas_wide.py:{line}", wrappers[key],
                getattr(sweep_cuda, f"{key}_plain"), args_k, rtol, atol,
                f"{label}: d = {args_k[0].shape[1]}, s = {s}, C = "
                f"{args_k[0].shape[-1]}, {args_k[0].dtype}; {why(s)}; atol "
                f"{atol:g} of each output's scale",
                kw=kw_k, atol_of_scale=True, record=record,
                phase="solve-rt", reps=reps)
        captured.clear()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def counts():
        return {**{f"{k}_rt": w.launches_rt for k, w in wrappers.items()},
                **{k: w.launches for k, w in wrappers.items()},
                **{k: w.launches for k, w in backward.items()}}

    def reset():
        for w in wrappers.values():
            w.launches = w.launches_rt = 0
        for w in backward.values():
            w.launches = 0

    torch.cuda.empty_cache()
    say(f"[solve-rt] the natural solve_and_logdet (value and the gradient of "
        f"sum(x w) + {ld_weight} ld, w seeded) and inverse_blocks at N "
        f"{N_BIG}, d {SOLVE_RT_DS}: tests/test_wideblock.py's system, "
        "float32, seeded on the card")
    f32_bars = (1e-3, 1e-4)  # the [kernels] bars of kernels 8-11
    for d in SOLVE_RT_DS:
        system = nat_system(N_BIG, d, dev, seed=20 + d)
        check_on_inputs(system, f"N {N_BIG}", record=d == WIDE_D,
                        reps=3 if d == WIDE_D else 1, bars=f32_bars)
        if d != WIDE_D:
            del system
            torch.cuda.empty_cache()
            continue
        # the path: counts reset just before each call and read just after
        reset()
        ms_a, (x_a, ld_a, g_a) = timed(lambda: solve_grads(system, "auto"))
        solve_counts = counts()
        reset()
        ims_a, inv_a = timed(lambda: inverse(system, "auto"))
        inv_counts = counts()
        say(f"[solve-rt] launches in one backend='auto' solve_and_logdet "
            f"value + gradient at d {d}: {solve_counts}; in one "
            f"inverse_blocks call: {inv_counts}")
        for k in ("forward_sweep_collect_rt", "backward_substitute_rt",
                  "forward_sweep_solveinv_wide",
                  "backward_solve_takahashi_wide"):
            if solve_counts[k] <= 0:
                fail(f"kernel {k} was not launched by the natural solve")
        for k in ("forward_sweep_inverse_rt", "takahashi_backward_rt"):
            if inv_counts[k] <= 0:
                fail(f"kernel {k} was not launched by inverse_blocks")
        for k in names:
            if solve_counts[k] or inv_counts[k]:
                fail(f"the rank-templated {k} ran at d = {d}")
        for r in rows:
            if r["name"] in [f"{k}_rt" for k in names]:
                r["launches"] = (solve_counts[r["name"]]
                                 + inv_counts[r["name"]])
        ms_t, (x_t, ld_t, g_t) = timed(lambda: solve_grads(system, "torch"))
        rel_x, rel_ld = rel_inf(x_a, x_t), abs(float(ld_a - ld_t)
                                               / float(ld_t))
        g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
        ok = (rel_x <= 1e-4 and rel_ld <= 1e-4 and max(g_rels) <= grad_bar
              and all(bool(torch.isfinite(t).all()) for t in g_a))
        say(f"[solve-rt] d {d}: x rel diff {rel_x:.3e} <= 1e-4 (the "
            f"bench.py solve_cm bar), ld {float(ld_a):.6f} / "
            f"{float(ld_t):.6f} (auto / torch) rel diff {rel_ld:.3e} <= "
            f"1e-4; gradient per-input rel diff diag {g_rels[0]:.2e}, off "
            f"{g_rels[1]:.2e}, y {g_rels[2]:.2e} <= {grad_bar:g}; value + "
            f"gradient auto {ms_a:.1f} ms, torch {ms_t:.1f} ms (host "
            f"clock) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"the natural solve at d = {d} disagrees with 'torch'")
        del x_a, x_t, g_a, g_t
        ims_t, inv_t = timed(lambda: inverse(system, "torch"))
        compare(f"inverse_blocks d {d}", inv_a, inv_t, 0.0, 1e-3,
                atol_of_scale=True)
        say(f"[solve-rt] inverse_blocks d {d}: auto {ims_a:.1f} ms, torch "
            f"{ims_t:.1f} ms (host clock); agree (max |auto - torch| <= "
            "1e-3 of each output's largest entry)")
        del system, inv_a, inv_t
        torch.cuda.empty_cache()
    system = tuple(t.double() for t in nat_system(N_RT64, WIDE_D, dev,
                                                  seed=40))
    check_on_inputs(system, f"N {N_RT64}", record=False, reps=1,
                    bars=(1e-9, 1e-10))
    del system
    torch.cuda.empty_cache()
    # kernels 20', 17', 19' and 18' at their edge shapes
    run_edges(dev, "solve-rt", captured, capture, check_kernel, pt,
              ("takahashi_backward_rt", "forward_sweep_collect_rt",
               "forward_sweep_inverse_rt", "backward_substitute_rt"))
    say(f"[solve-rt] phase took {time.perf_counter() - t_phase:.1f} s")


SWEEP_RT_DS = (9, 12, 15)  # kernel 1's runtime-d sizes checked; 12 recorded


def run_sweep_rt_phase(dev, rows, captured, capture, check_kernel, grad_bar,
                       pt, celerite, ts_c, xs_c):
    """Phase 11: kernel 1 at d = 9-15 (rt_solve.cu's runtime-d sweep) and
    the paths it opens: the chunk-major (mahal, logdet) with its gradient,
    the per-row log-dets, and celerite's precision route at nblocks 6."""
    from cyclic_gps_tpu_torch.ops import sweep_cuda

    t_phase = time.perf_counter()
    wrapper = sweep_cuda.forward_sweep_cuda

    def chunked(system):
        return pt._chunk_layout(*system, pt.default_chunk_len(
            system[0].shape[0]))[:3]

    def check_on_inputs(cm, label, record, reps, bars):
        """Kernel 1's runtime-d instance against its twin on the inputs one
        mahal_and_logdet_cm call hands it (its top level)."""
        captured.clear()
        orig = capture(sweep_cuda, "forward_sweep_cuda")
        try:
            with torch.no_grad():
                pt.mahal_and_logdet_cm(*cm)
            torch.cuda.synchronize()
        finally:
            sweep_cuda.forward_sweep_cuda = orig
        args_k, kw_k = captured["forward_sweep_cuda"]
        s, d, _, c = args_k[0].shape
        rtol, atol = bars
        check_kernel(
            "forward_sweep_rt", "cyclic_gps_tpu_torch/csrc/rt_solve.cu",
            "cyclic_gps_tpu/ops/pallas_sweep.py:248", wrapper,
            sweep_cuda.forward_sweep_plain, args_k, rtol, atol,
            f"{label}: d = {d}, s = {s}, C = {c}, {args_k[0].dtype}; {s - 1} "
            f"dependent elimination steps, mh and ld summed over {s * c} "
            f"rows in another order; atol {atol:g} of each output's scale",
            kw=kw_k, atol_of_scale=True, record=record, phase="sweep-rt",
            reps=reps)
        captured.clear()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def mahal_grads(cm, backend):
        leaves = [t.clone().requires_grad_() for t in cm]
        mh, ld = pt.mahal_and_logdet_cm(*leaves, backend=backend)
        g = torch.autograd.grad(0.3 * mh + 0.7 * ld, leaves)
        return mh.detach(), ld.detach(), g

    def ld_rows(cm, backend):
        with torch.no_grad():
            return pt.logdet_rows_cm(cm[0], cm[1], backend=backend)

    def reset():
        wrapper.launches = wrapper.launches_rt = 0

    torch.cuda.empty_cache()
    say(f"[sweep-rt] kernel 1 at block sizes {SWEEP_RT_DS} (csrc/rt_solve.cu"
        f"'s runtime-d sweep) on the chunk-major system of "
        f"tests/test_wideblock.py at N {N_BIG} (s 128), float32, seeded on "
        "the card; mahal_and_logdet_cm (loss 0.3 mh + 0.7 ld) and "
        "logdet_rows_cm with backend='auto' against 'torch'")
    f32_bars = (1e-3, 1e-4)  # the [kernels] bars of kernel 1
    for d in SWEEP_RT_DS:
        cm = chunked(nat_system(N_BIG, d, dev, seed=50 + d))
        check_on_inputs(cm, f"N {N_BIG}", record=d == WIDE_D,
                        reps=REPS if d == WIDE_D else 1, bars=f32_bars)
        if d != WIDE_D:
            del cm
            torch.cuda.empty_cache()
            continue
        # the paths: counts reset just before each call, read just after
        reset()
        ms_a, (mh_a, ld_a, g_a) = timed(lambda: mahal_grads(cm, "auto"))
        n_mahal = (wrapper.launches, wrapper.launches_rt)
        reset()
        rms_a, rows_a = timed(lambda: ld_rows(cm, "auto"))
        n_rows = (wrapper.launches, wrapper.launches_rt)
        say(f"[sweep-rt] launches of forward_sweep_cuda (rank-templated, "
            f"runtime-d) in one backend='auto' mahal_and_logdet_cm value + "
            f"gradient at d {d}: {n_mahal}; in one logdet_rows_cm call: "
            f"{n_rows}")
        for label, (n_rank, n_rt) in (("mahal_and_logdet_cm", n_mahal),
                                      ("logdet_rows_cm", n_rows)):
            if n_rt <= 0 or n_rank:
                fail(f"{label} at d = {d} did not take kernel 1's runtime-d "
                     "instance alone")
        for r in rows:
            if r["name"] == "forward_sweep_rt":
                r["launches"] = n_mahal[1] + n_rows[1]
        ms_t, (mh_t, ld_t, g_t) = timed(lambda: mahal_grads(cm, "torch"))
        rels = [abs(float(a) - float(b)) / abs(float(b))
                for a, b in ((mh_a, mh_t), (ld_a, ld_t))]
        g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
        ok = (max(rels) <= 1e-4 and max(g_rels) <= grad_bar
              and all(bool(torch.isfinite(t).all()) for t in g_a))
        say(f"[sweep-rt] mahal_and_logdet_cm d {d}: mh {float(mh_a):.6f} / "
            f"{float(mh_t):.6f}, ld {float(ld_a):.6f} / {float(ld_t):.6f} "
            f"(auto / torch), rel diff {rels[0]:.3e}, {rels[1]:.3e} <= 1e-4 "
            f"(the likelihood's bar at N = 1e6); gradient per-input rel "
            f"diff R {g_rels[0]:.2e}, O {g_rels[1]:.2e}, y {g_rels[2]:.2e} "
            f"<= {grad_bar:g}; value + gradient auto {ms_a:.1f} ms, torch "
            f"{ms_t:.1f} ms (host clock) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"mahal_and_logdet_cm at d = {d} disagrees with 'torch'")
        del g_a, g_t
        rms_t, rows_t = timed(lambda: ld_rows(cm, "torch"))
        compare(f"logdet_rows_cm d {d}", rows_a, rows_t, 0.0, 1e-4,
                atol_of_scale=True)
        say(f"[sweep-rt] logdet_rows_cm d {d} ([s, C] = "
            f"{list(rows_a.shape)}): auto {rms_a:.1f} ms, torch {rms_t:.1f} "
            "ms (host clock); agree (max |auto - torch| <= 1e-4 of the "
            "largest row)")
        del cm, rows_a, rows_t
        torch.cuda.empty_cache()
    system = tuple(t.double() for t in nat_system(N_RT64, WIDE_D, dev,
                                                  seed=70))
    check_on_inputs(chunked(system), f"N {N_RT64}", record=False, reps=1,
                    bars=(1e-9, 1e-10))
    del system
    torch.cuda.empty_cache()

    # celerite's precision route at nblocks 6: kernel 12, then the reduced
    # system's top level through kernel 1 at rank 12 (C = 245)
    p6 = celerite.init_params(CEL_NB_WIDE, 1, generator=torch.Generator()
                              .manual_seed(6), device=dev)
    cel_leaves = ("n_diag", "n_sub", "r_sub", "lambda_params", "b")

    def cel_grads(**kw):
        v = celerite.log_likelihood(p6, ts_c, xs_c, **kw)
        return v.detach(), torch.autograd.grad(v, list(p6.parameters()))

    with torch.no_grad():  # the value alone, twice (kernel 12 first)
        ms_v = [timed(lambda: celerite.log_likelihood(p6, ts_c, xs_c))[0]
                for _ in range(2)]
    say(f"[sweep-rt] celerite log_likelihood (precision route) nblocks "
        f"{CEL_NB_WIDE}, N {N_BIG}: one call with backend='auto' "
        f"{ms_v[0]:.1f}, {ms_v[1]:.1f} ms (host clock)")
    reset()
    ms_a, (v_a, g_a) = timed(cel_grads)
    n_cel = (wrapper.launches, wrapper.launches_rt)
    ms_t, (v_t, g_t) = timed(lambda: cel_grads(backend="torch"))
    rel = abs(float(v_a) - float(v_t)) / abs(float(v_t))
    g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
    ok = (n_cel[1] > 0 and bool(torch.isfinite(v_a)) and rel <= 1e-4
          and max(g_rels) <= grad_bar
          and all(bool(torch.isfinite(a).all()) for a in g_a))
    say(f"[sweep-rt] celerite log_likelihood (precision route) nblocks "
        f"{CEL_NB_WIDE}, N {N_BIG}, bench grid: auto {float(v_a):.6f}, torch "
        f"{float(v_t):.6f}, rel diff {rel:.3e} <= 1e-4; gradient per-leaf "
        "rel diff "
        + ", ".join(f"{k} {v:.2e}" for k, v in zip(cel_leaves, g_rels))
        + f" <= {grad_bar:g}; value + gradient auto {ms_a:.1f} ms, torch "
        f"{ms_t:.1f} ms (host clock); forward_sweep_cuda launches "
        f"(rank-templated, runtime-d) {n_cel} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("celerite's precision route at nblocks 6 failed")

    # kernel 1's runtime-d instance at the edge shapes
    run_edges(dev, "sweep-rt", captured, capture, check_kernel, pt,
              ("forward_sweep_rt",))
    say(f"[sweep-rt] phase took {time.perf_counter() - t_phase:.1f} s")


ADJ_EDGE_NBS = (1, 2, 5, 8)  # kernel 15's edge nblocks, obs 1 and 2


def run_adjoint_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                      xs_c):
    """Kernel 15's two designs (one thread per lane, routed at nblocks
    1..4; one warp per lane, routed at 5..8 and forced by ``warp=True``)
    against its twin at nblocks 1, 2, 5, 8 and obs 1, 2 on the inputs one
    filter-route gradient hands it at N = 283 (s = 32, C = 9: a ragged
    last chunk and a ragged second tile of 8 lanes) and on lane 0 of them
    alone (C = 1); then both designs at nblocks 2 and the routed one at
    nblocks 6, N = 1e6 on the bench grid (the inputs of the training
    steps), timed."""
    wrapper = celerite_cuda.celerite_filter_adjoint_cuda

    def inputs(nb, q, t, x, seed):
        p = celerite.init_params(nb, q, generator=torch.Generator()
                                 .manual_seed(seed), device=dev)
        got = {}
        orig = celerite.celerite_filter_adjoint_cuda

        def spy(*a):
            got["args"] = a
            return orig(*a)

        celerite.celerite_filter_adjoint_cuda = spy
        try:
            torch.autograd.grad(celerite.log_likelihood_filter(p, t, x),
                                list(p.parameters()))
            torch.cuda.synchronize()
        finally:
            celerite.celerite_filter_adjoint_cuda = orig
        return got["args"]

    def lane0(args):
        gb, b, lam, dt, gv, real, y, hists, cots = args
        f = lambda t: t[..., :1].contiguous()  # noqa: E731
        return (gb, b, lam, f(dt), f(gv), f(real), f(y),
                tuple(map(f, hists)), tuple(map(f, cots)))

    def check(args, label, reps, warp=False):
        nb, c = args[0].shape[0], args[3].shape[-1]
        before = wrapper.launches_warp
        design = ("warp per lane" if warp or nb >= celerite_cuda.WARP_NBLOCKS
                  else "thread per lane")
        check_kernel(
            "celerite_filter_adjoint",
            "cyclic_gps_tpu_torch/csrc/celerite_adjoint.cu",
            "cyclic_gps_tpu/ops/celerite_pallas.py:813",
            functools.partial(wrapper, warp=warp),
            celerite_cuda.celerite_filter_adjoint_plain, args, 1e-3, 1e-4,
            f"{label}, {design}: nblocks {nb}, obs {args[6].shape[1]}, s "
            f"{args[3].shape[0]}, C {c}; {args[3].shape[0]} dependent "
            "adjoint steps, bbar and lambar summed over the lanes in "
            "another order; atol 1e-4 of each output's scale",
            atol_of_scale=True, record=False, phase="celerite", reps=reps)
        if (wrapper.launches_warp > before) != (design == "warp per lane"):
            fail(f"kernel 15 at nblocks {nb} took the wrong design")

    rng = torch.Generator().manual_seed(9)
    n = 32 * 9 - 5
    t_e = torch.cumsum(torch.randint(1, 5, (n,), generator=rng) * 0.125,
                       0).to(dev)
    for nb in ADJ_EDGE_NBS:
        for q in (1, 2):
            x_e = torch.randn(n, q, generator=rng).to(dev)
            args = inputs(nb, q, t_e, x_e, seed=10 * nb + q)
            for warp in (False, True) if nb < celerite_cuda.WARP_NBLOCKS \
                    else (False,):
                check(args, "edge", 1, warp)
                check(lane0(args), "edge, one lane", 1, warp)
    # the two designs at nblocks 2 (the routing's evidence), then nblocks 6
    args = inputs(CEL_NB_SMALL, 1, ts_c, xs_c, seed=1)
    for warp in (False, True, True, False):
        check(args, f"N {N_BIG}, the bench grid", 3, warp)
    check(inputs(CEL_NB_WIDE, 1, ts_c, xs_c, seed=0),
          f"N {N_BIG}, the bench grid", 3)


COLLECT_EDGE_NBS = (1, 2, 5, 8)  # kernel 14's edge nblocks, obs 1 and 2


def run_collect_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                      xs_c):
    """Kernel 14's two designs (one thread per lane, routed at nblocks
    1..4; one warp per lane, routed at 5..8 and forced by ``warp=True``)
    against its twin at nblocks 1, 2, 5, 8 and obs 1, 2 on the inputs one
    filter-route gradient hands it at N = 283 (s = 32, C = 9: a ragged
    last chunk whose padding rows are masked gaps and unobserved rows,
    and a ragged second tile of 8 lanes) and on lane 0 of them alone
    (C = 1); then both designs at nblocks 2 and the routed one at nblocks
    6, N = 1e6 on the bench grid (the inputs of the training steps),
    timed."""
    wrapper = celerite_cuda.celerite_filter_collect_cuda

    def inputs(nb, q, t, x, seed):
        p = celerite.init_params(nb, q, generator=torch.Generator()
                                 .manual_seed(seed), device=dev)
        got = {}
        orig = celerite.celerite_filter_collect_cuda

        def spy(*a):
            got["args"] = a
            return orig(*a)

        celerite.celerite_filter_collect_cuda = spy
        try:
            torch.autograd.grad(celerite.log_likelihood_filter(p, t, x),
                                list(p.parameters()))
            torch.cuda.synchronize()
        finally:
            celerite.celerite_filter_collect_cuda = orig
        return got["args"]

    def lane0(args):
        f = lambda t: t[..., :1].contiguous()  # noqa: E731
        return args[:3] + tuple(map(f, args[3:]))

    def check(args, label, reps, warp=False):
        nb, (s, c) = args[0].shape[0], args[3].shape
        before = wrapper.launches_warp
        design = ("warp per lane"
                  if warp or nb >= celerite_cuda.COLLECT_WARP_NBLOCKS
                  else "thread per lane")
        masked = int((args[4] == 0).sum())
        unobserved = int((args[5] == 0).sum())
        check_kernel(
            "celerite_filter_collect",
            "cyclic_gps_tpu_torch/csrc/celerite_filter.cu",
            "cyclic_gps_tpu/ops/celerite_pallas.py:592",
            functools.partial(wrapper, warp=warp),
            celerite_cuda.celerite_filter_collect_plain, args, 1e-3, 1e-4,
            f"{label}, {design}: nblocks {nb}, obs {args[6].shape[1]}, s "
            f"{s}, C {c}, {masked} masked gaps, {unobserved} unobserved "
            f"rows; {s} dependent filter steps and their history; atol 1e-4 "
            "of each output's scale",
            atol_of_scale=True, record=False, phase="celerite", reps=reps)
        if (wrapper.launches_warp > before) != (design == "warp per lane"):
            fail(f"kernel 14 at nblocks {nb} took the wrong design")

    rng = torch.Generator().manual_seed(13)
    n = 32 * 9 - 5
    t_e = torch.cumsum(torch.randint(1, 5, (n,), generator=rng) * 0.125,
                       0).to(dev)
    for nb in COLLECT_EDGE_NBS:
        for q in (1, 2):
            x_e = torch.randn(n, q, generator=rng).to(dev)
            args = inputs(nb, q, t_e, x_e, seed=30 + 10 * nb + q)
            if (int((args[4] == 0).sum()) == 0
                    or int((args[5] == 0).sum()) == 0):
                fail("kernel 14's edge inputs hold no masked gap or no "
                     "unobserved row")
            for warp in (False, True) \
                    if nb < celerite_cuda.COLLECT_WARP_NBLOCKS else (False,):
                check(args, "edge", 1, warp)
                check(lane0(args), "edge, one lane", 1, warp)
    # the two designs at nblocks 2 (the routing's evidence, in turns), then
    # nblocks 6
    args = inputs(CEL_NB_SMALL, 1, ts_c, xs_c, seed=1)
    for warp in (False, True, True, False):
        check(args, f"N {N_BIG}, the bench grid", 3, warp)
    check(inputs(CEL_NB_WIDE, 1, ts_c, xs_c, seed=0),
          f"N {N_BIG}, the bench grid", 3)


FILTER_EDGE_NBS = (1, 2, 5, 8)  # kernel 13's edge nblocks, obs 1 and 2


def run_filter_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                     xs_c):
    """Kernel 13's two designs (one thread per lane, routed at nblocks
    1..4; one warp per lane, routed from FILTER_WARP_NBLOCKS up and forced
    by ``warp=True``) against its twin at nblocks 1, 2, 5, 8 and obs 1, 2
    on the inputs one filter-route likelihood hands it at N = 283 (s = 32,
    C = 9: a ragged last chunk whose padding rows are masked gaps and
    unobserved rows, and a ragged second tile of 8 lanes) and on lane 0 of
    them alone (C = 1); its warp design's statistics equal to kernel 14's
    warp design's bit for bit on each of those inputs (one body, the same
    sums); then both designs at nblocks 2 and 4 (the evidence for
    FILTER_WARP_NBLOCKS, in turns) and the routed one at nblocks 6, N =
    1e6 on the bench grid, timed."""
    wrapper = celerite_cuda.celerite_filter_cuda
    collect = celerite_cuda.celerite_filter_collect_cuda

    def inputs(nb, q, t, x, seed):
        p = celerite.init_params(nb, q, generator=torch.Generator()
                                 .manual_seed(seed), device=dev)
        got = {}
        orig = celerite.celerite_filter_cuda

        def spy(*a):
            got["args"] = a
            return orig(*a)

        celerite.celerite_filter_cuda = spy
        try:
            with torch.no_grad():
                celerite.log_likelihood_filter(p, t, x)
            torch.cuda.synchronize()
        finally:
            celerite.celerite_filter_cuda = orig
        return got["args"]

    def lane0(args):
        f = lambda t: t[..., :1].contiguous()  # noqa: E731
        return args[:3] + tuple(map(f, args[3:]))

    def check(args, label, reps, warp=False):
        nb, (s, c) = args[0].shape[0], args[3].shape
        before = wrapper.launches_warp
        design = ("warp per lane"
                  if warp or nb >= celerite_cuda.FILTER_WARP_NBLOCKS
                  else "thread per lane")
        masked = int((args[4] == 0).sum())
        unobserved = int((args[5] == 0).sum())
        check_kernel(
            "celerite_filter",
            "cyclic_gps_tpu_torch/csrc/celerite_filter.cu",
            "cyclic_gps_tpu/ops/celerite_pallas.py:479",
            functools.partial(wrapper, warp=warp),
            celerite_cuda.celerite_filter_plain, args, 1e-3, 1e-4,
            f"{label}, {design}: nblocks {nb}, obs {args[6].shape[1]}, s "
            f"{s}, C {c}, {masked} masked gaps, {unobserved} unobserved "
            f"rows; {s} dependent filter steps; atol 1e-4 of each output's "
            "scale",
            atol_of_scale=True, record=False, phase="celerite", reps=reps)
        if (wrapper.launches_warp > before) != (design == "warp per lane"):
            fail(f"kernel 13 at nblocks {nb} took the wrong design")

    def same_as_14(args, label):
        with torch.no_grad():
            got13 = wrapper(*args, warp=True)
            got14, _ = collect(*args, warp=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got13, got14)):
            fail(f"kernel 13's warp statistics differ from kernel 14's "
                 f"({label})")

    rng = torch.Generator().manual_seed(17)
    n = 32 * 9 - 5
    t_e = torch.cumsum(torch.randint(1, 5, (n,), generator=rng) * 0.125,
                       0).to(dev)
    for nb in FILTER_EDGE_NBS:
        for q in (1, 2):
            x_e = torch.randn(n, q, generator=rng).to(dev)
            args = inputs(nb, q, t_e, x_e, seed=50 + 10 * nb + q)
            if (int((args[4] == 0).sum()) == 0
                    or int((args[5] == 0).sum()) == 0):
                fail("kernel 13's edge inputs hold no masked gap or no "
                     "unobserved row")
            for warp in (False, True) \
                    if nb < celerite_cuda.FILTER_WARP_NBLOCKS else (False,):
                check(args, "edge", 1, warp)
                check(lane0(args), "edge, one lane", 1, warp)
            same_as_14(args, f"edge, nblocks {nb}, obs {q}")
            same_as_14(lane0(args), f"edge, one lane, nblocks {nb}, obs {q}")
    say("[celerite] kernel 13's warp statistics == kernel 14's warp "
        f"statistics bit for bit at nblocks {FILTER_EDGE_NBS}, obs 1 and 2, "
        "C = 9 and 1")
    # the two designs at nblocks 2 and 4 (the routing's evidence, in
    # turns), then nblocks 6
    for nb in (2, 4):
        args = inputs(nb, 1, ts_c, xs_c, seed=nb)
        for warp in (False, True, True, False):
            check(args, f"N {N_BIG}, the bench grid", 3, warp)
        del args
    check(inputs(CEL_NB_WIDE, 1, ts_c, xs_c, seed=0),
          f"N {N_BIG}, the bench grid", 3)
    torch.cuda.empty_cache()


SWEEP_EDGE_NBS = (1, 2, 4, 5, 8)  # kernel 12's edge nblocks


def run_sweep_edges(dev, check_kernel, celerite, celerite_cuda, ts_c, xs_c):
    """Kernel 12's two designs (one thread per lane, routed at nblocks
    1..4; one warp per lane, routed at 5..8 and forced by ``warp=True``)
    against its twin at nblocks 1, 2, 4, 5, 8 on the inputs one
    precision-route likelihood hands it at N = 283 (s = 32, C = 9: a
    ragged second tile of 8 lanes, and a ragged last chunk whose padding
    rows are masked gaps, gv = 0, and unobserved rows, real = 0) and on
    that last lane alone (C = 1); then both designs at nblocks 2 and 4 and
    the routed one at nblocks 6, N = 1e6 on the bench grid, timed."""
    wrapper = celerite_cuda.celerite_gap_mahal_sweep_cuda

    def inputs(nb, t, x, seed):
        p = celerite.init_params(nb, 1, generator=torch.Generator()
                                 .manual_seed(seed), device=dev)
        got = {}
        orig = celerite.celerite_gap_mahal_sweep_cuda

        def spy(*a):
            got["args"] = a
            return orig(*a)

        celerite.celerite_gap_mahal_sweep_cuda = spy
        try:
            with torch.no_grad():
                celerite.log_likelihood(p, t, x)
            torch.cuda.synchronize()
        finally:
            celerite.celerite_gap_mahal_sweep_cuda = orig
        return got["args"]

    def last_lane(args):  # the ragged last chunk: its padding is masked
        f = lambda t: t[..., -1:].contiguous()  # noqa: E731
        return args[:2] + tuple(map(f, args[2:]))

    def check(args, label, reps, warp=False):
        nb, (s, c) = args[0].shape[0], args[2].shape
        before = wrapper.launches_warp
        design = ("warp per lane"
                  if warp or nb >= celerite_cuda.SWEEP_WARP_NBLOCKS
                  else "thread per lane")
        masked = int((args[3] == 0).sum())
        unobserved = int((args[4] == 0).sum())
        check_kernel(
            "celerite_gap_mahal_sweep",
            "cyclic_gps_tpu_torch/csrc/celerite_sweep.cu",
            "cyclic_gps_tpu/ops/celerite_pallas.py:285",
            functools.partial(wrapper, warp=warp),
            celerite_cuda.celerite_gap_mahal_sweep_plain, args, 1e-3, 1e-4,
            f"{label}, {design}: nblocks {nb}, s {s}, C {c}, {masked} "
            f"masked gaps, {unobserved} unobserved rows; {s - 1} dependent "
            "elimination steps on closed-form rows, mh, ld and the log|Q1| "
            "sum in another order; atol 1e-4 of each output's scale",
            atol_of_scale=True, record=False, phase="celerite", reps=reps)
        if (wrapper.launches_warp > before) != (design == "warp per lane"):
            fail(f"kernel 12 at nblocks {nb} took the wrong design")

    rng = torch.Generator().manual_seed(11)
    n = 32 * 9 - 5
    t_e = torch.cumsum(torch.randint(1, 5, (n,), generator=rng) * 0.125,
                       0).to(dev)
    x_e = torch.randn(n, 1, generator=rng).to(dev)
    for nb in SWEEP_EDGE_NBS:
        args = inputs(nb, t_e, x_e, seed=20 + nb)
        if int((args[3] == 0).sum()) == 0 or int((args[4] == 0).sum()) == 0:
            fail("kernel 12's edge inputs hold no masked gap or no "
                 "unobserved row")
        for warp in (False, True) if nb < celerite_cuda.SWEEP_WARP_NBLOCKS \
                else (False,):
            check(args, "edge", 1, warp)
            check(last_lane(args), "edge, one lane", 1, warp)
    # the two designs at nblocks 2 and 4 (the routing's evidence, in turns),
    # then nblocks 6
    for nb in (CEL_NB_SMALL, 4):
        args = inputs(nb, ts_c, xs_c, seed=nb)
        for warp in (False, True, True, False):
            check(args, f"N {N_BIG}, the bench grid", 3, warp)
    check(inputs(CEL_NB_WIDE, ts_c, xs_c, seed=0),
          f"N {N_BIG}, the bench grid", REPS)


# kernels 3, 4 and 5 at their edge shapes: (rank, s, C); C = 35 and 45 are
# no multiple of kernels 3's and 4's 32 lanes a block, s = 7 none of
# kernel 4's 3-row tile, s = 6 none of kernel 3's 7-row one (s = 7 fills
# it); 315 gaps fill two of kernel 5's 128-gap blocks and part of a third
EMISSION_EDGES = ((1, 6, 35), (5, 6, 35), (5, 7, 45), (8, 6, 35), (8, 7, 45))
EMISSION_ROUNDS = (0, 1, 2, 3, 5, 7, 9)  # squaring rounds of the edge gaps


def mixed_gaps(expm_cuda, g, s, c, seed, dev):
    """Chunk-major gaps dt [s, c] and validity gv [s, c] (float32) that
    mix, in every 32 consecutive gaps, EMISSION_ROUNDS squaring rounds
    and gaps just inside and just outside the Van Loan branch
    (dt ||G/2|| = 0.9, 1.1), each scaled by a seeded factor in [0.9, 1];
    every 7th gap and the last two are padding (gv = 0): the inputs of
    tests/test_torch_gap_kernels.py."""
    import numpy as np

    _, half, augn = expm_cuda._generator_norms(g.double().cpu())
    half, augn = float(half), float(augn)
    kinds = [3.92 * 2.0 ** (n - 0.5) / augn if n else 1.96 / augn
             for n in EMISSION_ROUNDS] + [0.9 / half, 1.1 / half]
    rng = np.random.RandomState(seed)
    m = np.arange(s * c)
    dt = np.array(kinds)[m % len(kinds)] * rng.uniform(0.9, 1.0, s * c)
    gv = np.where(m % 7 == 6, 0.0, 1.0)
    gv[-2:] = 0.0
    return tuple(torch.as_tensor(a.reshape(s, c), dtype=torch.float32)
                 .to(dev) for a in (dt, gv))


def run_emission_edges(dev, check_kernel, leg, expm_cuda, _build):
    """Kernels 5 (the emission adjoint, each block's gaps sorted by branch
    and rounds, rounds past the 4 stored ones recomputed), 4 (the fused
    emission sweep, 32 lanes a block in tiles of 3 rows) and 3 (the K
    system, one thread per gap in tiles of 32 lanes by 7 rows and a halo
    row) against their twins on `mixed_gaps` at EMISSION_EDGES, with
    seeded cotangents (5) and a seeded point mask (3, 4) and right-hand
    side (4); kernels 5 and 3 also give the same bits on a second run."""
    import numpy as np

    for r, s, c in EMISSION_EDGES:
        p = leg.init_params(r, OBS, generator=torch.Generator()
                            .manual_seed(r), dtype=torch.float32, device=dev)
        with torch.no_grad():
            g = leg.g_matrix(p).contiguous()
            boost = (p.b.T @ torch.linalg.solve(leg.lambda_lambda_t(p), p.b)
                     ).contiguous()
        dt, gv = mixed_gaps(expm_cuda, g, s, c, 10 * r + s, dev)
        rng = np.random.RandomState(10 * r + s + 1)
        cots = [torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev)
                for shape in [(s, r, r, c)] * 3 + [(s, c)]]
        args5 = (g, dt, gv, *cots)
        where = (f"edge: rank {r}, s = {s}, C = {c}; gaps of "
                 f"{', '.join(map(str, EMISSION_ROUNDS))} rounds and both "
                 "branches in every warp, padded gaps")
        check_kernel(
            "k_system_adjoint", "", "", expm_cuda.k_system_adjoint_cuda,
            expm_cuda.k_system_adjoint_plain, args5, 1e-3, 1e-4,
            f"{where}; atol 1e-4 of each output's scale, c_dt's 4x the "
            "float32 twin's error against float64", atol_of_scale=True,
            gaps_of=dt, f64_outputs=(2,), record=False, phase="emission",
            reps=1)
        with torch.no_grad():
            once = expm_cuda.k_system_adjoint_cuda(*args5)
            twice = expm_cuda.k_system_adjoint_cuda(*args5)
            torch.cuda.synchronize()
        if not all(bool(torch.equal(a, b)) for a, b in zip(once, twice)):
            fail(f"k_system_adjoint at rank {r}: two runs differ")
        real = torch.as_tensor((rng.rand(s, c) < 0.8).astype(np.float32)
                               ).to(dev)
        with torch.no_grad():
            wrap = leg._wrap_row(g, dt, gv, s).contiguous()
        y = torch.as_tensor(rng.randn(s, r, c).astype(np.float32)).to(dev)
        check_kernel(
            "gap_mahal_sweep", "", "", expm_cuda.gap_mahal_sweep_cuda,
            expm_cuda.gap_mahal_sweep_plain,
            (g, boost, dt, gv, real, wrap, y), 1e-3, 1e-4,
            f"{where}; atol 1e-4 of each output's scale", atol_of_scale=True,
            gaps_of=dt, record=False, phase="emission", reps=1)
        dt2 = dt.reshape(-1).contiguous()
        got2 = check_kernel(
            "transition_and_noise", "", "",
            expm_cuda.transition_and_noise_cuda,
            expm_cuda.transition_and_noise_plain, (g, dt2), 1e-4, 1e-6,
            f"{where}; the [kernels] row's bars", gaps_of=dt2, record=False,
            phase="emission", reps=1)
        with torch.no_grad():
            ref2 = expm_cuda.transition_and_noise_plain(g, dt2)
            for design in TN_KERNELS:
                compare(f"transition_and_noise rank {r}, {design} design",
                        expm_cuda._tn_launch(design, g, dt2), ref2, 1e-4,
                        1e-6)
        args3 = (g, boost, dt, gv, real, wrap)
        check_kernel(
            "k_system", "", "", expm_cuda.k_system_cuda,
            expm_cuda.k_system_plain, args3, 1e-3, 1e-4,
            f"{where}; atol 1e-4 of each output's scale", atol_of_scale=True,
            gaps_of=dt, record=False, phase="emission", reps=1)
        with torch.no_grad():
            once = expm_cuda.k_system_cuda(*args3)
            twice = expm_cuda.k_system_cuda(*args3)
            torch.cuda.synchronize()
        if not all(bool(torch.equal(a, b)) for a, b in zip(once, twice)):
            fail(f"k_system at rank {r}: two runs differ")
    say(f"[emission] kernels 5, 4, 2 and 3 agree with their twins at "
        f"{len(EMISSION_EDGES)} edge shapes (kernel 2 in both its designs); "
        "kernels 5 and 3 give the same bits on a second run at each")


# kernel 7 at ranks 1-8 (32 chunk lanes a block, or 16 / 8 where shared
# memory is short; a chain warp and three output warps, tiles of 3 rows):
# s = 2 is the seed row alone, s = 3 the seed and one row of the chain, s =
# 7 two tiles (a tile boundary inside the chain, then a ragged tile); C = 1
# a lone lane, 35 and 45 a ragged second block
WALK_EDGES = tuple((r, s, c) for r in (1, 5, 8) for s in (2, 3, 7)
                   for c in (1, 35, 45))


def dominant_system(rng, r, n):
    """(diag, off, y) of a block-tridiagonal system diagonally dominant at
    every block size r (q q^T / r + 4 I on the diagonal, off-diagonal
    blocks randn / 2r) on n rows, drawn from the numpy generator rng."""
    import numpy as np

    q = rng.randn(n, r, r)
    return (q @ q.transpose(0, 2, 1) / r + 4 * np.eye(r),
            rng.randn(n - 1, r, r) / (2 * r), rng.randn(n, r))


def run_walk_edges(dev, check_kernel, sweep_cuda, pt):
    """Kernel 7's split design against its twin at WALK_EDGES, float32
    and float64, on kernel 6's four hat stacks (its twin, pivot jitter
    1e-3) for a block-tridiagonal system diagonally dominant at every
    block size (q q^T / d + 4 I, off-diagonal blocks randn / 2d, seeded),
    with hat_W1, x_b, x_b_next and p00..p11 drawn from a numpy seed (scale
    0.3); each gives the same bits on a second run, and every launch
    takes the split design."""
    import numpy as np

    k7 = sweep_cuda.backward_solve_takahashi_cuda
    n0, n_split = k7.launches, k7.launches_split
    for r, s, c in WALK_EDGES:
        rng = np.random.RandomState(100 * r + 10 * s + c)
        system = dominant_system(rng, r, s * c)
        extra = [rng.randn(*shape) * 0.3 for shape in
                 [(r, r, c), (r, c), (r, c)] + [(r, r, c)] * 4]
        for dtype, (rtol, atol) in ((torch.float32, (1e-3, 1e-4)),
                                    (torch.float64, (1e-9, 1e-10))):
            R_cm, O_cm, y_cm, _ = pt._chunk_layout(
                *(torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in system), s)
            with torch.no_grad():
                stacks = sweep_cuda.forward_sweep_solveinv_plain(
                    R_cm.contiguous(), O_cm.contiguous(), y_cm.contiguous(),
                    1e-3)[8:12]
            args = [t.contiguous() for t in stacks] + [
                torch.as_tensor(a, dtype=dtype, device=dev) for a in extra]
            check_kernel(
                "backward_solve_takahashi", "", "", k7,
                sweep_cuda.backward_solve_takahashi_plain, args, rtol, atol,
                f"edge: rank {r}, s = {s}, C = {c}, {dtype}; atol {atol:g} "
                "of each output's scale", atol_of_scale=True, record=False,
                phase="walk", reps=1)
            with torch.no_grad():
                once = k7(*args)
                twice = k7(*args)
                torch.cuda.synchronize()
            if not all(bool(torch.equal(a, b)) for a, b in zip(once, twice)):
                fail(f"backward_solve_takahashi at rank {r}, s = {s}, C = "
                     f"{c}, {dtype}: two runs differ")
    if k7.launches_split - n_split != k7.launches - n0:
        fail("backward_solve_takahashi: a launch at ranks 1-8 did not take "
             "the split design")
    say(f"[walk] kernel 7 (split design) agrees with its twin at "
        f"{len(WALK_EDGES)} edge shapes, float32 and float64, and gives the "
        "same bits on a second run at each")


# kernels 9 and 11 at ranks 1-8 (32 chunk lanes a block, or fewer where
# shared memory is short; a chain warp and three warps that stage rows):
# kernel 9 walks s - 1 rows in tiles of 3 through a ring of 4 (s = 2 the
# seed row alone, 4 one tile, 15 the ring wrapping and a ragged fifth
# tile), kernel 11 s - 2 rows in tiles of 3 through rings of 2 and 3 (s = 3
# one row, 5 one tile, 12 the rings wrapping and a ragged fourth tile); C =
# 1 a lone lane, 35 and 45 a ragged second block
POST_WALK_EDGES = {
    "backward_substitute": tuple((r, s, c) for r in (1, 5, 8)
                                 for s in (2, 4, 15) for c in (1, 35, 45)),
    "takahashi_backward": tuple((r, s, c) for r in (1, 5, 8)
                                for s in (3, 5, 12) for c in (1, 35, 45))}


def run_post_walk_edges(dev, check_kernel, sweep_cuda, pt):
    """Kernels 9 and 11 (split designs) against their twins at
    POST_WALK_EDGES, float32 and float64, on the stacks of kernel 8's or
    kernel 10's twin (pivot jitter 1e-3) for a block-tridiagonal system
    diagonally dominant at every block size (q q^T / d + 4 I, off-diagonal
    blocks randn / 2d, seeded), with the other inputs drawn from a numpy
    seed (scale 0.3); each gives the same bits on a second run, and every
    launch takes the split design."""
    import numpy as np

    t0 = time.perf_counter()
    for key, edges in POST_WALK_EDGES.items():
        kern = getattr(sweep_cuda, f"{key}_cuda")
        n0, n_split = kern.launches, kern.launches_split
        for r, s, c in edges:
            rng = np.random.RandomState(100 * r + 10 * s + c)
            system = dominant_system(rng, r, s * c)
            shapes = ([(r, r, c), (r, c), (r, c)] if key ==
                      "backward_substitute" else [(r, r, c)] * 9)
            extra = [rng.randn(*shape) * 0.3 for shape in shapes]
            for dtype, (rtol, atol) in ((torch.float32, (1e-3, 1e-4)),
                                        (torch.float64, (1e-9, 1e-10))):
                R_cm, O_cm, y_cm, _ = pt._chunk_layout(
                    *(torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in system), s)
                R_cm, O_cm, y_cm = (t.contiguous() for t in (R_cm, O_cm, y_cm))
                with torch.no_grad():
                    if key == "backward_substitute":
                        stacks = sweep_cuda.forward_sweep_collect_plain(
                            R_cm, O_cm, y_cm, 1e-3)[8:11]
                    else:
                        stacks = sweep_cuda.forward_sweep_inverse_plain(
                            R_cm, O_cm, 1e-3)[4:8]
                args = [t.contiguous() for t in stacks] + [
                    torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in extra]
                check_kernel(
                    key, "", "", kern,
                    getattr(sweep_cuda, f"{key}_plain"), args, rtol, atol,
                    f"edge: rank {r}, s = {s}, C = {c}, {dtype}; atol "
                    f"{atol:g} of each output's scale", atol_of_scale=True,
                    record=False, phase="post-walk", reps=1)
                with torch.no_grad():
                    once, twice = kern(*args), kern(*args)
                    torch.cuda.synchronize()
                if isinstance(once, torch.Tensor):
                    once, twice = (once,), (twice,)
                if not all(bool(torch.equal(a, b))
                           for a, b in zip(once, twice)):
                    fail(f"{key} at rank {r}, s = {s}, C = {c}, {dtype}: "
                         "two runs differ")
        if kern.launches_split - n_split != kern.launches - n0:
            fail(f"{key}: a launch at ranks 1-8 did not take the split "
                 "design")
        say(f"[post-walk] {key} (split design) agrees with its twin at "
            f"{len(edges)} edge shapes, float32 and float64, and gives the "
            "same bits on a second run at each")
    say(f"[post-walk] phase took {time.perf_counter() - t0:.1f} s")


# the four elimination sweeps at ranks 1-8 -- kernels 1, 6, 8 and 10, by
# the stem of their wrappers -- on pipeline.cuh's split sweep (lane groups
# of 32 chunk lanes, or fewer where shared memory is short, two a block
# where they fit; a chain warp and three output warps a group, tiles of 3
# rows, a ring of 3 input tiles, or 2 where shared memory is short), or
# one thread per lane where sweep_cuda.THREAD_F64 says so: s = 2 one row
# (row 1's seeding from O_0 alone), 4 one tile, 15 five tiles (the ring
# wrapping), 128 the main path's chunk length; C = 1 a lone lane, 35 and
# 45 a ragged second block, 70 three blocks
ELIM_KERNELS = {1: "forward_sweep", 6: "forward_sweep_solveinv",
                8: "forward_sweep_collect", 10: "forward_sweep_inverse"}
ELIM_EDGES = tuple((r, s, c) for r in (1, 5, 8)
                   for s, c in ((2, 35), (4, 45), (15, 35), (2, 1), (4, 1),
                                (15, 45), (128, 70)))
# [elim-pick]: both designs at float64 ranks 7 and 8; a pick slower than
# the other design by at most PICK_TIE of its time is a tie
N_PICK = (100_000, 400_000, 1_000_000, 2_000_000)
PICK_TIE = 0.05


def elim_args(key, ins):
    """An elimination sweep's inputs: kernel 10 has no right-hand side."""
    return ins[:2] if key == "forward_sweep_inverse" else ins


def elim_counts(sweep_cuda):
    """{stem: (launches at ranks 1-8, on the split design, on the
    thread-per-lane one)} of the four elimination sweeps."""
    out = {}
    for key in ELIM_KERNELS.values():
        w = getattr(sweep_cuda, f"{key}_cuda")
        out[key] = (w.launches - getattr(w, "launches_warp", 0),
                    w.launches_split, w.launches_thread)
    return out


def check_elim_designs(phase, what, sweep_cuda, before):
    """Every launch of the four elimination sweeps at ranks 1-8 since the
    counts ``before`` (elim_counts) took the split design: the phases
    that call this run float32, where sweep_cuda.THREAD_F64 names no
    thread-per-lane instance."""
    now, parts = elim_counts(sweep_cuda), []
    for num, key in ELIM_KERNELS.items():
        n, n_split, n_thread = (a - b for a, b in zip(now[key], before[key]))
        parts.append(f"{num} {n}")
        if n_split != n or n_thread != 0:
            fail(f"{what}: a launch of {key} at ranks 1-8 did not take the "
                 "split design the table names at float32")
    say(f"[{phase}] {what}: launches of the elimination sweeps 1, 6, 8, 10 "
        "at ranks 1-8, each on the split design (float32): "
        + ", ".join(parts))


# the device kernels of the four elimination sweeps, either design
ELIM_PROFILE = {
    1: r"\b(forward_sweep_kernel|sweep_split_kernel)<",
    6: r"\b(forward_sweep_solveinv_kernel|solveinv_split_kernel)<",
    8: r"\b(forward_sweep_collect_kernel|collect_split_kernel)<",
    10: r"\b(forward_sweep_inverse_kernel|inverse_split_kernel)<"}


def elim_profile(phase, by_kernel):
    """One line: each elimination sweep's summed device time and launches
    in a profile ({device op name: (ms, calls)}), whatever its rank."""
    parts = []
    for num, pattern in ELIM_PROFILE.items():
        hits = [v for k, v in by_kernel.items() if re.search(pattern, k)]
        parts.append(f"{num} {sum(v[0] for v in hits):.3f} ms / "
                     f"{sum(v[1] for v in hits)} launches")
    say(f"[{phase}]   elimination sweeps (summed over their instances): "
        + ", ".join(parts))


def sweeps_main(root, label):
    """``--sweeps``: the four elimination sweeps' device time on the LEG
    main path (rank 5, N = 1e6 irregular gaps, float32), with the port
    imported from ``root`` (an unpacked ``git archive`` of another commit,
    which builds its own library) or from this checkout, so that two
    commits can be timed on one card in turns (parent, change, change,
    parent).  Prints the CUDA-event median (REPS runs) of each sweep's
    wrapper on the inputs the main path hands it (1 from a two-kernel
    likelihood call, 6 from its gradient, 8 and 10 from one
    insample_posterior call), then one Adam step and one
    insample_posterior call under torch.profiler, after warm-up: their
    device time and each sweep's summed device time and launches
    (elim_profile, either design's kernel names)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, root or os.path.dirname(os.path.abspath(__file__)))
    from cyclic_gps_tpu_torch.data.synthetic import generate_data
    from cyclic_gps_tpu_torch.models import leg
    from cyclic_gps_tpu_torch.ops import _build, sweep_cuda
    from cyclic_gps_tpu_torch.train import loop

    tag = f"sweeps{' ' + label if label else ''}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(f"[{tag}] {smi.stdout.strip()}; package {sweep_cuda.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    so, secs = _build.build()
    say(f"[{tag}] library {so.name}: "
        + ("cached" if secs is None else f"built in {secs:.1f} s"))
    dev = torch.device("cuda", 0)
    params = leg.init_params(RANK, OBS, generator=torch.Generator()
                             .manual_seed(0), dtype=torch.float32,
                             device=dev)
    ts, xs = generate_data(N_BIG, OBS, dtype=torch.float64, seed=0,
                           device=dev)
    xs = xs.float()

    captured, origs = {}, {}

    def spy_on(key, orig):
        # wraps copies the launch counters, which the wrapper updates by
        # its module-level name: the spy's
        @functools.wraps(orig)
        def spy(*args, **kw):
            if (key not in captured
                    or args[0].numel() > captured[key][0][0].numel()):
                captured[key] = (args, kw)
            return orig(*args, **kw)

        return spy

    for key in ELIM_KERNELS.values():
        origs[key] = getattr(sweep_cuda, f"{key}_cuda")
        setattr(sweep_cuda, f"{key}_cuda", spy_on(key, origs[key]))
    try:
        torch.autograd.grad(leg.log_likelihood(params, ts, xs, fused=False),
                            list(params.parameters()))
        with torch.no_grad():
            leg.insample_posterior(params, ts, xs, method="precision")
        torch.cuda.synchronize()
    finally:
        for key, orig in origs.items():
            setattr(sweep_cuda, f"{key}_cuda", orig)
    with torch.no_grad():
        for num, key in ELIM_KERNELS.items():
            args, kw = captured.pop(key)
            ms = cuda_ms(lambda: origs[key](*args, **kw))
            say(f"[{tag}] kernel {num} ({key}_cuda) on the main path's "
                f"inputs (s {args[0].shape[0]}, C {args[0].shape[-1]}): "
                f"{ms:.4f} ms (CUDA-event median of {REPS})")

    p_train = leg.init_params(RANK, OBS, generator=torch.Generator()
                              .manual_seed(0), device=dev)
    opt = loop.make_optimizer("adam", 1e-2)
    for _ in range(2):
        loop.train_step(p_train, opt, ts, xs)
    with torch.no_grad():
        leg.insample_posterior(params, ts, xs, method="precision")
    for what, fn, grad in (
            ("Adam step", lambda: loop.train_step(p_train, opt, ts, xs),
             True),
            ("insample_posterior call", lambda: leg.insample_posterior(
                params, ts, xs, method="precision"), False)):
        with torch.set_grad_enabled(grad):
            wall, by_kernel = profiled(fn)
        if not by_kernel:
            say(f"[{tag}] profiled {what}: the profiler saw no device "
                "events; not measured")
            continue
        say(f"[{tag}] profiled {what}: device "
            f"{sum(ms for ms, _ in by_kernel.values()):.3f} ms in "
            f"{sum(n for _, n in by_kernel.values())} ops (wall {wall:.1f} "
            "ms, profiler on)")
        elim_profile(f"{tag} {what}", by_kernel)


def run_elim_edges(dev, sweep_cuda, pt):
    """The four elimination sweeps (kernels 1, 6, 8, 10) against their
    twins at ELIM_EDGES, float32 and float64, every output (the last
    state, mh, ld, ld_rows; 6 and 8 their hat stacks, 6 pinv; 10 its four
    raw-factor stacks), on a block-tridiagonal system diagonally dominant
    at every block size (q q^T / d + 4 I, off-diagonal blocks randn / 2d,
    seeded), pivot jitter 1e-3: each within 1e-3 (float32) or 1e-9
    (float64) relative plus 1e-4 or 1e-10 of each output's scale, the
    same bits on a second run, and every launch on the design the table
    names.  One line a kernel (the worst err/tol of its shapes)."""
    import numpy as np

    t0 = time.perf_counter()
    for num, key in ELIM_KERNELS.items():
        kern = getattr(sweep_cuda, f"{key}_cuda")
        twin = getattr(sweep_cuda, f"{key}_plain")
        n0, n_split, n_thread = elim_counts(sweep_cuda)[key]
        worst, want = 0.0, {"split": 0, "thread": 0}
        for r, s, c in ELIM_EDGES:
            system = dominant_system(
                np.random.RandomState(100 * r + 10 * s + c), r, s * c)
            for dtype, (rtol, atol) in ((torch.float32, (1e-3, 1e-4)),
                                        (torch.float64, (1e-9, 1e-10))):
                ins = elim_args(key, [t.contiguous() for t in pt._chunk_layout(
                    *(torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in system), s)[:3]])
                want[sweep_cuda._elim_design(key, dtype, r, c)] += 2
                with torch.no_grad():
                    got = kern(*ins, 1e-3)
                    again = kern(*ins, 1e-3)
                    ref = twin(*ins, 1e-3)
                    torch.cuda.synchronize()
                label = f"{key} at rank {r}, s = {s}, C = {c}, {dtype}"
                if not all(bool(torch.equal(a, b))
                           for a, b in zip(got, again)):
                    fail(f"{label}: two runs differ")
                worst = max(worst, elim_agree(label, got, ref, rtol, atol))
        n_all, n_s, n_t = (a - b for a, b in zip(
            elim_counts(sweep_cuda)[key], (n0, n_split, n_thread)))
        if (n_s, n_t) != (want["split"], want["thread"]) or n_s + n_t != n_all:
            fail(f"{key}: {n_s} split and {n_t} thread-per-lane launches of "
                 f"{n_all}, not the table's {want}")
        say(f"[elim-edges] kernel {num} ({key}) agrees with its twin at "
            f"{len(ELIM_EDGES)} edge shapes, float32 and float64 (worst "
            f"err/tol {worst:.3e}), gives the same bits on a second run at "
            f"each; {n_all} launches, each on the table's design (split "
            f"{n_s}, thread-per-lane {n_t})")
    say(f"[elim-edges] phase took {time.perf_counter() - t0:.1f} s")


def elim_agree(label, got, ref, rtol, atol):
    """Fail unless every output agrees with the twin's within rtol plus
    atol of its scale; returns the worst err/tol."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.double(), b.double()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"{label} output {i}: shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)}, or non-finite")
        tol = atol * float(b.abs().max()) + rtol * b.abs()
        diff = (a - b).abs()
        ratio = float(torch.where(diff == 0, 0.0, diff / tol).max())
        worst = max(worst, ratio)
        if ratio > 1.0:
            fail(f"{label} output {i} disagrees with its twin: err/tol "
                 f"{ratio:.3e}")
    return worst


def run_elim_pick(dev, sweep_cuda, pt, _build):
    """Both designs of the four elimination sweeps -- the split sweep and
    one thread per chunk lane -- at the float64 ranks that have both
    (_build.THREAD_RANKS), at N_PICK on the default chunk length (C from
    782 to 15,625: one to eight waves of the split design at rank 7, on
    both sides of each bound of the table): each against the twin (1e-9
    relative plus 1e-10 of each output's scale), then CUDA-event medians
    of 5 runs in turns (split, thread, thread, split); fails if the table
    (sweep_cuda.THREAD_F64) picks the slower by more than PICK_TIE: within
    it the two are a tie (near a bound of the table, where the turns of
    one call differ by up to ~2.5 %).  These launches go through
    sweep_cuda._elim_launch and count on no counter."""
    import numpy as np

    for n in N_PICK:
        s = pt.default_chunk_len(n)
        for r in _build.THREAD_RANKS:
            system = dominant_system(np.random.RandomState(r), r, n)
            ins = [t.contiguous() for t in pt._chunk_layout(
                *(torch.as_tensor(a, dtype=torch.float64, device=dev)
                  for a in system), s)[:3]]
            del system
            c = ins[0].shape[-1]
            for num, key in ELIM_KERNELS.items():
                y = None if key == ELIM_KERNELS[10] else ins[2]
                symbol = {"split": f"cgt_{key}",
                          "thread": f"cgt_{key}_thread"}

                def run(design):
                    return sweep_cuda._elim_launch(key, symbol[design],
                                                   ins[0], ins[1], y, 1e-3)

                with torch.no_grad():
                    ref = getattr(sweep_cuda, f"{key}_plain")(
                        *elim_args(key, ins), 1e-3)
                    for design in symbol:
                        elim_agree(f"{key} at float64 rank {r}, N {n}, "
                                   f"{design}", run(design), ref, 1e-9, 1e-10)
                    del ref
                    ms = {"split": [], "thread": []}
                    for design in ("split", "thread", "thread", "split"):
                        ms[design].append(cuda_ms(lambda: run(design), 5))
                mean = {k: sum(v) / len(v) for k, v in ms.items()}
                pick = sweep_cuda._elim_design(key, torch.float64, r, c)
                other = "thread" if pick == "split" else "split"
                ratio = mean[pick] / mean[other]
                say(f"[elim-pick] kernel {num} ({key}) float64 rank {r}, N "
                    f"{n}, s {s}, C {c}: split {ms['split'][0]:.3f} / "
                    f"{ms['split'][1]:.3f} ms, thread-per-lane "
                    f"{ms['thread'][0]:.3f} / {ms['thread'][1]:.3f} ms "
                    f"(turns; CUDA-event medians of 5); the table picks "
                    f"{pick}, {ratio:.3f} of the other's time"
                    + (" (a tie)" if 1 < ratio <= 1 + PICK_TIE else ""))
                if ratio > 1 + PICK_TIE:
                    fail(f"{key} at float64 rank {r}, C {c}: the table picks "
                         f"the {pick} design, slower than the {other} one")
            del ins
            torch.cuda.empty_cache()


def profile_summary(phase, what, fn, wall_med, top=6, part=None):
    """One profiled call of fn (device activity only): its device ms, op
    count and busy share against the profiled wall and the unprofiled
    median ``wall_med``, the summed ms of the ops whose names hold
    ``part``, and its ``top`` largest device ops; returns the device ms
    (None where the profiler saw no device events)."""
    wall, by_kernel = profiled(fn, cpu=False)
    if not by_kernel:
        say(f"[{phase}] profiled {what}: the profiler saw no device events; "
            "device ms, ops and busy share not measured")
        return None
    dev_ms = sum(ms for ms, _ in by_kernel.values())
    n_ops = sum(c for _, c in by_kernel.values())
    of_part = "" if part is None else "; {} {:.3f} ms of it".format(
        part, sum(ms for k, (ms, _) in by_kernel.items() if part in k))
    say(f"[{phase}] profiled {what}: wall {wall:.2f} ms (profiler on, "
        f"device activity only), {n_ops} device ops, device {dev_ms:.2f} "
        f"ms, busy share {dev_ms / wall:.3f}, against the unprofiled "
        f"median {wall_med:.2f} ms {dev_ms / wall_med:.3f}{of_part}")
    for key, (ms, c) in sorted(by_kernel.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        say(f"[{phase}]   {key[:80]}: {ms:.3f} ms, {c} calls")
    return dev_ms


def value_and_grads_agree(phase, what, fn, params, grad_bar, rtol=1e-4):
    """fn(backend) -> a scalar: its value and parameter gradient with
    backend="auto" against "torch" (value within ``rtol`` relative,
    gradient leaves within ``grad_bar`` of their inf-norm), one host-clock
    call each; fails on a mismatch or a non-finite value."""
    leaves = ("n_params", "r_params", "lambda_params", "b")

    def value_and_grads(backend):
        v = fn(backend)
        return v.detach(), torch.autograd.grad(v, list(params.parameters()))

    ms_a, (v_a, g_a) = host_ms(lambda: value_and_grads("auto"), reps=1)
    ms_t, (v_t, g_t) = host_ms(lambda: value_and_grads("torch"), reps=1)
    rel = abs(float(v_a) - float(v_t)) / abs(float(v_t))
    g_rels = [rel_inf(a, b) for a, b in zip(g_a, g_t)]
    ok = (bool(torch.isfinite(v_a)) and rel <= rtol
          and max(g_rels) <= grad_bar
          and all(bool(torch.isfinite(a).all()) for a in g_a))
    say(f"[{phase}] {what}: value + gradient auto {float(v_a):.6f} "
        f"({ms_a:.1f} ms), torch {float(v_t):.6f} ({ms_t:.1f} ms), rel diff "
        f"{rel:.3e} <= {rtol:g}; gradient per-leaf rel diff "
        + ", ".join(f"{k} {v:.2e}" for k, v in zip(leaves, g_rels))
        + f" <= {grad_bar:g} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{what}: backend='auto' disagrees with 'torch'")
    return v_a, g_a


def fit_steps(phase, what, loop, p, ts, xs, expm_cuda, m):
    """TRAIN_STEPS steps of fit(loss=None), kernel 2's launches (every
    one at M = ``m``) and the steps' host-clock ms; returns the median of
    the steps after the first."""
    tn0 = tn_watch(expm_cuda)
    stamps = []

    def stamp(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(p, ts, xs, num_steps=TRAIN_STEPS, log_every=0,
                   callback=stamp)
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    med = statistics.median(step_ms[1:])
    say(f"[{phase}] fit(loss=None, num_steps={TRAIN_STEPS}) {what}: losses "
        f"{res.losses}, step ms {[round(t, 2) for t in step_ms]}, median of "
        f"the steps after the first {med:.2f} ms (host clock, synchronised)")
    if not all(math.isfinite(v) for v in res.losses):
        fail(f"non-finite training loss on {what}: {res.losses}")
    check_tn_path(phase, f"fit(loss=None) {what}", expm_cuda, tn0, m)
    return med


def run_residual_phase(dev, leg, loop, sweep_cuda, expm_cuda, ts, xs,
                       grad_bar):
    """The float32 training default on a large irregular grid: fit(loss=
    None) picks "cr_residual" (leg.log_likelihood_residual); its value and
    gradient with backend="auto" against "torch", then two steps of fit
    with the launch counts of the kernels it runs."""
    chosen = loop._default_loss(ts, xs)
    if chosen != "cr_residual":
        fail(f"fit(loss=None) at float32, N {N_BIG} irregular picks "
             f"{chosen!r}, not 'cr_residual'")
    p = leg.init_params(RANK, OBS, generator=torch.Generator().manual_seed(3),
                        dtype=torch.float32, device=dev)
    value_and_grads_agree(
        "train", f"log_likelihood_residual N {N_BIG} irregular float32 "
        "(float64 timestamps)",
        lambda b: leg.log_likelihood_residual(p, ts, xs, backend=b), p,
        grad_bar)

    wrappers = {
        "transition_and_noise": expm_cuda.transition_and_noise_cuda,
        "k_system": expm_cuda.k_system_cuda,
        "k_system_adjoint": expm_cuda.k_system_adjoint_cuda,
        "forward_sweep_collect": sweep_cuda.forward_sweep_collect_cuda,
        "backward_substitute": sweep_cuda.backward_substitute_cuda,
        "forward_sweep_solveinv": sweep_cuda.forward_sweep_solveinv_cuda,
        "backward_solve_takahashi": sweep_cuda.backward_solve_takahashi_cuda}
    for w in wrappers.values():
        w.launches = 0
    tn0 = tn_watch(expm_cuda)
    split = ("backward_substitute", "forward_sweep_collect",
             "forward_sweep_solveinv")
    for k in split:
        wrappers[k].launches_split = 0
    elim0 = elim_counts(sweep_cuda)
    stamps = []

    def stamp(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(p, ts, xs, num_steps=2, log_every=0, callback=stamp)
    counts = {k: w.launches for k, w in wrappers.items()}
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    say(f"[train] fit(loss=None, num_steps=2) at float32, N {N_BIG} "
        f"irregular: loss 'cr_residual', losses {res.losses}, step ms "
        f"{[round(t, 2) for t in step_ms]} (host clock, synchronised; the "
        f"first step includes warm-up); launches {counts}")
    if not all(math.isfinite(v) for v in res.losses):
        fail(f"non-finite residual training loss: {res.losses}")
    for k, n in counts.items():
        if n <= 0:
            fail(f"kernel {k} was not launched by the residual train step")
    n_split = {k: wrappers[k].launches_split for k in split}
    say(f"[train] residual steps: split launches of kernels 9, 8 and 6 "
        f"{n_split} (of {[counts[k] for k in split]})")
    for k in split:
        if n_split[k] != counts[k]:
            fail(f"{k}: a launch in the residual train steps did not take "
                 "the split design")
    check_tn_path("train", "residual steps (gap slabs of at most "
                  f"{leg._ADJ_SLAB})", expm_cuda, tn0)
    check_elim_designs("train", "residual steps", sweep_cuda, elim0)


# ---------------------------------------------------------------------------
# Kernel 2 at the sizes the paths launch it at: its two designs.
# ---------------------------------------------------------------------------

TN_PROFILE_LAUNCHES = 20  # launches per size under the profiler
TN_KERNELS = {"rows": "transition_and_noise_rows_kernel",
              "thread": "transition_and_noise_thread_kernel"}


def tn_counts(expm_cuda):
    """Kernel 2's counters: (launches, launches_rows, launches_thread)."""
    k2 = expm_cuda.transition_and_noise_cuda
    return k2.launches, k2.launches_rows, k2.launches_thread


def tn_watch(expm_cuda):
    """Start recording the gap count M of every kernel-2 launch (the
    wrapper asks expm_cuda._tn_design once a launch); returns the watch
    that check_tn_path reads and ends."""
    sizes, pick = [], expm_cuda._tn_design

    def spy(m):
        sizes.append(m)
        return pick(m)

    expm_cuda._tn_design = spy
    return sizes, pick, tn_counts(expm_cuda)


def check_tn_path(phase, what, expm_cuda, watch, m=None):
    """End ``watch`` (tn_watch) and check kernel 2's launches in ``what``:
    fails where there were none, where the counters do not split them by
    the design the table picks at each launch's M, or (``m`` given) where
    a launch's M is not the path's ``m``."""
    sizes, pick, before = watch
    expm_cuda._tn_design = pick
    n, w, t = (a - b for a, b in zip(tn_counts(expm_cuda), before))
    by_m = {}
    for x in sizes:
        by_m[x] = by_m.get(x, 0) + 1
    say(f"[{phase}] {what}: kernel 2 launches {n} (rows design {w}, thread "
        f"design {t}); launches by M {dict(sorted(by_m.items()))}")
    if n <= 0 or n != len(sizes):
        fail(f"{what}: kernel 2 was not launched, or not through its "
             "table")
    if w != sum(pick(x) == "rows" for x in sizes) or w + t != n:
        fail(f"{what}: kernel 2's counters do not match its table")
    if m is not None and set(by_m) != {m}:
        fail(f"{what}: kernel 2 launched at M = {sorted(by_m)}, not {m}")


def tn_device_us(fn, name):
    """Device microseconds per launch of the kernel ``name`` (a part of its
    mangled name) over TN_PROFILE_LAUNCHES calls of fn, from torch.profiler;
    None where the profiler saw no device events."""
    def launches():
        for _ in range(TN_PROFILE_LAUNCHES):
            fn()

    _, by_name = profiled(launches)
    hits = [(ms, n) for k, (ms, n) in by_name.items() if name in k]
    if not hits:
        return None
    return 1e3 * sum(ms for ms, _ in hits) / sum(n for _, n in hits)


def run_tn_sizes(phase, expm_cuda, g, cases):
    """Kernel 2 at each (label, gaps) of ``cases``: the wrapper (counting
    its launches) and both designs (expm_cuda._tn_launch, counting
    nothing) against the plain twin under the [kernels] row's bars (rtol
    1e-4, atol 1e-6: one float32 Pade-7); both designs timed in turns
    (rows, thread, thread, rows: CUDA-event medians around one launch,
    which at small M are the host's enqueue time) and by their device time
    a launch (profiler); the bound.  [tn-pick]: fails where the table
    (expm_cuda._tn_design) picks the design whose device time a launch
    (the events' where the profiler saw none) is the longer by more than
    PICK_TIE."""
    k2 = expm_cuda.transition_and_noise_cuda
    for label, dt in cases:
        m = dt.shape[0]
        with torch.no_grad():
            got = k2(g, dt)
            torch.cuda.synchronize()
            ref = expm_cuda.transition_and_noise_plain(g, dt)
            compare(f"transition_and_noise {label} vs twin", got, ref,
                    1e-4, 1e-6)
            for design in TN_KERNELS:
                compare(f"transition_and_noise {label}, {design} design vs "
                        "twin", expm_cuda._tn_launch(design, g, dt), ref,
                        1e-4, 1e-6)
            del ref
            ms = {d: [] for d in TN_KERNELS}
            for design in ("rows", "thread", "thread", "rows"):
                ms[design].append(cuda_ms(
                    lambda: expm_cuda._tn_launch(design, g, dt)))
            dev = {d: tn_device_us(
                lambda: expm_cuda._tn_launch(d, g, dt), name)
                for d, name in TN_KERNELS.items()}
        b_ms, b_by = bound("transition_and_noise", (g, dt), got, g, dt)
        pick = expm_cuda._tn_design(m)
        other = "thread" if pick == "rows" else "rows"
        if None in dev.values():
            t = {d: 1e3 * sum(v) / len(v) for d, v in ms.items()}
            by = "CUDA events"
        else:
            t, by = dev, "device time"
        ratio = t[pick] / t[other]
        fmt = (lambda v: "not measured" if v is None else f"{v:.2f} us")
        say(f"[{phase}] transition_and_noise at M = {m} ({label}): rows "
            f"design {ms['rows'][0]:.4f} / {ms['rows'][1]:.4f} ms, thread "
            f"design {ms['thread'][0]:.4f} / {ms['thread'][1]:.4f} ms (CUDA "
            "events around one launch, in turns); device time a launch rows "
            f"{fmt(dev['rows'])}, thread {fmt(dev['thread'])} (profiler, "
            f"{TN_PROFILE_LAUNCHES} launches); bound {1e3 * b_ms:.2f} us "
            f"({b_by}, {1e3 * b_ms / t[pick]:.1%} of the picked design's "
            f"{by})")
        say(f"[tn-pick] M = {m}: the table picks {pick}, {ratio:.3f} of the "
            f"{other} design's {by}"
            + (" (a tie)" if 1 < ratio <= 1 + PICK_TIE else ""))
        if ratio > 1 + PICK_TIE:
            fail(f"transition_and_noise at M = {m}: the table picks the "
                 f"{pick} design, slower than the {other} one")


def tn_main(root, label):
    """``--tn``: kernel 2 through its wrapper (whatever design the package
    at ``root``, an unpacked ``git archive`` of another commit, or this
    checkout, picks) at the sizes the paths launch it at on the LEG main
    path (rank 5, float32 seeded weights): M = 1,024 and 4,096 (the first
    of N = 1e6's chunk-crossing gaps: C at N = 2^17 and 2^19), M = C =
    7,813 (N = 1e6's chunk-crossing gaps), 65,536 (a residual slab), 2^17
    (the Kalman loss), 1e6 - 1 (every gap of N = 1e6) and intercast's 4P
    at P = 1e6 + 3; CUDA-event medians around one call, and device time a
    launch of any kernel named transition_and_noise (profiler), so that
    two commits are timed on one card in turns (parent, change, change,
    parent)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, root or os.path.dirname(os.path.abspath(__file__)))
    from cyclic_gps_tpu_torch.data.synthetic import generate_data
    from cyclic_gps_tpu_torch.models import leg
    from cyclic_gps_tpu_torch.ops import _build, expm_cuda

    tag = f"tn{' ' + label if label else ''}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(f"[{tag}] {smi.stdout.strip()}; package {expm_cuda.__file__}")
    so, secs = _build.build()
    say(f"[{tag}] library {so.name}: "
        + ("cached" if secs is None else f"built in {secs:.1f} s"))
    dev = torch.device("cuda", 0)
    params = leg.init_params(RANK, OBS, generator=torch.Generator()
                             .manual_seed(0), dtype=torch.float32,
                             device=dev)
    with torch.no_grad():
        g = leg.g_matrix(params).contiguous()
    ts, xs = generate_data(N_BIG, OBS, dtype=torch.float64, seed=0,
                           device=dev)
    xs = xs.float()
    gaps = (ts[1:] - ts[:-1]).float().contiguous()
    # the chunk-crossing gaps and intercast's, as the paths form them: one
    # likelihood value and one make_predictions call at P = 1e6 + 3 (the
    # [posterior] targets) with the wrapper watched
    seen = {}
    orig = expm_cuda.transition_and_noise_cuda

    @functools.wraps(orig)
    def spy(g_, dt_):
        seen[dt_.shape[0]] = dt_
        return orig(g_, dt_)

    mid = 0.5 * (ts[1:] + ts[:-1])
    edge = torch.tensor([3.0, 0.5], dtype=ts.dtype, device=dev)
    targets = torch.cat([ts[0] - edge, mid, ts[-1] + edge.flip(0)])
    # leg's _wrap_row calls the wrapper by the name leg imported
    expm_cuda.transition_and_noise_cuda = leg.transition_and_noise_cuda = spy
    try:
        with torch.no_grad():
            leg.log_likelihood(params, ts, xs)
            m_c = min(seen)
            leg.make_predictions(params, ts, xs, targets, method="precision")
            torch.cuda.synchronize()
    finally:
        expm_cuda.transition_and_noise_cuda = orig
        leg.transition_and_noise_cuda = orig
    cases = [("C at N = 2^17", seen[m_c][:1024].contiguous()),
             ("C at N = 2^19", seen[m_c][:4096].contiguous()),
             ("M = C, the chunk-crossing gaps", seen[m_c]),
             ("a residual slab", gaps[:65536].contiguous()),
             ("the Kalman loss's gaps", gaps[:N_KALMAN].contiguous()),
             ("every gap", gaps),
             ("intercast's 4P", seen[max(seen)])]
    del targets, mid
    with torch.no_grad():
        for what, dt in cases:
            k2 = expm_cuda.transition_and_noise_cuda
            k2(g, dt)
            ms = [cuda_ms(lambda: k2(g, dt)), cuda_ms(lambda: k2(g, dt))]
            us = tn_device_us(lambda: k2(g, dt), "transition_and_noise")
            say(f"[{tag}] kernel 2 at M = {dt.shape[0]} ({what}): "
                f"{ms[0]:.4f} / {ms[1]:.4f} ms (CUDA-event medians of "
                f"{REPS}); device time a launch "
                + ("not measured" if us is None else f"{us:.2f} us")
                + f" (profiler, {TN_PROFILE_LAUNCHES} launches)")


# ---------------------------------------------------------------------------
# The Kalman filter losses float32 fit(loss=None) picks.
# ---------------------------------------------------------------------------

N_KALMAN = 1 << 17  # the largest irregular grid JAX's float32 default trains
# with "kalman" (kalman.SMOOTHER_BLOCK; above it "cr_residual")
N_KALMAN_REG = 16_384  # 8 SS_T0: the largest uniform grid that takes
# "kalman_regular" without the steady-state check (one point more takes
# "kalman_ss", the steady-state filter)
N_KALMAN_BIG = 1_000_000  # the blocked filter, loss="kalman" by hand; the
# steady-state loss's largest grid here


def run_kalman_phase(dev, leg, loop, kalman, expm_cuda, grad_bar):
    """[kalman]: on the grids where JAX's float32 fit(loss=None) picks
    each Kalman loss (rank 5, obs 2, seeded weights, float64 timestamps),
    the pick, the value and gradient with backend="auto" against
    "torch", three steps of fit(loss=None) with kernel 2's launches
    (every one on the design the table picks), one profiled step; a uniform
    grid one point longer than the steady-state threshold, where JAX picks
    "kalman_ss" and it trains three steps; "kalman_ss" against
    "kalman_regular" on a uniform 2^17 grid; "kalman_ss" at N = 1e6
    (auto against torch, a timed and a profiled step); the blocked filter
    at N = 1e6, one value and gradient with its peak memory."""
    from cyclic_gps_tpu_torch.data.synthetic import generate_data

    t_phase = time.perf_counter()

    def params():
        return leg.init_params(RANK, OBS, generator=torch.Generator()
                               .manual_seed(4), dtype=torch.float32,
                               device=dev)

    def grid(n, spacing):
        ts, xs = generate_data(n, OBS, dtype=torch.float64, spacing=spacing,
                               seed=5, device=dev)
        return ts, xs.float()

    for spacing, n, want in (("irregular", N_KALMAN, "kalman"),
                             ("regular", N_KALMAN_REG, "kalman_regular")):
        ts, xs = grid(n, spacing)
        p = params()
        picked = loop._steady_state_loss(p, ts, xs,
                                         loop._default_loss(ts, xs))
        say(f"[kalman] {spacing} N {n} float32: fit(loss=None) picks "
            f"{picked!r}")
        if picked != want:
            fail(f"fit(loss=None) on the {spacing} N = {n} grid picks "
                 f"{picked!r}, not {want!r} as the JAX package does")
        fn = loop.LOSSES[picked]
        value_and_grads_agree("kalman", f"{picked} N {n}",
                              lambda b: fn(p, ts, xs, backend=b), p,
                              grad_bar)
        # the irregular grid's T gaps (its first twice); one gap on the
        # uniform grid
        med = fit_steps("kalman", f"{spacing} N {n}", loop, p, ts, xs,
                        expm_cuda, n if spacing == "irregular" else 1)
        opt = loop.make_optimizer("adam", 1e-2)
        profile_summary("kalman", f"{picked} step N {n}",
                        lambda: loop.train_step(p, opt, ts, xs, loss=picked),
                        med, top=8, part="transition_and_noise")
        del p, opt

    # one point past the steady-state threshold JAX picks "kalman_ss": it
    # trains (each step's and fit's check's one (A, Q) through kernel 2)
    t_ss = time.perf_counter()
    ts, xs = grid(N_KALMAN_REG + 1, "regular")
    p = params()
    picked = loop._steady_state_loss(p, ts, xs, loop._default_loss(ts, xs))
    say(f"[kalman] regular N {N_KALMAN_REG + 1} float32: fit(loss=None) "
        f"picks {picked!r}")
    if picked != "kalman_ss":
        fail("past the steady-state threshold fit(loss=None) must pick "
             "'kalman_ss', as the JAX package does")
    fit_steps("kalman", f"regular N {N_KALMAN_REG + 1} (kalman_ss)", loop, p,
              ts, xs, expm_cuda, 1)
    # the steady-state loss against the exact filter's on a uniform 2^17
    # grid: the same likelihood once the Riccati recursion has converged
    ts, xs = grid(N_KALMAN, "regular")
    p = params()
    out = {}
    for name in ("kalman_ss", "kalman_regular"):
        v = loop.LOSSES[name](p, ts, xs)
        out[name] = (v.detach(), torch.autograd.grad(
            v, list(p.parameters())))
    (v_s, g_s), (v_r, g_r) = out["kalman_ss"], out["kalman_regular"]
    rel = abs(float(v_s) - float(v_r)) / abs(float(v_r))
    g_rels = [rel_inf(a, b) for a, b in zip(g_s, g_r)]
    ok = rel <= 1e-4 and max(g_rels) <= 1e-3
    say(f"[kalman] kalman_ss vs kalman_regular, regular N {N_KALMAN} "
        f"float32: values {float(v_s):.6f} / {float(v_r):.6f}, rel diff "
        f"{rel:.3e} <= 1e-4; gradient per-leaf rel diff "
        + ", ".join(f"{v:.2e}" for v in g_rels) + " <= 1e-3 (float32: the "
        "constant-gain tail's convolution against the exact filter's "
        f"log-depth combine) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("kalman_ss disagrees with kalman_regular on a converged grid")
    del out, g_s, g_r
    # the steady-state loss at N = 1e6: kernel 2 against the plain emission
    ts, xs = grid(N_KALMAN_BIG, "regular")
    p = params()
    value_and_grads_agree(
        "kalman", f"kalman_ss regular N {N_KALMAN_BIG}",
        lambda b: loop.nll_loss_kalman_steady(p, ts, xs, backend=b), p,
        grad_bar)
    opt = loop.make_optimizer("adam", 1e-2)
    med, _ = host_ms(lambda: loop.train_step(p, opt, ts, xs,
                                             loss="kalman_ss"), reps=3)
    say(f"[kalman] kalman_ss step regular N {N_KALMAN_BIG}: median "
        f"{med:.2f} ms of 3 (host clock, synchronised, after a warm-up)")
    profile_summary("kalman", f"kalman_ss step N {N_KALMAN_BIG}",
                    lambda: loop.train_step(p, opt, ts, xs,
                                            loss="kalman_ss"), med)
    say(f"[kalman] the steady-state loss took "
        f"{time.perf_counter() - t_ss:.1f} s")
    del p, opt

    # the blocked filter: N = 1e6, loss="kalman" by hand
    ts, xs = grid(N_KALMAN_BIG, "irregular")
    p = params()
    tn0 = tn_watch(expm_cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v = loop.nll_loss_kalman(p, ts, xs)
    grads = torch.autograd.grad(v, list(p.parameters()))
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(v)) and all(
        bool(torch.isfinite(x).all()) for x in grads)
    say(f"[kalman] blocked filter N {N_KALMAN_BIG} irregular (loss='kalman',"
        f" {-(-N_KALMAN_BIG // kalman.SMOOTHER_BLOCK)} blocks of "
        f"{kalman.SMOOTHER_BLOCK}): value {float(v):.6f} and gradient in "
        f"{wall:.1f} ms (host clock, synchronised, first call), peak "
        f"device memory {peak:.2f} GiB; finite {finite}")
    if not finite:
        fail("the blocked filter gave a non-finite value or gradient")
    check_tn_path("kalman", f"the blocked filter N {N_KALMAN_BIG}", expm_cuda,
                  tn0, N_KALMAN_BIG)
    say(f"[kalman] phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# The smoother behind float32 method="auto" posteriors.
# ---------------------------------------------------------------------------

N_SMOOTH = 1 << 17  # the flat smoother's largest grid (kalman.SMOOTHER_BLOCK)
SMOOTH_F64_BAR = 1e-3  # the float32 smoother against the float64 precision
# route, of each output's scale: PERF.md section 2's float32 posterior bar


def one_call_ms(fn):
    """(host-clock ms, value) of one synchronised call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def run_smoother_phase(dev, leg, kalman, expm_cuda, params, post_bar):
    """[smoother]: float32 insample_posterior(method="auto"), which takes
    the parallel RTS smoother ((A, Q) of every gap by kernel 2, which
    launches once at M = N), at N = 2^17 (the flat scan) and N = 1e6 (the
    blocked one, 8 blocks), each against backend="torch" within the
    float32 posterior bar; at 2^17 also against the float64 precision
    route, the wall (median of 3) and one profiled call; then
    make_predictions(method="auto") at N = 1024, P = 4,096."""
    from cyclic_gps_tpu_torch.data.synthetic import generate_data

    t_phase = time.perf_counter()
    params64 = leg.LEGParams(*[t.detach().double() for t in
                               (params.n_params, params.r_params,
                                params.lambda_params, params.b)])
    for n in (N_SMOOTH, N_BIG):
        ts, xs = generate_data(n, OBS, dtype=torch.float64, seed=6,
                               device=dev)
        xs = xs.float()
        blocks = -(-n // kalman.SMOOTHER_BLOCK)
        what = (f"insample_posterior(method='auto') N {n} float32 ("
                + ("flat scan" if n <= kalman.SMOOTHER_BLOCK
                   else f"blocked, {blocks} blocks of "
                   f"{kalman.SMOOTHER_BLOCK}") + ")")
        tn0 = tn_watch(expm_cuda)
        with torch.no_grad():
            ms_first, got = one_call_ms(
                lambda: leg.insample_posterior(params, ts, xs))
        check_tn_path("smoother", what, expm_cuda, tn0, n)
        with torch.no_grad():
            if n == N_SMOOTH:
                ms_a, got = host_ms(
                    lambda: leg.insample_posterior(params, ts, xs), reps=3)
            else:
                ms_a = ms_first
            ms_t, ref = one_call_ms(lambda: leg.insample_posterior(
                params, ts, xs, backend="torch"))
        compare(f"smoother N {n} auto vs torch", got, ref, 0.0, post_bar,
                atol_of_scale=True)
        say(f"[smoother] {what}: auto {ms_a:.2f} ms ("
            + ("median of 3 after the first call, "
               if n == N_SMOOTH else "")
            + f"first call {ms_first:.2f} ms), torch {ms_t:.2f} ms (host "
            f"clock, synchronised); agree within {post_bar:g} of each "
            "output's scale (float32: Pade-7 kernel vs the Pade-13 plain "
            "emission, the same scans)")
        del ref
        if n == N_SMOOTH:
            with torch.no_grad():
                ref64 = leg.insample_posterior(params64, ts, xs.double(),
                                               method="precision")
            compare(f"smoother N {n} float32 vs the float64 precision route",
                    got, ref64, 0.0, SMOOTH_F64_BAR, atol_of_scale=True)
            say(f"[smoother] N {n}: the float32 smoother agrees with the "
                f"float64 precision route within {SMOOTH_F64_BAR:g} of "
                "each output's scale (PERF.md section 2's float32 "
                "posterior bar)")
            del ref64
            with torch.no_grad():
                profile_summary("smoother", what, lambda: leg.
                                insample_posterior(params, ts, xs), ms_a)
        del got
        torch.cuda.empty_cache()

    ts_d, xs_d = generate_data(1024, OBS, dtype=torch.float64, seed=3,
                               device=dev)
    targets_d = torch.sort(ts_d[0] - 1.0 + (ts_d[-1] - ts_d[0] + 2.0)
                           * torch.rand(4096, dtype=torch.float64,
                                        generator=torch.Generator()
                                        .manual_seed(4)).to(dev)).values
    with torch.no_grad():
        ms_a, got = host_ms(lambda: leg.make_predictions(
            params, ts_d, xs_d.float(), targets_d), reps=3)
        ms_t, ref = one_call_ms(lambda: leg.make_predictions(
            params, ts_d, xs_d.float(), targets_d, backend="torch"))
    compare("make_predictions(method='auto') N 1024, P 4096", got, ref, 0.0,
            post_bar, atol_of_scale=True)
    say(f"[smoother] make_predictions(method='auto') N 1024, P 4096 "
        f"float32: auto {ms_a:.2f} ms (median of 3), torch {ms_t:.2f} ms; "
        f"agree within {post_bar:g} of each output's scale")
    say(f"[smoother] phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# The stacked multi-series entries: kernels 1-11 under a series mask.
# ---------------------------------------------------------------------------

N_SERIES = 64
SERIES_LENS = (8192, 24576)  # seeded lengths: ~1e6 points in all
BATCH_LEN, BATCH_TARGETS = 16_384, 256  # the equal-length batch
STACK_KERNELS = {
    # key: (module of the wrapper, rtol, atol, of scale, why)
    "transition_and_noise": ("expm", 1e-4, 1e-6, False,
                             "the chunk-crossing gaps (_wrap_row, M = C)"),
    "k_system": ("expm", 1e-3, 1e-4, False,
                 "K ~ Q1^{-1} amplifies (e, Q1) rounding for small gaps"),
    "gap_mahal_sweep": ("expm", 1e-3, 1e-4, False,
                        "kernels 3 and 1 fused"),
    "k_system_adjoint": ("expm", 1e-3, 1e-4, True,
                         "c_dt against 4x the float32 twin's error"),
    "forward_sweep": ("sweep", 1e-3, 1e-4, False,
                      "127 dependent elimination steps"),
    "forward_sweep_solveinv": ("sweep", 1e-3, 1e-4, True,
                               "elimination and the hats"),
    "backward_solve_takahashi": ("sweep", 1e-3, 1e-4, True,
                                 "back-substitution and the walk"),
    "forward_sweep_collect": ("sweep", 1e-3, 1e-4, True,
                              "elimination and three back substitutions"),
    "backward_substitute": ("sweep", 1e-3, 1e-4, True,
                            "127 dependent multiply-add steps"),
    "forward_sweep_inverse": ("sweep", 1e-3, 1e-4, True,
                              "elimination, the raw factors"),
    "takahashi_backward": ("sweep", 1e-3, 1e-4, True,
                           "the Takahashi recursion in the hat form"),
}
LEG_WRAPPERS = ("transition_and_noise", "k_system", "gap_mahal_sweep",
                "k_system_adjoint")  # called through models/leg.py's names


def stack(leg, parts):
    """leg.stack_series of float64-timestamp series with float32 values."""
    return leg.stack_series([(t, x.float()) for t, x in parts])


def run_stacked_phase(dev, leg, loop, pt, expm_cuda, sweep_cuda, params,
                      rows, captured, capture, check_kernel, grad_bar,
                      post_bar, step_dev_ms):
    """[stacked]: 64 series of seeded lengths in 8,192-24,576 (~1e6 points,
    the first 12,800 long so that a boundary falls on a chunk's wrap row,
    the others inside chunks), float32, float64 timestamps restarting at
    every boundary.  Kernels 1-11 against their twins on the inputs the
    stacked likelihood, its gradient and insample_posterior_stacked hand
    them; the launch counts of one train_step_stacked ("cr") step and one
    insample_posterior_stacked call (counts set to 0 just before); the
    stacked value against 8 of its series run alone; the stacked
    likelihood's wall and the profiled step; log_likelihood_per_series,
    insample_posterior_stacked and make_predictions_batch on 64 x 16,384
    points with 256 targets each against backend="torch";
    nll_loss_kalman_stacked at 2^17 points in all."""
    from cyclic_gps_tpu_torch.data.synthetic import generate_data

    t_phase = time.perf_counter()
    lengths = torch.randint(SERIES_LENS[0], SERIES_LENS[1] + 1, (N_SERIES,),
                            generator=torch.Generator().manual_seed(8))
    lengths[0] = 100 * 128  # its last gap is row s - 1 of chunk 99
    parts = [generate_data(int(n), OBS, dtype=torch.float64, seed=100 + i,
                           device=dev) for i, n in enumerate(lengths)]
    ts, xs, ids = stack(leg, parts)
    n = ts.shape[0]
    s = pt.default_chunk_len(n)
    cuts = torch.cumsum(lengths, 0)[:-1] - 1  # the masked gaps
    on_wrap = int((cuts % s == s - 1).sum())
    say(f"[stacked] {N_SERIES} series, N {n} float32 (float64 timestamps), "
        f"rank {RANK}, s {s}, C {-(-n // s)}: {len(cuts)} masked boundary "
        f"gaps, {on_wrap} on a chunk's wrap row, {len(cuts) - on_wrap} "
        "inside chunks")

    # the kernels' inputs on the stacked paths (each one's largest call)
    modules = {"expm": expm_cuda, "sweep": sweep_cuda}
    captured.clear()
    spied = [(leg if k in LEG_WRAPPERS else modules[m], f"{k}_cuda")
             for k, (m, *_) in STACK_KERNELS.items()]
    origs = [(owner, attr, capture(owner, attr)) for owner, attr in spied]
    try:
        v = leg.log_likelihood_stacked(params, ts, xs, ids)
        torch.autograd.grad(v, list(params.parameters()))
        with torch.no_grad():
            leg.insample_posterior_stacked(params, ts, xs, ids)
        torch.cuda.synchronize()
    finally:
        for owner, attr, orig in origs:
            setattr(owner, attr, orig)
    missing = [a for _, a in spied if a not in captured]
    if missing:
        fail(f"the stacked paths did not reach {missing}")
    by_name = {r["name"]: r for r in rows}  # each kernel's source, TPU line
    for key, (m, rtol, atol, of_scale, why) in STACK_KERNELS.items():
        args_k, kw_k = captured[f"{key}_cuda"]
        module = modules[m]
        extra = {}
        if key == "transition_and_noise":
            extra["gaps_of"] = args_k[1]
        elif key in ("k_system", "gap_mahal_sweep"):
            extra["gaps_of"] = args_k[2]
        elif key == "k_system_adjoint":
            extra.update(gaps_of=args_k[1], f64_outputs=(2,))
        check_kernel(key, by_name[key]["source"], by_name[key]["replaces"],
                     getattr(module, f"{key}_cuda"),
                     getattr(module, f"{key}_plain"), args_k, rtol, atol,
                     f"under the series mask; {why}", kw=kw_k,
                     atol_of_scale=of_scale, record=False, phase="stacked",
                     reps=1, **extra)
    captured.clear()

    # the path: one train_step_stacked and one insample_posterior_stacked,
    # counts set to 0 just before and read just after
    wrappers = {k: getattr(modules[m], f"{k}_cuda")
                for k, (m, *_) in STACK_KERNELS.items()}
    p = leg.init_params(RANK, OBS, generator=torch.Generator()
                        .manual_seed(9), device=dev)
    opt = loop.make_optimizer("adam", 1e-2)
    for w in wrappers.values():
        w.launches = 0
    loss = loop.train_step_stacked(p, opt, ts, xs, ids)
    with torch.no_grad():
        leg.insample_posterior_stacked(p, ts, xs, ids)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    say(f"[stacked] launches in one train_step_stacked('cr') step (loss "
        f"{float(loss):.6f}) and one insample_posterior_stacked call: "
        f"{counts}")
    for k, c in counts.items():
        if c <= 0:
            fail(f"kernel {k} was not launched by the stacked paths")
    if not math.isfinite(float(loss)):
        fail("non-finite stacked training loss")

    # the stacked value against 8 of its series run alone
    ts8, xs8, ids8 = stack(leg, parts[:8])
    with torch.no_grad():
        v8 = float(leg.log_likelihood_stacked(p, ts8, xs8, ids8))
        own = sum(float(leg.log_likelihood(p, t, x.float()))
                  for t, x in parts[:8])
    rel = abs(v8 - own) / abs(own)
    say(f"[stacked] log_likelihood_stacked of the first 8 series "
        f"{v8:.6f} vs the sum of their own log_likelihood {own:.6f}: rel "
        f"diff {rel:.3e} <= 1e-4 {'ok' if rel <= 1e-4 else 'MISMATCH'}")
    if rel > 1e-4:
        fail("the stacked likelihood is not the sum of its series'")

    # walls and device time
    with torch.no_grad():
        ms_v, _ = host_ms(lambda: leg.log_likelihood_stacked(p, ts, xs, ids))
    ms_s, _ = host_ms(lambda: loop.train_step_stacked(p, opt, ts, xs, ids))
    say(f"[stacked] N {n}: log_likelihood_stacked {ms_v:.2f} ms, "
        f"train_step_stacked {ms_s:.2f} ms (medians of 3, host clock)")
    with torch.no_grad():
        profile_summary("stacked", f"log_likelihood_stacked N {n}",
                        lambda: leg.log_likelihood_stacked(p, ts, xs, ids),
                        ms_v)
    dev_ms = profile_summary("stacked", f"train_step_stacked N {n}",
                             lambda: loop.train_step_stacked(
                                 p, opt, ts, xs, ids), ms_s)
    if dev_ms is not None and step_dev_ms:
        say(f"[stacked] the stacked step's device time is "
            f"{dev_ms / step_dev_ms:.3f} of the single-series LEG step's "
            f"({step_dev_ms:.2f} ms, [train], N {N_BIG})")
    del parts, ts, xs, ids, ts8, xs8, ids8, opt
    torch.cuda.empty_cache()

    # the equal-length batch: per-series likelihoods, posterior, predictions
    parts = [generate_data(BATCH_LEN, OBS, dtype=torch.float64,
                           seed=300 + i, device=dev)
             for i in range(N_SERIES)]
    ts_b = torch.stack([t for t, _ in parts])
    xs_b = torch.stack([x for _, x in parts]).float()
    ts, xs, ids = stack(leg, parts)
    gen = torch.Generator().manual_seed(10)
    span = ts_b[:, -1:] - ts_b[:, :1]
    tg_b = torch.sort(ts_b[:, :1] - 1.0 + (span + 2.0) * torch.rand(
        N_SERIES, BATCH_TARGETS, dtype=torch.float64,
        generator=gen).to(dev), dim=1).values
    what = f"{N_SERIES} x {BATCH_LEN} points"
    with torch.no_grad():
        ms_a, ll_a = host_ms(lambda: leg.log_likelihood_per_series(
            p, ts, xs, ids, N_SERIES), reps=1)
        ms_t, ll_t = one_call_ms(lambda: leg.log_likelihood_per_series(
            p, ts, xs, ids, N_SERIES, backend="torch"))
        total = float(leg.log_likelihood_stacked(p, ts, xs, ids))
    rel = float(((ll_a - ll_t).abs() / ll_t.abs()).max())
    rel_sum = abs(float(ll_a.sum()) - total) / abs(total)
    ok = rel <= 1e-4 and rel_sum <= 1e-4 and bool(torch.isfinite(ll_a).all())
    say(f"[stacked] log_likelihood_per_series {what}: auto {ms_a:.2f} ms, "
        f"torch {ms_t:.2f} ms; per-series rel diff {rel:.3e} <= 1e-4, sum "
        f"vs log_likelihood_stacked {rel_sum:.3e} <= 1e-4 "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("log_likelihood_per_series disagrees")
    for label, call in (
            ("insample_posterior_stacked",
             lambda b: leg.insample_posterior_stacked(p, ts, xs, ids,
                                                      backend=b)),
            (f"make_predictions_batch ({BATCH_TARGETS} targets a series)",
             lambda b: leg.make_predictions_batch(p, ts_b, xs_b, tg_b,
                                                  backend=b))):
        with torch.no_grad():
            ms_a, got = host_ms(lambda: call("auto"), reps=1)
            ms_t, ref = one_call_ms(lambda: call("torch"))
        compare(f"{label} {what}", got, ref, 0.0, post_bar,
                atol_of_scale=True)
        say(f"[stacked] {label} {what}: auto {ms_a:.2f} ms, torch "
            f"{ms_t:.2f} ms (host clock); agree within {post_bar:g} of "
            "each output's scale")
        del got, ref

    # the Kalman twin of the stacked loss at 2^17 points in all
    k = (1 << 17) // BATCH_LEN
    ts_k, xs_k, ids_k = stack(leg, parts[:k])
    tn0 = tn_watch(expm_cuda)
    value_and_grads_agree(
        "stacked", f"nll_loss_kalman_stacked, {k} series, N "
        f"{ts_k.shape[0]}", lambda b: loop.nll_loss_kalman_stacked(
            p, ts_k, xs_k, ids_k, backend=b), p, grad_bar)
    check_tn_path("stacked", "nll_loss_kalman_stacked (auto, then torch)",
                  expm_cuda, tn0, ts_k.shape[0])
    say(f"[stacked] phase took {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    t_start = time.perf_counter()

    def clock(label):
        """The seconds since the start, before each phase: where the
        script's time limit goes."""
        say(f"[clock] {label} at {time.perf_counter() - t_start:.1f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cyclic_gps_tpu_torch.baselines import dense, kalman
    from cyclic_gps_tpu_torch.data.synthetic import generate_data
    from cyclic_gps_tpu_torch.entry import entry
    from cyclic_gps_tpu_torch.models import leg
    from cyclic_gps_tpu_torch.ops import _build, celerite_cuda, expm_cuda
    from cyclic_gps_tpu_torch.ops import partitioned as pt
    from cyclic_gps_tpu_torch.ops import sweep_cuda
    from cyclic_gps_tpu_torch.train import loop

    dev = torch.device("cuda", 0)

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"[device] {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, cards {torch.cuda.device_count()}")
    say(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build --------------------------------------------------------
    so, secs = _build.build()
    _build.load()
    say(f"[build] {so.name}: "
        + ("cached" if secs is None else f"built in {secs:.1f} s"))
    for fn_name, (regs, stack, spill) in sorted(
            _build.ptxas_report(RANK).items()):
        base = re.search(r"\d+([a-z_]+?)I([fd]?)Li\d+E", fn_name)
        if base is None or "celerite" in base.group(1):
            continue
        kind = " (float64)" if base.group(2) == "d" else ""
        say(f"[build] rank {RANK} {base.group(1)}{kind}: registers {regs}, "
            f"stack {stack} B, spill stores {spill} B")
    # the celerite kernels at nblocks 2 and 8 (rank 4 and 16; template
    # arguments nblocks, obs_dim, collect; 1, 6 and 7 take 16 one warp per
    # lane: below)
    for tag in (CEL_NB_SMALL, CEL_NB):
        for fn_name, (regs, stack, spill) in sorted(
                _build.ptxas_report(tag).items()):
            base = re.search(r"\d+([a-z_]+?)I(\w*?)EEv", fn_name)
            if base is None or regs is None:
                continue
            if ("celerite" not in base.group(1)
                    or not base.group(2).startswith(f"Li{tag}E")):
                continue
            say(f"[build] {base.group(1)}<{base.group(2)}>: registers "
                f"{regs}, stack {stack} B, spill stores {spill} B")
    # the wide kernels and the runtime-d solve and selected-inversion
    # kernels (one instance per dtype; d = 9..15 at run time), kernels 1,
    # 6 and 7 at block size 16 (one warp per lane, one instance per dtype)
    # and the warp instances of kernels 14 and 13 (nblocks 5-8, obs 1 and
    # 2; one body, so 14's lines stand next to 13's)
    for tag in ("wide_", "rt_", "solveinv_warp", "backsolve_warp",
                "forward_sweep_warp", "celerite_filter_collect_warp",
                "celerite_filter_warp"):
        for fn_name, (regs, stack, spill) in sorted(
                _build.ptxas_report(0, tag=tag).items()):
            base = re.search(rf"\d+({tag}[a-z_]+?)I(\w*?)EEv", fn_name)
            if base is None or regs is None:
                continue
            say(f"[build] {base.group(1)}<{base.group(2)}>: registers "
                f"{regs}, stack {stack} B, spill stores {spill} B")
            if (base.group(1) in WARP_KERNELS + WARP16_KERNELS
                    and (stack >= 1024 or spill > 0)):
                fail(f"{base.group(1)}<{base.group(2)}> runs from local "
                     f"memory (stack {stack} B, spill stores {spill} B)")
            if base.group(1) in WARP_NEW_KERNELS and (stack or spill):
                fail(f"{base.group(1)}<{base.group(2)}> uses local memory "
                     f"(stack {stack} B, spill stores {spill} B)")
    # the warp-per-lane kernels: dynamic shared memory per thread block
    lib = _build.load()
    for kname, query, of_d in (
            ("rt_takahashi_kernel", lib.cgt_rt_takahashi_smem_bytes,
             lambda d: d),
            ("wide_backward_kernel", lib.cgt_wide_backward_smem_bytes,
             lambda d: d - 8),
            ("rt_collect_kernel", lib.cgt_rt_collect_smem_bytes,
             lambda d: d),
            ("wide_solveinv_kernel", lib.cgt_wide_solveinv_smem_bytes,
             lambda d: d - 8),
            ("wide_sweep_kernel", lib.cgt_wide_sweep_smem_bytes,
             lambda d: d - 8),
            ("rt_sweep_kernel", lib.cgt_rt_sweep_smem_bytes, lambda d: d),
            ("rt_inverse_sweep_kernel", lib.cgt_rt_inverse_sweep_smem_bytes,
             lambda d: d),
            ("rt_backsub_warp_kernel", lib.cgt_rt_backsub_smem_bytes,
             lambda d: d)):
        say(f"[build] {kname}: one warp per chunk lane, 8 lanes (256 "
            "threads) per block at float32, 4 (128) at float64; dynamic "
            "shared bytes per block (float32 / float64) "
            + ", ".join(f"d {d}: {query(of_d(d), 0)} / {query(of_d(d), 1)}"
                        for d in WARP_DS))
    for kname, num, query in zip(
            ("forward_sweep_warp_kernel",) + WARP16_KERNELS, (1, 6, 7),
            (lib.cgt_forward_sweep_warp_smem_bytes,
             lib.cgt_solveinv_warp_smem_bytes,
             lib.cgt_backsolve_warp_smem_bytes)):
        say(f"[build] {kname} (kernel {num} at block size 16): one warp per "
            "chunk lane, 8 lanes per block at float32, 4 at float64; "
            "dynamic shared bytes per block (float32 / float64) d 16: "
            f"{query(16, 0)} / {query(16, 1)}")
    say("[build] celerite_filter_collect_warp_kernel (kernel 14, warp per "
        "lane at nblocks 5-8, 8 lanes per block, blocks in clusters of 4): "
        "dynamic shared bytes per block (obs 1 / obs 2) " + ", ".join(
            f"nblocks {nb}: {lib.cgt_celerite_collect_smem_bytes(nb, 1)} / "
            f"{lib.cgt_celerite_collect_smem_bytes(nb, 2)}"
            for nb in range(5, 9)))
    say("[build] celerite_filter_warp_kernel (kernel 13, the same body "
        "without the history or the cluster, one copy of F, P and a; from "
        f"nblocks {celerite_cuda.FILTER_WARP_NBLOCKS}): dynamic shared bytes "
        "per block (obs 1 / obs 2) " + ", ".join(
            f"nblocks {nb}: {lib.cgt_celerite_filter_smem_bytes(nb, 1)} / "
            f"{lib.cgt_celerite_filter_smem_bytes(nb, 2)}"
            for nb in range(5, 9)))
    # kernel 15: one warp per chunk lane at nblocks 5..8 (8 lanes per
    # block), one thread per lane at 1..4
    for fn_name, (regs, stack, spill) in sorted(_build.ptxas_report(
            0, tag="celerite_filter_adjoint").items()):
        base = re.search(r"\d+(celerite_filter_adjoint\w*?_kernel)I(\w*?)EEv",
                         fn_name)
        if base is None or regs is None:
            continue
        say(f"[build] {base.group(1)}<{base.group(2)}>: registers {regs}, "
            f"stack {stack} B, spill stores {spill} B")
    say("[build] celerite_filter_adjoint_kernel (warp per lane): dynamic "
        "shared bytes per block (obs 1 / obs 2) "
        + ", ".join(f"nblocks {nb}: {lib.cgt_celerite_adjoint_smem_bytes(nb, 1)}"
                    f" / {lib.cgt_celerite_adjoint_smem_bytes(nb, 2)}"
                    for nb in range(5, 9)))
    # kernel 12: one warp per chunk lane at nblocks 5..8 (one instance, the
    # nblocks a runtime argument; 8 lanes per block), one thread per lane
    # at 1..4
    warp12 = "celerite_gap_mahal_sweep_warp_kernel"
    rep12 = [v for k, v in _build.ptxas_report(0, tag=warp12).items()
             if v[0] is not None]
    if len(rep12) != 1:
        fail(f"{warp12}: no single entry in the compiler's report")
    regs, stack, spill = rep12[0]
    say(f"[build] {warp12} (nblocks 5-8): registers {regs}, stack {stack} "
        f"B, spill stores {spill} B; dynamic shared bytes per block "
        + ", ".join(f"nblocks {nb}: {lib.cgt_celerite_sweep_smem_bytes(nb)}"
                    for nb in range(5, 9)))
    if stack >= 1024 or spill > 0:
        fail(f"{warp12} runs from local memory (stack {stack} B, spill "
             f"stores {spill} B)")
    # kernel 2 at every rank, both designs; neither's rank-5 instance may
    # touch local memory
    for r in _build.RANKS:
        for label, kname in TN_KERNELS.items():
            rep = [v for k, v in _build.ptxas_report(r).items()
                   if f"{len(kname)}{kname}I" in k and v[0] is not None]
            if len(rep) != 1:
                fail(f"{kname}<{r}>: no single entry in the compiler's report")
            regs, stack, spill = rep[0]
            say(f"[build] {kname}<{r}> (kernel 2, {label} design): registers "
                f"{regs}, stack {stack} B, spill stores {spill} B")
            if r == RANK and (stack or spill):
                fail(f"{kname}<{r}> uses local memory (stack {stack} B, "
                     f"spill stores {spill} B)")
    # kernels 5 and 4 at every rank: one thread per gap, each block's 128
    # gaps sorted (5); 32 lanes a block in tiles of 3 rows (4); rank 5's
    # adjoint must not touch local memory
    for kname, num, query in (
            ("k_system_adjoint_kernel", 5,
             lib.cgt_k_system_adjoint_smem_bytes),
            ("gap_mahal_sweep_kernel", 4, lib.cgt_gap_mahal_sweep_smem_bytes)):
        for r in _build.RANKS:
            # the mangled name: its length, then the name (so celerite's
            # celerite_gap_mahal_sweep_kernel does not match)
            rep = [v for k, v in _build.ptxas_report(r).items()
                   if f"{len(kname)}{kname}I" in k and v[0] is not None]
            if len(rep) != 1:
                fail(f"{kname}<{r}>: no single entry in the compiler's report")
            regs, stack, spill = rep[0]
            say(f"[build] {kname}<{r}> (kernel {num}): registers {regs}, "
                f"stack {stack} B, spill stores {spill} B, dynamic shared "
                f"bytes per block {query(r)}")
            if num == 5 and r == RANK and (stack or spill):
                fail(f"{kname}<{r}> uses local memory (stack {stack} B, "
                     f"spill stores {spill} B)")
    # kernel 3 (one thread per gap, 32 lanes by 7 rows and a halo row a
    # block) at every rank, and kernel 7's split design (a chain warp and
    # three output warps on 32, 16 or 8 lanes) at every rank and dtype; the
    # split design's float32 rank-5 instance must not touch local memory
    for r in _build.RANKS:
        kname = "k_system_tiled_kernel"
        rep = [v for k, v in _build.ptxas_report(r).items()
               if f"{len(kname)}{kname}I" in k and v[0] is not None]
        if len(rep) != 1:
            fail(f"{kname}<{r}>: no single entry in the compiler's report")
        regs, stack, spill = rep[0]
        say(f"[build] {kname}<{r}> (kernel 3): registers {regs}, stack "
            f"{stack} B, spill stores {spill} B, dynamic shared bytes per "
            f"block {lib.cgt_k_system_smem_bytes(r)}")
    for r in _build.RANKS:
        kname = "backsolve_split_kernel"
        for code, f64 in (("f", 0), ("d", 1)):
            rep = [v for k, v in _build.ptxas_report(r).items()
                   if f"{kname}I{code}Li{r}E" in k and v[0] is not None]
            if len(rep) != 1:
                fail(f"{kname}<{code}, {r}>: no single entry in the "
                     "compiler's report")
            regs, stack, spill = rep[0]
            say(f"[build] {kname}<{'double' if f64 else 'float'}, {r}> "
                f"(kernel 7): registers {regs}, stack {stack} B, spill "
                f"stores {spill} B, dynamic shared bytes per block "
                f"{lib.cgt_backsolve_split_smem_bytes(r, f64)}")
            if r == RANK and not f64 and (stack or spill):
                fail(f"{kname}<float, {r}> uses local memory (stack {stack} "
                     f"B, spill stores {spill} B)")
    # kernels 9 and 11's split designs (a chain warp and three warps that
    # stage rows, on 32 lanes or fewer) at every rank and dtype
    for kname, num, query in (
            ("backsub_split_kernel", 9, lib.cgt_backsub_split_smem_bytes),
            ("takahashi_split_kernel", 11,
             lib.cgt_takahashi_split_smem_bytes)):
        for r in _build.RANKS:
            for code, f64 in (("f", 0), ("d", 1)):
                rep = [v for k, v in _build.ptxas_report(r).items()
                       if f"{kname}I{code}Li{r}E" in k and v[0] is not None]
                if len(rep) != 1:
                    fail(f"{kname}<{code}, {r}>: no single entry in the "
                         "compiler's report")
                regs, stack, spill = rep[0]
                say(f"[build] {kname}<{'double' if f64 else 'float'}, {r}> "
                    f"(kernel {num}): registers {regs}, stack {stack} B, "
                    f"spill stores {spill} B, dynamic shared bytes per block "
                    f"{query(r, f64)}")
    # the split designs of the four elimination sweeps, kernels 6, 8, 1
    # and 10 (pipeline.cuh's elim_split: lane groups of a chain warp and
    # three output warps; 10 without the right-hand side, a layout of its
    # own) at every rank and dtype, with the thread blocks an SM holds; the
    # float32 rank-5 instances must not touch local memory
    for kname, num, smem, blocks in (
            ("solveinv_split_kernel", 6, lib.cgt_elim_split_smem_bytes,
             lib.cgt_solveinv_split_blocks_per_sm),
            ("collect_split_kernel", 8, lib.cgt_elim_split_smem_bytes,
             lib.cgt_collect_split_blocks_per_sm),
            ("sweep_split_kernel", 1, lib.cgt_elim_split_smem_bytes,
             lib.cgt_sweep_split_blocks_per_sm),
            ("inverse_split_kernel", 10, lib.cgt_inverse_split_smem_bytes,
             lib.cgt_inverse_split_blocks_per_sm)):
        for r in _build.RANKS:
            for code, f64 in (("f", 0), ("d", 1)):
                rep = [v for k, v in _build.ptxas_report(r).items()
                       if f"{kname}I{code}Li{r}E" in k and v[0] is not None]
                if len(rep) != 1:
                    fail(f"{kname}<{code}, {r}>: no single entry in the "
                         "compiler's report")
                regs, stack, spill = rep[0]
                say(f"[build] {kname}<{'double' if f64 else 'float'}, {r}> "
                    f"(kernel {num}): registers {regs}, stack {stack} B, "
                    f"spill stores {spill} B, dynamic shared bytes per block "
                    f"{smem(r, f64)}, blocks an SM {blocks(r, f64)}")
                if r == RANK and not f64 and (stack or spill):
                    fail(f"{kname}<float, {r}> uses local memory (stack "
                         f"{stack} B, spill stores {spill} B)")
    # their thread-per-lane instances (float64 at _build.THREAD_RANKS,
    # where the table may route them)
    for kname, num in (("forward_sweep_kernel", 1),
                       ("forward_sweep_solveinv_kernel", 6),
                       ("forward_sweep_collect_kernel", 8),
                       ("forward_sweep_inverse_kernel", 10)):
        for r in _build.THREAD_RANKS:
            rep = [v for k, v in _build.ptxas_report(r).items()
                   if f"{len(kname)}{kname}IdLi{r}E" in k and v[0] is not None]
            if len(rep) != 1:
                fail(f"{kname}<double, {r}>: no single entry in the "
                     "compiler's report")
            regs, stack, spill = rep[0]
            say(f"[build] {kname}<double, {r}> (kernel {num}, one thread per "
                f"chunk lane): registers {regs}, stack {stack} B, spill "
                f"stores {spill} B")
    say(f"[build] float64 instances on one thread per chunk lane from a "
        f"chunk count on (sweep_cuda.THREAD_F64): {sweep_cuda.THREAD_F64}")

    # ---- 3. kernels vs plain twins at the slice's shapes -----------------
    clock("kernels")
    gen = torch.Generator().manual_seed(0)
    params = leg.init_params(RANK, OBS, generator=gen, dtype=torch.float32,
                             device=dev)
    # float64 timestamps: at N = 1e6 a float32 time axis cannot resolve
    # the 0.01 minimum gap (gaps would quantise to zero)
    ts, xs = generate_data(N_BIG, OBS, dtype=torch.float64, seed=0,
                           device=dev)
    xs = xs.float()
    with torch.no_grad():
        g = leg.g_matrix(params).contiguous()
        llt = leg.lambda_lambda_t(params)
        boost = (params.b.T @ torch.linalg.solve(llt, params.b)).contiguous()
        s = pt.default_chunk_len(N_BIG)
        c = -(-N_BIG // s)
        diffs, gv, real = leg._chunk_gap_geometry(ts, s, N_BIG, c,
                                                  torch.float32)
        wrap = leg._wrap_row(g, diffs, gv, s)
        v_cm = leg._v_chunk_major(params, xs, llt, s, c, torch.float32)
        gaps = (ts[1:] - ts[:-1]).float().contiguous()
    say(f"[kernels] rank {RANK}, N {N_BIG}, s {s}, C {c}, "
        f"{N_BIG - 1} gaps")

    # the backward kernels' inputs as the two-kernel route's backward
    # hands them over (first, i.e. top-level, call of each)
    captured = {}

    def capture(module, attr):
        orig = getattr(module, attr)

        def size(args):
            return max(t.numel() for t in args
                       if isinstance(t, torch.Tensor))

        # the wrapper counts its launches on the module attribute it is
        # called through, which is the spy while the spy is in place
        @functools.wraps(orig)
        def spy(*args, **kw):
            # keep the top level's call: the ladder's calls are smaller
            if attr not in captured or size(args) > size(captured[attr][0]):
                captured[attr] = (args, kw)
            return orig(*args, **kw)

        setattr(module, attr, spy)
        return orig

    origs = [(leg, "k_system_adjoint_cuda",
              capture(leg, "k_system_adjoint_cuda")),
             (sweep_cuda, "forward_sweep_solveinv_cuda",
              capture(sweep_cuda, "forward_sweep_solveinv_cuda")),
             (sweep_cuda, "backward_solve_takahashi_cuda",
              capture(sweep_cuda, "backward_solve_takahashi_cuda"))]
    torch.autograd.grad(
        leg.log_likelihood(params, ts, xs, fused=False),
        list(params.parameters()))
    torch.cuda.synchronize()
    for module, attr, orig in origs:
        setattr(module, attr, orig)
    if len(captured) != 3:
        fail(f"the two-kernel backward reached only {sorted(captured)}")

    rows = []

    def check_kernel(key, source, replaces, kernel, twin, args, rtol, atol,
                     why, kw=None, atol_of_scale=False, gaps_of=None,
                     f64_outputs=(), record=True, phase="celerite",
                     reps=REPS):
        """Kernel vs twin.  For the outputs in ``f64_outputs`` the
        absolute tolerance is 4x the twin's own float32 error against the
        twin run in float64 on the same inputs (for values that cancel
        terms far larger than themselves).  ``record=False`` checks
        without adding a row to the kernels line (another block size of
        a kernel that has its row), printed under ``phase``; ``reps`` timed
        runs of the kernel, and one of the twin."""
        kw = kw or {}
        def outputs(fn, *a):
            out = fn(*a, **kw)
            return (out,) if isinstance(out, torch.Tensor) else tuple(
                _flat(out))

        with torch.no_grad():
            got = outputs(kernel, *args)
            torch.cuda.synchronize()
            ref = outputs(twin, *args)
            atols = {}
            if f64_outputs:
                ref64 = outputs(twin, *[a.double() if isinstance(
                    a, torch.Tensor) else a for a in args])
                for i in f64_outputs:
                    e_twin = float((ref[i].double() - ref64[i]).abs().max())
                    e_kern = float((got[i].double() - ref64[i]).abs().max())
                    atols[i] = 4.0 * e_twin
                    say(f"  {key} out[{i}] vs the float64 twin: kernel "
                        f"{e_kern:.3e}, float32 twin {e_twin:.3e}")
            err = compare(key, got, ref, rtol, atol, atol_of_scale, atols)
            ms = cuda_ms(lambda: kernel(*args, **kw), reps)
            # the twins take 0.03-5 s a call: one timed run (the
            # comparison's warmed it up), a kernel's row too (a median of
            # three runs would cost ~45 s of the time limit)
            plain_ms = cuda_ms(lambda: twin(*args, **kw), 1, warm=False)
        # an emission kernel's generator is its first argument
        b_ms, b_by = bound(key, args, got,
                           g if gaps_of is None else args[0], gaps_of)
        tag = "kernels" if record else phase
        say(f"[{tag}] {key}: max_abs_err={err:.3e} ({why}); "
            f"kernel {ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if record:
            rows.append({"name": key, "route": "cuda", "source": source,
                         "replaces": replaces, "kernel": kernel,
                         "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None})
        return got

    check_kernel(
        "transition_and_noise",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:297",
        expm_cuda.transition_and_noise_cuda,
        expm_cuda.transition_and_noise_plain, (g, gaps), 1e-4, 1e-6,
        "same float32 Pade-7 algorithm; differs by FMA contraction and "
        "rsqrt/log rounding", gaps_of=gaps)
    # kernel 2 at the sizes the paths launch it at: the chunk-crossing gaps
    # (_wrap_row, M = C; and C = 1,024 and 4,096, N = 2^17's and 2^19's,
    # on the rows design's side of the table: the first of N = 1e6's), a
    # residual slab (65,536), the Kalman loss's gaps at N = 2^17 (its first
    # gap twice, as leg_to_ssm forms them) and the main path's 1e6 - 1
    # gaps; intercast's 4P in [posterior]
    ts_k, _ = generate_data(N_KALMAN, OBS, dtype=torch.float64, seed=5,
                            device=dev)
    gaps_k = (ts_k[1:] - ts_k[:-1]).float()
    gaps_k = torch.cat([gaps_k[:1], gaps_k]).contiguous()
    run_tn_sizes("kernels", expm_cuda, g, [
        ("C at N = 2^17", diffs[s - 1][:1024].contiguous()),
        ("C at N = 2^19", diffs[s - 1][:4096].contiguous()),
        ("the chunk-crossing gaps, _wrap_row", diffs[s - 1].contiguous()),
        ("a residual slab", gaps[:65536].contiguous()),
        (f"the Kalman loss at N = {N_KALMAN}", gaps_k),
        ("the main path's gaps", gaps)])
    del ts_k, gaps_k
    k_sys = check_kernel(
        "k_system",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:530",
        expm_cuda.k_system_cuda, expm_cuda.k_system_plain,
        (g, boost, diffs, gv, real, wrap), 1e-3, 1e-4,
        "K ~ Q1^{-1} amplifies (e, Q1) rounding by cond(Q1) for small gaps; "
        "the JAX kernel-vs-XLA bar", gaps_of=diffs)
    check_kernel(
        "forward_sweep",
        "cyclic_gps_tpu_torch/csrc/forward_sweep.cu",
        "cyclic_gps_tpu/ops/pallas_sweep.py:248",
        sweep_cuda.forward_sweep_cuda, sweep_cuda.forward_sweep_plain,
        (k_sys[0], k_sys[1], v_cm), 1e-3, 1e-4,
        "127 dependent elimination steps on kernel 3's K; mh/ld summed "
        "over 1e6 rows in another order; split design (pipeline.cuh "
        "elim_split: a chain warp, three output warps)")
    check_kernel(
        "gap_mahal_sweep",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:769",
        expm_cuda.gap_mahal_sweep_cuda, expm_cuda.gap_mahal_sweep_plain,
        (g, boost, diffs, gv, real, wrap, v_cm), 1e-3, 1e-4,
        "kernels 3 and 1 fused: the same rounding sources", gaps_of=diffs)
    args5, _ = captured["k_system_adjoint_cuda"]
    check_kernel(
        "k_system_adjoint",
        "cyclic_gps_tpu_torch/csrc/gap_adjoint.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:1046",
        expm_cuda.k_system_adjoint_cuda, expm_cuda.k_system_adjoint_plain,
        args5, 1e-3, 1e-4,
        "solves against chol(Q1) amplify float32 rounding by cond(Q1); "
        "c_G and c_sym are sums over 1e6 gaps in another order, atol 1e-4 "
        "of their scale; each c_dt cancels terms ~1e3 times its size, so "
        "its atol is 4x the float32 twin's own error against float64",
        atol_of_scale=True, gaps_of=args5[1], f64_outputs=(2,))
    args6, kw6 = captured["forward_sweep_solveinv_cuda"]
    check_kernel(
        "forward_sweep_solveinv",
        "cyclic_gps_tpu_torch/csrc/backward_sweep.cu",
        "cyclic_gps_tpu/ops/pallas_sweep.py:772",
        sweep_cuda.forward_sweep_solveinv_cuda,
        sweep_cuda.forward_sweep_solveinv_plain, args6, 1e-3, 1e-4,
        "kernel 1's 127 dependent steps plus the triangular inverse behind "
        "pinv = P^{-1}; atol is 1e-4 of each output's scale; split design "
        "(pipeline.cuh elim_split: a chain warp, three output warps)",
        kw=kw6, atol_of_scale=True)
    args7, _ = captured["backward_solve_takahashi_cuda"]
    check_kernel(
        "backward_solve_takahashi",
        "cyclic_gps_tpu_torch/csrc/backward_sweep.cu",
        "cyclic_gps_tpu/ops/pallas_sweep.py:918",
        sweep_cuda.backward_solve_takahashi_cuda,
        sweep_cuda.backward_solve_takahashi_plain, args7, 1e-3, 1e-4,
        "127 dependent multiply-add steps of the back-substitution and "
        "the Takahashi walk; atol is 1e-4 of each output's scale",
        atol_of_scale=True)
    with torch.no_grad():
        once = expm_cuda.k_system_adjoint_cuda(*args5)
        twice = expm_cuda.k_system_adjoint_cuda(*args5)
        torch.cuda.synchronize()
    if not all(bool(torch.equal(a, b)) for a, b in zip(once, twice)):
        fail("k_system_adjoint: two runs on the main path's inputs differ")
    say("[kernels] k_system_adjoint: the same bits on a second run")
    del once, twice
    clock("emission")
    run_emission_edges(dev, check_kernel, leg, expm_cuda, _build)
    run_walk_edges(dev, check_kernel, sweep_cuda, pt)
    run_elim_edges(dev, sweep_cuda, pt)
    clock("elim-pick")
    run_elim_pick(dev, sweep_cuda, pt, _build)
    by_name = {r["name"]: r for r in rows}

    # ---- 4. the main path through the user entry points -------------------
    clock("path")
    fn, (p_e, ts_e, xs_e) = entry(device=dev)
    ts_r, xs_r = generate_data(N_BIG, OBS, dtype=torch.float32,
                               spacing="regular", seed=1, device=dev)
    ts_s, xs_s = generate_data(N_SMALL, OBS, dtype=torch.float32, seed=2,
                               device=dev)
    cases = [
        # (label, call(backend), rtol, reason)
        ("entry N=1024 irregular (fused)",
         lambda b: leg.log_likelihood(p_e, ts_e, xs_e, backend=b), 2e-5,
         "the JAX fused-vs-plain bar at this size"),
        ("N=1e6 irregular (fused)",
         lambda b: leg.log_likelihood(params, ts, xs, backend=b), 1e-4,
         "float32 sums over 1e6 rows in different orders; Pade-7 kernels "
         "vs the Pade-13 plain emission"),
        ("N=1e6 irregular (two-kernel route, fused=False)",
         lambda b: leg.log_likelihood(params, ts, xs, backend=b,
                                      fused=False), 1e-4,
         "as above"),
        ("N=1e6 regular",
         lambda b: leg.log_likelihood(params, ts_r, xs_r, regular=True,
                                      backend=b), 1e-4,
         "as above"),
        (f"N={N_SMALL} irregular (small-N route)",
         lambda b: leg.log_likelihood(params, ts_s, xs_s, backend=b), 2e-5,
         "one Pade-7 kernel vs Pade-13, 48 rows"),
    ]
    forward_kernels = ("transition_and_noise", "k_system", "forward_sweep",
                       "gap_mahal_sweep")
    for r in rows:
        r["kernel"].launches = 0
    auto_vals = []
    with torch.no_grad():
        auto_vals.append(fn(p_e, ts_e, xs_e))
        for label, call, _, _ in cases[1:]:
            auto_vals.append(call("auto"))
        torch.cuda.synchronize()
    launches = {r["name"]: r["kernel"].launches for r in rows}
    say(f"[path] launches in the backend='auto' main-path run: {launches}")
    for key in forward_kernels:
        if launches[key] <= 0:
            fail(f"kernel {key} was not launched by the likelihood path")

    with torch.no_grad():
        for (label, call, rtol, why), v_auto in zip(cases, auto_vals):
            if not torch.isfinite(v_auto) or v_auto.shape != ():
                fail(f"{label}: bad value {v_auto}")
            ms_auto, _ = host_ms(lambda: call("auto"))
            ms_plain, v_plain = host_ms(lambda: call("torch"))
            rel = abs(float(v_auto) - float(v_plain)) / abs(float(v_plain))
            ok = rel <= rtol
            say(f"[path] {label}: auto {float(v_auto):.6f} "
                f"({ms_auto:.2f} ms), torch {float(v_plain):.6f} "
                f"({ms_plain:.2f} ms), rel diff {rel:.3e} <= {rtol:g} "
                f"({why}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{label}: backend='auto' disagrees with 'torch'")

        # the dense float64 oracle on the small case
        p64 = leg.LEGParams(*[t.detach().double() for t in
                              (params.n_params, params.r_params,
                               params.lambda_params, params.b)])
        ref = float(dense.log_marginal_likelihood_from_params(
            p64, ts_s.double(), xs_s.double()))
        got = float(auto_vals[-1])
        rel = abs(got - ref) / abs(ref)
        say(f"[path] N={N_SMALL} vs dense float64 oracle: {got:.6f} vs "
            f"{ref:.6f}, rel diff {rel:.3e} <= 1e-4 (float32 model) "
            f"{'ok' if rel <= 1e-4 else 'MISMATCH'}")
        if rel > 1e-4:
            fail("small-N likelihood disagrees with the dense oracle")

    # ---- 5. gradients: backend="auto" vs "torch" on every route -----------
    clock("grad")
    grad_bar = 1e-3
    say(f"[grad] bar: ||g_auto - g_torch||_inf / ||g_torch||_inf <= "
        f"{grad_bar:g} per leaf (float32 gradients summed over up to 1e6 "
        "gaps in other orders, Pade-7 kernels vs the Pade-13 plain "
        "emission; the JAX package's fused-vs-plain gradient bar is rtol "
        "5e-3 / atol 5e-4 at n = 300)")
    leaves = ("n_params", "r_params", "lambda_params", "b")

    def grads(p, t, x, **kw):
        ll = leg.log_likelihood(p, t, x, **kw)
        return torch.autograd.grad(ll, list(p.parameters()))

    grad_cases = [
        ("N=1e6 irregular (fused)", params, ts, xs, {}),
        ("N=1e6 irregular (fused=False)", params, ts, xs, {"fused": False}),
        ("N=1e6 regular", params, ts_r, xs_r, {"regular": True}),
        (f"N={N_SMALL} irregular", params, ts_s, xs_s, {}),
        ("entry N=1024 irregular", p_e, ts_e, xs_e, {}),
    ]
    torch_grads = {}
    for label, p, t, x, kw in grad_cases:
        ms_auto, g_auto = host_ms(lambda: grads(p, t, x, **kw), reps=1)
        key = (id(p), id(t), kw.get("regular", False))
        if key not in torch_grads:  # "torch" ignores the fused switch
            torch_grads[key] = host_ms(
                lambda: grads(p, t, x, backend="torch", **kw), reps=1)
        ms_plain, g_plain = torch_grads[key]
        rels = [rel_inf(a, b) for a, b in zip(g_auto, g_plain)]
        finite = all(bool(torch.isfinite(a).all()) for a in g_auto)
        ok = finite and max(rels) <= grad_bar
        say(f"[grad] {label}: auto {ms_auto:.1f} ms, torch "
            f"{ms_plain:.1f} ms; per-leaf rel diff "
            + ", ".join(f"{k} {v:.2e}" for k, v in zip(leaves, rels))
            + f" {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label}: the backend='auto' gradient disagrees")

    # float64 small case against autograd through the dense oracle
    p64 = leg.LEGParams(*[t.detach().double().clone() for t in
                          (params.n_params, params.r_params,
                           params.lambda_params, params.b)])
    g_port = grads(p64, ts_s.double(), xs_s.double())
    g_dense = torch.autograd.grad(
        dense.log_marginal_likelihood_from_params(
            p64, ts_s.double(), xs_s.double()), list(p64.parameters()))
    rels = [rel_inf(a, b) for a, b in zip(g_port, g_dense)]
    ok = max(rels) <= 1e-8
    say(f"[grad] N={N_SMALL} float64 vs autograd through the dense oracle: "
        + ", ".join(f"{k} {v:.2e}" for k, v in zip(leaves, rels))
        + f" <= 1e-8 (float64, O(N^3) oracle) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the float64 gradient disagrees with the dense oracle")

    # ---- 6. training: Adam steps on the fused N = 1e6 route ---------------
    clock("train")
    p_train = leg.init_params(RANK, OBS, generator=torch.Generator()
                              .manual_seed(0), device=dev)
    opt = loop.make_optimizer("adam", 1e-2)
    for r in rows:
        r["kernel"].launches = 0
    expm_cuda.gap_mahal_sweep_cuda.launches_tiled = 0
    expm_cuda.k_system_adjoint_cuda.launches_sorted = 0
    expm_cuda.k_system_cuda.launches_tiled = 0
    tn0 = tn_watch(expm_cuda)
    sweep_cuda.backward_solve_takahashi_cuda.launches_split = 0
    sweep_cuda.forward_sweep_solveinv_cuda.launches_split = 0
    elim0 = elim_counts(sweep_cuda)
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = loop.train_step(p_train, opt, ts, xs)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(value))
    for r in rows:
        r["launches"] = r["kernel"].launches
    say(f"[train] launches in {TRAIN_STEPS} train steps: "
        f"{ {r['name']: r['launches'] for r in rows} }")
    for r in rows:
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched by the train step")
    designs = {"gap_mahal_sweep": expm_cuda.gap_mahal_sweep_cuda.launches_tiled,
               "k_system_adjoint":
               expm_cuda.k_system_adjoint_cuda.launches_sorted,
               "k_system": expm_cuda.k_system_cuda.launches_tiled,
               "backward_solve_takahashi":
               sweep_cuda.backward_solve_takahashi_cuda.launches_split,
               "forward_sweep_solveinv":
               sweep_cuda.forward_sweep_solveinv_cuda.launches_split}
    say(f"[train] launches of kernels 4 (tiled), 5 (sorted), 3 (tiled), "
        f"7 and 6 (split) in the {TRAIN_STEPS} steps: "
        f"{designs}")
    for key, n in designs.items():
        if n != by_name[key]["launches"]:
            fail(f"{key}: {n} of {by_name[key]['launches']} launches in the "
                 "train steps took the redesigned kernel")
    check_tn_path("train", f"{TRAIN_STEPS} Adam steps (the chunk-crossing "
                  "gaps)", expm_cuda, tn0, c)
    check_elim_designs("train", f"{TRAIN_STEPS} Adam steps", sweep_cuda,
                       elim0)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    say(f"[train] losses {losses}; step ms {[round(t, 2) for t in step_ms]}"
        f", median {statistics.median(step_ms):.2f} ms (host clock, "
        "synchronised; the first step includes warm-up)")

    k6 = sweep_cuda.forward_sweep_solveinv_cuda
    n6, n6_split = k6.launches, k6.launches_split
    def top_ops(by_kernel):
        """The ten device ops with the most time, then every split-design
        kernel of ranks 1-8 below them (the LEG kernels 6-9 and 11 that
        earlier PRs redesigned), as (name, (ms, calls))."""
        ops = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
        return ops[:10] + [kv for kv in ops[10:] if "split_kernel" in kv[0]]

    elim0 = elim_counts(sweep_cuda)
    wall, by_kernel = profiled(lambda: loop.train_step(p_train, opt, ts, xs))
    check_elim_designs("train", "profiled step", sweep_cuda, elim0)
    n6, n6_split = k6.launches - n6, k6.launches_split - n6_split
    say(f"[train] profiled step: kernel 6 launches {n6}, split {n6_split}")
    if n6 <= 0 or n6_split != n6:
        fail("forward_sweep_solveinv: not launched in the profiled step, or "
             "a launch did not take the split design")
    _, by_fwd = profiled(lambda: loop.nll_loss(p_train, ts, xs))
    train_dev_ms = None  # the LEG step's device ms, for [stacked]
    if not by_kernel:
        say("[train] profiled step: the profiler saw no device events; "
            "device ops and busy share not measured")
    else:
        dev_ms = train_dev_ms = sum(ms for ms, _ in by_kernel.values())
        fwd_ms = sum(ms for ms, _ in by_fwd.values())
        n_ops = sum(n for _, n in by_kernel.values())
        med = statistics.median(step_ms[1:])
        say(f"[train] profiled step: wall {wall:.2f} ms (profiler on), "
            f"{n_ops} device ops, device {dev_ms:.2f} ms, busy share "
            f"{dev_ms / wall:.3f}, against the unprofiled median wall "
            f"{med:.2f} ms of the steps after the first {dev_ms / med:.3f}; "
            "the forward alone (loss with grad on) "
            f"{fwd_ms:.2f} ms of device time, "
            f"{sum(n for _, n in by_fwd.values())} device ops")
    for key, (ms, n) in top_ops(by_kernel):
        say(f"[train]   {key[:80]}: {ms:.3f} ms, {n} calls")
    elim_profile("train", by_kernel)
    # the float32 default on this grid: the residual loss
    clock("residual")
    run_residual_phase(dev, leg, loop, sweep_cuda, expm_cuda, ts, xs,
                       grad_bar)
    # the float32 defaults on smaller and uniform grids: the Kalman losses
    torch.cuda.empty_cache()
    clock("kalman")
    run_kalman_phase(dev, leg, loop, kalman, expm_cuda, grad_bar)
    torch.cuda.empty_cache()

    # ---- 7. posterior: kernels 8-11, bench.py's solve, the path ----------
    clock("posterior")
    post_kernels = ("forward_sweep_collect", "backward_substitute",
                    "forward_sweep_inverse", "takahashi_backward")
    captured.clear()
    origs = [(sweep_cuda, f"{k}_cuda", capture(sweep_cuda, f"{k}_cuda"))
             for k in post_kernels]
    with torch.no_grad():
        leg.insample_posterior(params, ts, xs, method="precision")
    torch.cuda.synchronize()
    for module, attr, orig in origs:
        setattr(module, attr, orig)
    if len(captured) != 4:
        fail(f"the posterior reached only {sorted(captured)}")
    for key, line, why in (
            ("forward_sweep_collect", 400,
             "kernel 1's 127 dependent elimination steps plus three back "
             "substitutions per row; atol is 1e-4 of each output's scale; "
             "split design (pipeline.cuh elim_split: a chain warp, three "
             "output warps)"),
            ("backward_substitute", 1006,
             "127 dependent multiply-add steps; atol is 1e-4 of the "
             "output's scale"),
            ("forward_sweep_inverse", 534,
             "kernel 1's 127 dependent elimination steps; atol is 1e-4 of "
             "each output's scale; split design without the right-hand "
             "side (pipeline.cuh elim_split)"),
            ("takahashi_backward", 648,
             "126 dependent steps, four products a row on the chain in "
             "the hat form, which sums u0 and u1 in another order than the "
             "twin; atol is 1e-4 of each output's scale")):
        args_k, kw_k = captured[f"{key}_cuda"]
        source = ("solve_sweep.cu" if key in post_kernels[:2]
                  else "inverse_sweep.cu")
        check_kernel(
            key, f"cyclic_gps_tpu_torch/csrc/{source}",
            f"cyclic_gps_tpu/ops/pallas_sweep.py:{line}",
            getattr(sweep_cuda, f"{key}_cuda"),
            getattr(sweep_cuda, f"{key}_plain"), args_k, 1e-3, 1e-4, why,
            kw=kw_k, atol_of_scale=True)

    run_post_walk_edges(dev, check_kernel, sweep_cuda, pt)

    # bench.py's headline op: solve + logdet of its system at N = 1e6, d = 5
    R_b, O_b, y_b = make_system_cm(N_BIG, 5, dev)
    k9 = sweep_cuda.backward_substitute_cuda
    k8 = sweep_cuda.forward_sweep_collect_cuda
    n9, n9_split = k9.launches, k9.launches_split
    n8, n8_split = k8.launches, k8.launches_split
    elim0 = elim_counts(sweep_cuda)
    with torch.no_grad():
        x_a, ld_a = pt.solve_cm(R_b, O_b, y_b, backend="auto")
        x_t, ld_t = pt.solve_cm(R_b, O_b, y_b, backend="torch")
        ms_a = cuda_ms(lambda: pt.solve_cm(R_b, O_b, y_b, backend="auto"))
        ms_t = cuda_ms(lambda: pt.solve_cm(R_b, O_b, y_b, backend="torch"))
    rel_x, rel_ld = rel_inf(x_a, x_t), abs(float(ld_a - ld_t) / float(ld_t))
    ok = rel_x <= 1e-4 and rel_ld <= 1e-5
    say(f"[posterior] bench.py solve_cm N={N_BIG}, d=5, float32: auto "
        f"{ms_a:.3f} ms, torch {ms_t:.3f} ms (CUDA-event median of {REPS}); "
        f"x rel diff {rel_x:.2e} <= 1e-4, log|J| rel diff {rel_ld:.2e} <= "
        "1e-5 (diagonally dominant system, cond O(1); float32 sums over "
        f"1e6 rows in other orders) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("solve_cm: backend='auto' disagrees with 'torch'")
    say(f"[posterior] solve_cm: kernel 9 launches {k9.launches - n9}, "
        f"split {k9.launches_split - n9_split}; kernel 8 launches "
        f"{k8.launches - n8}, split {k8.launches_split - n8_split}")
    for num, k, n, n_split in ((9, k9, n9, n9_split), (8, k8, n8, n8_split)):
        if k.launches == n or k.launches_split - n_split != k.launches - n:
            fail(f"solve_cm: kernel {num} was not launched, or a launch did "
                 "not take the split design")
    check_elim_designs("posterior", "solve_cm (value, then timed runs)",
                       sweep_cuda, elim0)
    del R_b, O_b, y_b, x_a, x_t

    # the posterior path: counts reset just before and read just after
    for r in rows:
        r["kernel"].launches = 0
    expm_cuda.k_system_cuda.launches_tiled = 0
    tn0 = tn_watch(expm_cuda)
    split_walks = {key: getattr(sweep_cuda, f"{key}_cuda") for key in
                   ("forward_sweep_collect", "backward_substitute",
                    "takahashi_backward")}
    for w in split_walks.values():
        w.launches_split = 0
    elim0 = elim_counts(sweep_cuda)
    with torch.no_grad():
        post_auto = leg.insample_posterior(params, ts, xs,
                                           method="precision")
        torch.cuda.synchronize()
    check_elim_designs("posterior", "one insample_posterior call",
                       sweep_cuda, elim0)
    post_launches = {r["name"]: r["kernel"].launches for r in rows}
    post_split = {k: w.launches_split for k, w in split_walks.items()}
    say(f"[posterior] launches in one insample_posterior(method="
        f"'precision') call, N={N_BIG} irregular float32: {post_launches}; "
        f"kernel 3 tiled {expm_cuda.k_system_cuda.launches_tiled}; kernels "
        f"8, 9 and 11 split {post_split}")
    if expm_cuda.k_system_cuda.launches_tiled != post_launches["k_system"]:
        fail("k_system: a launch in the posterior call did not take the "
             "tiled design")
    check_tn_path("posterior", "one insample_posterior call (the "
                  "chunk-crossing gaps)", expm_cuda, tn0, c)
    for key, n in post_split.items():
        if n != post_launches[key]:
            fail(f"{key}: {n} of {post_launches[key]} launches in the "
                 "posterior call took the split design")
    for key in ("transition_and_noise", "k_system") + post_kernels:
        if post_launches[key] <= 0:
            fail(f"kernel {key} was not launched by the posterior path")
    for r in rows:
        if r["name"] in post_kernels:
            r["launches"] = post_launches[r["name"]]

    post_bar = 1e-3
    why32 = ("float32 posterior of K (cond ~1e3 at the 0.01 minimum gap): "
             "Pade-7 kernels vs the Pade-13 plain emission, eliminations "
             "in other orders; atol is 1e-3 of each output's scale")
    params64 = leg.LEGParams(*[t.detach().double() for t in
                               (params.n_params, params.r_params,
                                params.lambda_params, params.b)])
    post_cases = [
        ("insample_posterior N=1e6 irregular float32",
         lambda b: leg.insample_posterior(params, ts, xs,
                                          method="precision", backend=b),
         post_bar, why32),
        ("insample_posterior N=1e6 regular float32",
         lambda b: leg.insample_posterior(params, ts_r, xs_r, regular=True,
                                          method="precision", backend=b),
         post_bar, why32),
        ("insample_posterior N=1e6 irregular float64, method='auto'",
         lambda b: leg.insample_posterior(params64, ts, xs.double(),
                                          backend=b),
         1e-9, "float64: the same emission on both backends, eliminations "
         "in other orders; atol is 1e-9 of each output's scale"),
    ]
    post_wall = None  # the unprofiled wall of the float32 irregular call
    for label, call, bar, why in post_cases:
        with torch.no_grad():
            ms_auto, got = host_ms(lambda: call("auto"), reps=1)
            ms_plain, ref = host_ms(lambda: call("torch"), reps=1)
        post_wall = post_wall or ms_auto
        compare(label, got, ref, 0.0, bar, atol_of_scale=True)
        say(f"[posterior] {label}: auto {ms_auto:.2f} ms, torch "
            f"{ms_plain:.2f} ms (host clock); agree ({why})")
    del post_auto

    # predictions: P = 1e6 sorted targets (midpoints and forecasts on both
    # sides), then a dense grid (P >= 2N: the dual geometry branch)
    mid = 0.5 * (ts[1:] + ts[:-1])
    edge = torch.tensor([3.0, 0.5], dtype=ts.dtype, device=dev)
    targets = torch.cat([ts[0] - edge, mid, ts[-1] + edge.flip(0)])
    ts_d, xs_d = generate_data(1024, OBS, dtype=torch.float64, seed=3,
                               device=dev)
    targets_d = torch.sort(ts_d[0] - 1.0 + (ts_d[-1] - ts_d[0] + 2.0)
                           * torch.rand(4096, dtype=torch.float64,
                                        generator=torch.Generator()
                                        .manual_seed(4)).to(dev)).values
    pred_cases = [
        (f"make_predictions N={N_BIG}, P={targets.shape[0]} float32",
         lambda b: leg.make_predictions(params, ts, xs, targets,
                                        method="precision", backend=b)),
        ("make_predictions N=1024, P=4096 float32 (dual geometry branch)",
         lambda b: leg.make_predictions(params, ts_d, xs_d.float(),
                                        targets_d, method="precision",
                                        backend=b)),
    ]
    # intercast's gaps through kernel 2: counted over one call of the
    # P = 1e6 + 3 case, its largest launch kept to be timed below
    captured.clear()
    orig = capture(expm_cuda, "transition_and_noise_cuda")
    tn0 = tn_watch(expm_cuda)  # the spy's counters, which count in place
    with torch.no_grad():
        pred_cases[0][1]("auto")
        torch.cuda.synchronize()
    check_tn_path("posterior", f"make_predictions P={targets.shape[0]}",
                  expm_cuda, tn0)
    expm_cuda.transition_and_noise_cuda = orig
    if "transition_and_noise_cuda" not in captured:
        fail("make_predictions: kernel 2 was not launched")
    g_p, dt_p = captured.pop("transition_and_noise_cuda")[0]
    run_tn_sizes("posterior", expm_cuda, g_p, [
        ("intercast's gaps, 4P", dt_p)])
    del g_p, dt_p
    for label, call in pred_cases:
        with torch.no_grad():
            ms_auto, got = host_ms(lambda: call("auto"), reps=1)
            ms_plain, ref = host_ms(lambda: call("torch"), reps=1)
        compare(label, got, ref, 0.0, post_bar, atol_of_scale=True)
        say(f"[posterior] {label}: auto {ms_auto:.2f} ms, torch "
            f"{ms_plain:.2f} ms (host clock); agree ({why32}; the "
            "interpolation exponentials add the same Pade-7 vs Pade-13 "
            "difference)")

    # float64 N = 48 latent predictive against the dense GP oracle
    ts48, xs48 = ts_s.double(), xs_s.double()
    t_star = torch.stack([ts48[0] - 2.3, 0.6 * ts48[10] + 0.4 * ts48[11],
                          ts48[-1] + 1.7])
    with torch.no_grad():
        lat_mean, lat_cov = leg.predictive_posterior(params64, ts48, xs48,
                                                     t_star)
        worst = 0.0
        for i in range(t_star.shape[0]):
            m_o, c_o = dense_latent_predictive(leg, params64, ts48, xs48,
                                               t_star[i])
            for a, b in ((lat_mean[i], m_o), (lat_cov[i], c_o)):
                err = float(((a - b).abs() / (1e-8 + 1e-7 * b.abs())).max())
                worst = max(worst, err)
    say(f"[posterior] N={N_SMALL} float64 predictive (backward forecast, "
        "interpolation, forward forecast) vs the dense GP oracle: "
        f"err/tol {worst:.3e} (rtol 1e-7, atol 1e-8, the bar of "
        f"tests/test_models.py) {'ok' if worst <= 1.0 else 'MISMATCH'}")
    if worst > 1.0:
        fail("the float64 predictive disagrees with the dense oracle")

    with torch.no_grad():
        wall, by_kernel = profiled(lambda: leg.insample_posterior(
            params, ts, xs, method="precision"))
    if not by_kernel:
        say("[posterior] profiled call: the profiler saw no device events; "
            "device ops and busy share not measured")
    else:
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        n_ops = sum(n for _, n in by_kernel.values())
        say(f"[posterior] profiled insample_posterior N={N_BIG} irregular "
            f"float32: wall {wall:.2f} ms (profiler on), {n_ops} device "
            f"ops, device {dev_ms:.2f} ms, busy share {dev_ms / wall:.3f}, "
            f"against the unprofiled wall {post_wall:.2f} ms (host clock, "
            f"one run after a warm-up) {dev_ms / post_wall:.3f}")
    for key, (ms, n) in top_ops(by_kernel):
        say(f"[posterior]   {key[:80]}: {ms:.3f} ms, {n} calls")
    elim_profile("posterior", by_kernel)
    del post_cases, pred_cases
    torch.cuda.empty_cache()

    # ---- 7b. the smoother: float32 method="auto" posteriors ---------------
    clock("smoother")
    run_smoother_phase(dev, leg, kalman, expm_cuda, params, post_bar)
    torch.cuda.empty_cache()

    # ---- 7c. stacked series: kernels 1-11 under a series mask -------------
    clock("stacked")
    run_stacked_phase(dev, leg, loop, pt, expm_cuda, sweep_cuda, params,
                      rows, captured, capture, check_kernel, grad_bar,
                      post_bar, train_dev_ms)
    torch.cuda.empty_cache()

    # ---- 8. celerite: nblocks 8 (rank 16), the bench grid ------------------
    clock("celerite")
    from cyclic_gps_tpu_torch.models import celerite
    from cyclic_gps_tpu_torch.ops import celerite_cuda

    torch.cuda.empty_cache()
    ts_c, xs_c = bench_grid(N_BIG, dev)
    p8 = celerite.init_params(CEL_NB, 1, generator=torch.Generator()
                              .manual_seed(0), device=dev)
    p2 = celerite.init_params(CEL_NB_SMALL, 1, generator=torch.Generator()
                              .manual_seed(1), device=dev)
    say(f"[celerite] nblocks {CEL_NB} (rank {2 * CEL_NB}) and "
        f"{CEL_NB_SMALL}, obs 1, N {N_BIG}, bench grid (gaps randint(1, 5)"
        " * 0.125, float32 timestamps exact), float32, seeded weights")

    # the inputs the main path hands the kernels: one forward of the
    # precision route (kernel 12) and one gradient of the filter route
    # (kernels 13-15, and 1, 6 and 7 at block size 16 on its boundary
    # chain)
    captured.clear()
    cel_kernels = ("celerite_gap_mahal_sweep", "celerite_filter",
                   "celerite_filter_collect", "celerite_filter_adjoint")
    origs = [(celerite, f"{k}_cuda", capture(celerite, f"{k}_cuda"))
             for k in cel_kernels]
    with torch.no_grad():
        celerite.log_likelihood(p8, ts_c, xs_c)
    # kernels 1, 6 and 7: the first call at every level of the chain (C)
    levels = {}

    def level_capture(attr):
        orig = getattr(sweep_cuda, attr)

        @functools.wraps(orig)
        def spy(*args, **kw):
            levels.setdefault((attr, args[0].shape[-1]), (args, kw))
            return orig(*args, **kw)

        setattr(sweep_cuda, attr, spy)
        return orig

    origs += [(sweep_cuda, f"{k}_cuda", level_capture(f"{k}_cuda"))
              for k in ("forward_sweep", "forward_sweep_solveinv",
                        "backward_solve_takahashi")]
    torch.autograd.grad(celerite.log_likelihood_filter(p8, ts_c, xs_c),
                        list(p8.parameters()))
    torch.cuda.synchronize()
    for module, attr, orig in origs:
        setattr(module, attr, orig)
    if len(captured) != 4 or len(levels) < 6:
        fail(f"the celerite routes reached only {sorted(captured)} and "
             f"{sorted(levels)}")
    for key, source, line, rtol, why in (
            ("celerite_gap_mahal_sweep", "celerite_sweep.cu", 285, 1e-3,
             "127 dependent elimination steps on closed-form rank-16 rows; "
             "mh, ld and the log|Q1| sum over 1e6 rows in another order; "
             "atol 1e-4 of each output's scale"),
            ("celerite_filter", "celerite_filter.cu", 479, 1e-3,
             "128 dependent filter steps, the Cholesky of S against the "
             "twin's inverse; atol 1e-4 of each output's scale"),
            ("celerite_filter_collect", "celerite_filter.cu", 592, 1e-3,
             "kernel 13 plus its per-step history; atol 1e-4 of each "
             "output's scale"),
            ("celerite_filter_adjoint", "celerite_adjoint.cu", 813, 1e-3,
             "128 dependent adjoint steps; bbar and lambar summed over 1e6 "
             "steps in another order; atol 1e-4 of each output's scale")):
        args_k, kw_k = captured[f"{key}_cuda"]
        check_kernel(
            key, f"cyclic_gps_tpu_torch/csrc/{source}",
            f"cyclic_gps_tpu/ops/celerite_pallas.py:{line}",
            getattr(celerite_cuda, f"{key}_cuda"),
            getattr(celerite_cuda, f"{key}_plain"), args_k, rtol, 1e-4, why,
            kw=kw_k, atol_of_scale=True)
    # 1, 6 and 7 at block size 16 (one warp per lane) at every level
    for (attr, c), (args_k, kw_k) in sorted(levels.items(),
                                            key=lambda kv: -kv[0][1]):
        key = attr.removesuffix("_cuda")
        if args_k[0].shape[1] != 16:
            fail(f"{key} on the nblocks-{CEL_NB} chain at block size "
                 f"{args_k[0].shape[1]}")
        s_k = args_k[0].shape[0] + (key == "backward_solve_takahashi")
        check_kernel(
            key, "", "", getattr(sweep_cuda, attr),
            getattr(sweep_cuda, f"{key}_plain"), args_k, 1e-3, 1e-4,
            f"block size {args_k[0].shape[1]}, one warp per lane, the "
            f"boundary chain at C = {c} chunks of s = {s_k}; atol 1e-4 of "
            "each output's scale",
            kw=kw_k, atol_of_scale=True, record=False)
    captured.clear()
    torch.cuda.empty_cache()

    # both routes and their gradients, backend="auto" against "torch"
    cel_cases = [(f"{name} nblocks {p.nblocks}", fn, p)
                 for p in (p2, p8)
                 for name, fn in (("log_likelihood (precision)",
                                   celerite.log_likelihood),
                                  ("log_likelihood_filter",
                                   celerite.log_likelihood_filter))]
    cel_vals = {}
    for label, fn, p in cel_cases:
        with torch.no_grad():
            ms_auto, v_auto = host_ms(lambda: fn(p, ts_c, xs_c), reps=1)
            ms_plain, v_plain = host_ms(
                lambda: fn(p, ts_c, xs_c, backend="torch"), reps=1)
        cel_vals[label] = float(v_auto)
        rel = abs(float(v_auto) - float(v_plain)) / abs(float(v_plain))
        ok = bool(torch.isfinite(v_auto)) and rel <= 1e-4
        say(f"[celerite] {label}: auto {float(v_auto):.6f} ({ms_auto:.2f} "
            f"ms), torch {float(v_plain):.6f} ({ms_plain:.2f} ms), rel "
            f"diff {rel:.3e} <= 1e-4 (float32 sums over 1e6 rows in other "
            f"orders) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"celerite {label}: backend='auto' disagrees with 'torch'")
    for nb in (CEL_NB_SMALL, CEL_NB):
        a = cel_vals[f"log_likelihood (precision) nblocks {nb}"]
        b = cel_vals[f"log_likelihood_filter nblocks {nb}"]
        rel = abs(a - b) / abs(b)
        say(f"[celerite] nblocks {nb}: fused precision route vs filter "
            f"route (kernels) rel diff {rel:.3e} <= 1e-4 (two exact "
            f"decompositions of one likelihood, float32) "
            f"{'ok' if rel <= 1e-4 else 'MISMATCH'}")
        if rel > 1e-4:
            fail(f"celerite nblocks {nb}: the two routes disagree")
    cel_leaves = ("n_diag", "n_sub", "r_sub", "lambda_params", "b")
    for label, fn, p in cel_cases:
        def grads(**kw):
            return torch.autograd.grad(fn(p, ts_c, xs_c, **kw),
                                       list(p.parameters()))
        ms_auto, g_auto = host_ms(grads, reps=1)
        ms_plain, g_plain = host_ms(lambda: grads(backend="torch"), reps=1)
        rels = [rel_inf(a, b) for a, b in zip(g_auto, g_plain)]
        ok = (all(bool(torch.isfinite(a).all()) for a in g_auto)
              and max(rels) <= grad_bar)
        say(f"[celerite] grad {label}: auto {ms_auto:.1f} ms, torch "
            f"{ms_plain:.1f} ms; per-leaf rel diff "
            + ", ".join(f"{k} {v:.2e}" for k, v in zip(cel_leaves, rels))
            + f" <= {grad_bar:g} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"celerite {label}: the backend='auto' gradient disagrees")

    # the path: one likelihood call (precision route, kernel 12) and three
    # Adam steps on nll_loss (filter route, kernels 13-15, 14 and 15 one
    # warp per lane; the boundary chain through 1, 6 and 7 at block size
    # 16, one warp per lane), counts reset just before and read just after
    path_kernels = cel_kernels + ("forward_sweep", "forward_sweep_solveinv",
                                  "backward_solve_takahashi")
    counters = {r["name"]: r["kernel"] for r in rows}
    p_train = celerite.init_params(CEL_NB, 1, generator=torch.Generator()
                                   .manual_seed(0), device=dev)
    opt = loop.make_optimizer("adam", 1e-3, reduce_on_plateau=False)

    def adam_step():
        loss = celerite.nll_loss(p_train, ts_c, xs_c)
        for t in p_train.parameters():
            t.grad = None
        loss.backward()
        opt.step(p_train, loss.item())
        return loss.item()

    warp16 = (sweep_cuda.forward_sweep_cuda,
              sweep_cuda.forward_sweep_solveinv_cuda,
              sweep_cuda.backward_solve_takahashi_cuda)
    for r in rows:
        r["kernel"].launches = 0
    celerite_cuda.celerite_filter_adjoint_cuda.launches_warp = 0
    celerite_cuda.celerite_filter_collect_cuda.launches_warp = 0
    celerite_cuda.celerite_filter_cuda.launches_warp = 0
    celerite_cuda.celerite_gap_mahal_sweep_cuda.launches_warp = 0
    with torch.no_grad():
        ll_path = float(celerite.log_likelihood(p_train, ts_c, xs_c))
    torch.cuda.synchronize()
    ll_launches = {k: counters[k].launches for k in path_kernels}
    sweep_warp = celerite_cuda.celerite_gap_mahal_sweep_cuda.launches_warp
    # 1, 6 and 7 over the Adam steps alone (6 and 7 run only there)
    step_before = {w.__name__: w.launches for w in warp16}
    for w in warp16:
        w.launches_warp = 0
    step_ms, cel_losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cel_losses.append(adam_step())
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    cel_launches = {k: counters[k].launches for k in path_kernels}
    adj_warp = celerite_cuda.celerite_filter_adjoint_cuda.launches_warp
    col_warp = celerite_cuda.celerite_filter_collect_cuda.launches_warp
    flt_warp = celerite_cuda.celerite_filter_cuda.launches_warp
    steps16 = {w.__name__: (w.launches - step_before[w.__name__],
                            w.launches_warp) for w in warp16}
    say(f"[celerite] launches in one log_likelihood call: {ll_launches} "
        f"(kernel 12's warp-per-lane instance: {sweep_warp}); then with "
        f"{TRAIN_STEPS} Adam steps on nll_loss: {cel_launches} (kernel "
        f"15's warp-per-lane instance: {adj_warp}, kernel 14's: "
        f"{col_warp}, kernel 13's: {flt_warp}); kernels 1, 6 and 7 over "
        "the Adam steps (launches, warp-per-lane launches at block size "
        f"16): {steps16}")
    for name, (n_all, n_warp) in steps16.items():
        if n_all <= 0 or n_warp != n_all:
            fail(f"{name}: {n_warp} of {n_all} launches over the nblocks "
                 f"{CEL_NB} Adam steps took the warp-per-lane kernel")
    for k in path_kernels:
        if cel_launches[k] <= 0:
            fail(f"kernel {k} was not launched by the celerite path")
    if sweep_warp != ll_launches["celerite_gap_mahal_sweep"]:
        fail("kernel 12 did not take its warp-per-lane instance at nblocks "
             f"{CEL_NB}")
    if adj_warp != cel_launches["celerite_filter_adjoint"]:
        fail("kernel 15 did not take its warp-per-lane instance at nblocks "
             f"{CEL_NB}")
    if col_warp != cel_launches["celerite_filter_collect"]:
        fail("kernel 14 did not take its warp-per-lane instance at nblocks "
             f"{CEL_NB}")
    if flt_warp != cel_launches["celerite_filter"]:
        fail("kernel 13 did not take its warp-per-lane instance at nblocks "
             f"{CEL_NB}")
    for r in rows:
        if r["name"] in cel_kernels:
            r["launches"] = cel_launches[r["name"]]
    if not all(math.isfinite(v) for v in cel_losses + [ll_path]):
        fail(f"non-finite celerite loss: {ll_path}, {cel_losses}")
    say(f"[celerite] log_likelihood {ll_path:.6f}; Adam losses "
        f"{cel_losses}; step ms {[round(t, 2) for t in step_ms]}, median "
        f"{statistics.median(step_ms):.2f} ms (host clock, synchronised; "
        "the first step includes warm-up)")
    wall, by_kernel = profiled(adam_step)
    if not by_kernel:
        say("[celerite] profiled step: the profiler saw no device events; "
            "device ops and busy share not measured")
    else:
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        n_ops = sum(n for _, n in by_kernel.values())
        say(f"[celerite] profiled Adam step: wall {wall:.2f} ms (profiler "
            f"on), {n_ops} device ops, device {dev_ms:.2f} ms, busy share "
            f"{dev_ms / wall:.3f}")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :10]:
        say(f"[celerite]   {key[:80]}: {ms:.3f} ms, {n} calls")

    # predictions through the expanded LEG posterior (kernels 2, 3, 8-11
    # stop at rank 8: nblocks 2)
    targets_c = torch.sort(ts_c[0] + (ts_c[-1] - ts_c[0]) * torch.rand(
        10_000, generator=torch.Generator().manual_seed(5)).to(dev)).values
    with torch.no_grad():
        ms_auto, got = host_ms(lambda: celerite.make_predictions(
            p2, ts_c, xs_c, targets_c, method="precision"), reps=1)
        ms_plain, ref = host_ms(lambda: celerite.make_predictions(
            p2, ts_c, xs_c, targets_c, method="precision", backend="torch"),
            reps=1)
    compare(f"celerite make_predictions nblocks {CEL_NB_SMALL}", got, ref,
            0.0, post_bar, atol_of_scale=True)
    say(f"[celerite] make_predictions(method='precision') nblocks "
        f"{CEL_NB_SMALL}, N={N_BIG}, P={targets_c.shape[0]}: auto "
        f"{ms_auto:.2f} ms, torch {ms_plain:.2f} ms (host clock); agree "
        f"(atol 1e-3 of each output's scale: {why32})")

    # kernels 15's, 14's, 13's and 12's two instances at their edge
    # shapes, and at nblocks 6
    run_adjoint_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                      xs_c)
    run_collect_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                      xs_c)
    run_filter_edges(dev, check_kernel, celerite, celerite_cuda, ts_c,
                     xs_c)
    run_sweep_edges(dev, check_kernel, celerite, celerite_cuda, ts_c, xs_c)
    # kernels 1, 6 and 7 at block size 16 at their edge shapes
    run_edges(dev, "celerite", captured, capture, check_kernel, pt,
              ("forward_sweep", "forward_sweep_solveinv",
               "backward_solve_takahashi"), EDGES16)

    # ---- 9. wide: block sizes 9-15 (kernels 16, 21, 22) --------------------
    clock("wide")
    run_wide_phase(dev, rows, captured, capture, check_kernel, profiled,
                   grad_bar, celerite, loop, pt, ts_c, xs_c)

    # ---- 10. solve-rt: the solve and selected inversion at 9-15 ------------
    clock("solve-rt")
    run_solve_rt_phase(dev, rows, captured, capture, check_kernel, grad_bar,
                       pt)

    # ---- 11. sweep-rt: kernel 1 at 9-15 and the paths it opens --------------
    clock("sweep-rt")
    run_sweep_rt_phase(dev, rows, captured, capture, check_kernel, grad_bar,
                       pt, celerite, ts_c, xs_c)

    # ---- 12. summary -------------------------------------------------------
    clock("summary")
    say(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--tn" in sys.argv[1:]:
        import argparse

        ap = argparse.ArgumentParser(description=tn_main.__doc__)
        ap.add_argument("--tn", action="store_true", required=True)
        ap.add_argument("--root", default=None,
                        help="checkout whose cyclic_gps_tpu_torch to time")
        ap.add_argument("--label", default="", help="tag of every line")
        a = ap.parse_args()
        tn_main(a.root, a.label)
    elif "--sweeps" in sys.argv[1:]:
        import argparse

        ap = argparse.ArgumentParser(description=sweeps_main.__doc__)
        ap.add_argument("--sweeps", action="store_true", required=True)
        ap.add_argument("--root", default=None,
                        help="checkout whose cyclic_gps_tpu_torch to time")
        ap.add_argument("--label", default="", help="tag of every line")
        a = ap.parse_args()
        sweeps_main(a.root, a.label)
    else:
        main()
