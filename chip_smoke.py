#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (cyclic_gps_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line of output each (or more):
  1. device   the card's name and power limit; TF32 off for the model math.
  2. build    nvcc builds the package's CUDA kernels from csrc/; the
              compiler's registers / stack / spills at rank 5.
  3. kernels  each kernel against its plain PyTorch twin on the card, at
              the main path's shapes (LEG rank 5, N = 1e6 irregular gaps,
              s = 128, C = 7,813), with the error against its tolerance,
              the median CUDA-event time of kernel and twin, and the
              card's least time for the same work (its bound).  The three
              backward kernels get the inputs the two-kernel route's
              backward hands them.
  4. path     the likelihood through the user entry points with
              backend="auto" (the kernels), launch counts reset just
              before and read just after, then each value against
              backend="torch" (plain tensor code on the same card) and a
              small case against the dense float64 oracle.
  5. grad     the likelihood gradient on every route, backend="auto"
              against backend="torch" on the card, and a float64 small
              case against autograd through the dense oracle.
  6. train    three Adam train steps on the fused N = 1e6 route, launch
              counts reset just before and read just after; then one
              step under torch.profiler.
  7. a JSON line of the kernels, then the final JSON status line.

Any failure exits non-zero before the final line.  There is no CPU path:
without a CUDA device, or without the package beside this script, it
fails.
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
REPS = 7  # timed runs per kernel / twin (median reported)
TRAIN_STEPS = 3
# published peaks of one H100 SXM (the bound's denominators)
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS):
    """Median CUDA-event time of fn() in ms, after one warm-up run."""
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
        ratio = float((diff / (tol + rtol * b.abs())).max())
        max_abs = float(diff.max())
        worst_abs = max(worst_abs, max_abs)
        ok = ratio <= 1.0
        say(f"  {label} out[{i}] {tuple(a.shape)}: max_abs={max_abs:.3e} "
            f"max|ref|={float(b.abs().max()):.3e} "
            f"err/tol={ratio:.3e} (rtol={rtol:g}, atol={tol:.3g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label} output {i} disagrees with its plain twin")
    return worst_abs


# ---------------------------------------------------------------------------
# The card's least time for each kernel's work: max(bytes / memory rate,
# float32 operations / peak rate).  Bytes: every input read once, every
# output written once.  Operations: counted from each kernel's code, with
# an R x R product as 2 R^3 and the data-dependent squaring rounds of the
# gap emission counted per gap from this run's gaps.
# ---------------------------------------------------------------------------


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _rounds(g, dt):
    """(squaring rounds per gap, Van Loan-regime mask): the scaling rule
    of csrc/blockmath.cuh tn_math, on this run's gaps."""
    from cyclic_gps_tpu_torch.ops import expm_cuda

    _, half, augn = expm_cuda._generator_norms(g.double())
    dt = dt.double()
    nsq = torch.clamp(torch.ceil(torch.log2(torch.clamp(
        dt * augn / expm_cuda._THETA7, min=1.0))), 0, expm_cuda._MAXSQ)
    return nsq, dt * half < 1.0


def _tn_flops(g, dt):
    """Operations of the per-gap (e, Q1) forward: the structured Pade-7
    (13 products, LU solves with R and 2R right-hand sides), the
    squaring rounds (4 products in the Van Loan regime, else 1) and Q."""
    r = g.shape[0]
    nsq, small = _rounds(g, dt)
    per_round = torch.where(small, 8.0, 2.0) * r ** 3
    pade = (26 + 2 / 3 + 2 + 2 / 3 + 4) * r ** 3
    return float(dt.numel() * (pade + 2 * r ** 3) + (nsq * per_round).sum())


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


def bound(kernel, args, outs, g=None, dt=None):
    """(least ms, "bytes" or "operations") for one kernel call."""
    nbytes = _nbytes(args) + _nbytes(outs)
    if kernel == "transition_and_noise":
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
    else:
        s, r, _, c = args[0].shape
        rows = (s - 1) * c if kernel != "backward_solve_takahashi" else s * c
        per_row = {"forward_sweep": _sweep_row_flops(r),
                   "forward_sweep_solveinv": _sweep_row_flops(r)
                   + 7 * r ** 3 + 2 * r ** 2,
                   "backward_solve_takahashi": 26 * r ** 3 + 4 * r ** 2}
        flops = rows * per_row[kernel]
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_inf(a, b):
    """||a - b||_inf / ||b||_inf."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cyclic_gps_tpu_torch.baselines import dense
    from cyclic_gps_tpu_torch.data.synthetic import generate_data
    from cyclic_gps_tpu_torch.entry import entry
    from cyclic_gps_tpu_torch.models import leg
    from cyclic_gps_tpu_torch.ops import _build, expm_cuda, sweep_cuda
    from cyclic_gps_tpu_torch.ops import partitioned as pt
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
        if base is None:
            continue
        kind = " (float64)" if base.group(2) == "d" else ""
        say(f"[build] rank {RANK} {base.group(1)}{kind}: registers {regs}, "
            f"stack {stack} B, spill stores {spill} B")

    # ---- 3. kernels vs plain twins at the slice's shapes -----------------
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
                     f64_outputs=()):
        """Kernel vs twin.  For the outputs in ``f64_outputs`` the
        absolute tolerance is 4x the twin's own float32 error against the
        twin run in float64 on the same inputs (for values that cancel
        terms far larger than themselves)."""
        kw = kw or {}
        with torch.no_grad():
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            ref = twin(*args, **kw)
            atols = {}
            if f64_outputs:
                ref64 = twin(*[a.double() if isinstance(a, torch.Tensor)
                               else a for a in args], **kw)
                for i in f64_outputs:
                    e_twin = float((ref[i].double() - ref64[i]).abs().max())
                    e_kern = float((got[i].double() - ref64[i]).abs().max())
                    atols[i] = 4.0 * e_twin
                    say(f"  {key} out[{i}] vs the float64 twin: kernel "
                        f"{e_kern:.3e}, float32 twin {e_twin:.3e}")
            err = compare(key, got, ref, rtol, atol, atol_of_scale, atols)
            ms = cuda_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: twin(*args, **kw))
        b_ms, b_by = bound(key, args, got, g, gaps_of)
        say(f"[kernels] {key}: max_abs_err={err:.3e} ({why}); "
            f"kernel {ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows.append({"name": key, "route": "cuda", "source": source,
                     "replaces": replaces, "kernel": kernel,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        return got

    check_kernel(
        "transition_and_noise",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:297",
        expm_cuda.transition_and_noise_cuda,
        expm_cuda.transition_and_noise_plain, (g, gaps), 1e-4, 1e-6,
        "same float32 Pade-7 algorithm; differs by FMA contraction and "
        "rsqrt/log rounding", gaps_of=gaps)
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
        "over 1e6 rows in another order")
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
        "pinv = P^{-1}; atol is 1e-4 of each output's scale",
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
    by_name = {r["name"]: r for r in rows}

    # ---- 4. the main path through the user entry points -------------------
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
    p_train = leg.init_params(RANK, OBS, generator=torch.Generator()
                              .manual_seed(0), device=dev)
    opt = loop.make_optimizer("adam", 1e-2)
    for r in rows:
        r["kernel"].launches = 0
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
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    say(f"[train] losses {losses}; step ms {[round(t, 2) for t in step_ms]}"
        f", median {statistics.median(step_ms):.2f} ms (host clock, "
        "synchronised; the first step includes warm-up)")

    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        """(wall ms with the profiler on, {device op name: (ms, calls)})
        of fn() under torch.profiler."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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

    wall, by_kernel = profiled(lambda: loop.train_step(p_train, opt, ts, xs))
    _, by_fwd = profiled(lambda: loop.nll_loss(p_train, ts, xs))
    if not by_kernel:
        say("[train] profiled step: the profiler saw no device events; "
            "device ops and busy share not measured")
    else:
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        fwd_ms = sum(ms for ms, _ in by_fwd.values())
        n_ops = sum(n for _, n in by_kernel.values())
        say(f"[train] profiled step: wall {wall:.2f} ms (profiler on), "
            f"{n_ops} device ops, device {dev_ms:.2f} ms, busy share "
            f"{dev_ms / wall:.3f}; the forward alone (loss with grad on) "
            f"{fwd_ms:.2f} ms of device time, "
            f"{sum(n for _, n in by_fwd.values())} device ops")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[
            :10]:
        say(f"[train]   {key[:80]}: {ms:.3f} ms, {n} calls")

    # ---- 7. summary --------------------------------------------------------
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
    main()
