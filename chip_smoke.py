#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (cyclic_gps_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line of output each (or more):
  1. device   the card's name and power limit; TF32 off for the model math.
  2. build    nvcc builds the package's CUDA kernels from csrc/.
  3. kernels  each kernel against its plain PyTorch twin on the card, at
              the slice's shapes (LEG rank 5, N = 1e6 irregular gaps,
              s = 128, C = 7,813), with the error against its tolerance
              and the median CUDA-event time of kernel and twin.
  4. path     the likelihood through the user entry points with
              backend="auto" (the kernels), launch counts reset just
              before and read just after, then each value against
              backend="torch" (plain tensor code on the same card) and a
              small case against the dense float64 oracle.
  5. a JSON line of the kernels, then the final JSON status line.

Any failure exits non-zero before the final line.  There is no CPU path:
without a CUDA device, or without the package beside this script, it
fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

N_BIG = 1_000_000
N_SMALL = 48
RANK, OBS = 5, 2
REPS = 7  # timed runs per kernel / twin (median reported)


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


def compare(label, got, ref, rtol, atol):
    """allclose-style check of every output pair; returns the largest
    absolute difference.  Fails on a non-finite value or a mismatch."""
    worst_abs = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        a = a.detach().double()
        b = b.detach().double()
        if a.shape != b.shape:
            fail(f"{label} output {i}: shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label} output {i}: non-finite values")
        diff = (a - b).abs()
        ratio = float((diff / (atol + rtol * b.abs())).max())
        max_abs = float(diff.max())
        worst_abs = max(worst_abs, max_abs)
        ok = ratio <= 1.0
        say(f"  {label} out[{i}] {tuple(a.shape)}: max_abs={max_abs:.3e} "
            f"max|ref|={float(b.abs().max()):.3e} "
            f"err/tol={ratio:.3e} (rtol={rtol:g}, atol={atol:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label} output {i} disagrees with its plain twin")
    return worst_abs


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

    rows = []

    def check_kernel(key, source, replaces, kernel, twin, args, rtol, atol,
                     why):
        with torch.no_grad():
            got = kernel(*args)
            torch.cuda.synchronize()
            ref = twin(*args)
            err = compare(key, got, ref, rtol, atol)
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: twin(*args))
        say(f"[kernels] {key}: max_abs_err={err:.3e} ({why}); "
            f"kernel {ms:.3f} ms, plain twin {plain_ms:.3f} ms")
        rows.append({"name": key, "route": "cuda", "source": source,
                     "replaces": replaces, "kernel": kernel,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        return got

    check_kernel(
        "transition_and_noise",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:297",
        expm_cuda.transition_and_noise_cuda,
        expm_cuda.transition_and_noise_plain, (g, gaps), 1e-4, 1e-6,
        "same float32 Pade-7 algorithm; differs by FMA contraction and "
        "rsqrt/log rounding")
    k_sys = check_kernel(
        "k_system",
        "cyclic_gps_tpu_torch/csrc/gap_emission.cu",
        "cyclic_gps_tpu/ops/expm_pallas.py:530",
        expm_cuda.k_system_cuda, expm_cuda.k_system_plain,
        (g, boost, diffs, gv, real, wrap), 1e-3, 1e-4,
        "K ~ Q1^{-1} amplifies (e, Q1) rounding by cond(Q1) for small gaps; "
        "the JAX kernel-vs-XLA bar")
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
        "kernels 3 and 1 fused: the same rounding sources")

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
    kernels = [r["kernel"] for r in rows]
    for k in kernels:
        k.launches = 0
    auto_vals = []
    with torch.no_grad():
        auto_vals.append(fn(p_e, ts_e, xs_e))
        for label, call, _, _ in cases[1:]:
            auto_vals.append(call("auto"))
        torch.cuda.synchronize()
    launches = {r["name"]: r["kernel"].launches for r in rows}
    say(f"[path] launches in the backend='auto' main-path run: {launches}")
    for r in rows:
        r["launches"] = r["kernel"].launches
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched by the main path")

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

    # ---- 5. summary --------------------------------------------------------
    say(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms")}
        for r in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
