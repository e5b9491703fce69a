"""Build and load the package's CUDA kernels.

The sources in ``cyclic_gps_tpu_torch/csrc`` have a plain C interface, so
they are compiled by ``nvcc`` straight into one shared library (no PyTorch
headers: seconds to build, not minutes) and loaded with ``ctypes``.  The
library is keyed by a hash of the sources and flags and built at first
use under ``build/`` at the repository root; the ``.cu`` files compile in
parallel, one ``nvcc`` each, and are linked together.  The compiler's
register, stack and spill report (``-Xptxas -v``) is kept beside the
library (`ptxas_report`).

Nothing here runs at import time: the CPU-only test machine imports every
module without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_SOURCES = ("forward_sweep.cu", "gap_emission.cu", "backward_sweep.cu",
            "gap_adjoint.cu", "solve_sweep.cu", "inverse_sweep.cu",
            "celerite_sweep.cu", "celerite_filter.cu",
            "celerite_adjoint.cu", "wide_sweep.cu", "wide_backward.cu",
            "rt_solve.cu", "rt_inverse.cu")
_HEADERS = ("blockmath.cuh", "celerite.cuh", "rtcoop.cuh", "gapsmem.cuh",
            "pipeline.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# threads per block of the thread-per-lane kernels (CGT_THREADS); the
# warp-per-lane kernels (csrc/rtcoop.cuh's tiles) take 32 per chunk lane,
# 8 lanes a block at float32 and 4 at float64
THREADS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (every pointer and the stream
# as c_void_p, so none is cut to 32 bits)
_SIGNATURES = {
    "cgt_forward_sweep_f32": [_P, _P, _P, ctypes.c_float, _I, _I, _I]
    + [_P] * 9 + [_P],
    "cgt_forward_sweep_f64": [_P, _P, _P, ctypes.c_double, _I, _I, _I]
    + [_P] * 9 + [_P],
    "cgt_transition_and_noise_f32": [_P, _P, _I, _I, _P, _P, _P],
    "cgt_transition_and_noise_rows_f32": [_P, _P, _I, _I, _P, _P, _P],
    "cgt_k_system_f32": [_P] * 6 + [_I, _I, _I] + [_P] * 3 + [_P],
    "cgt_gap_mahal_sweep_f32": [_P] * 7 + [_I, _I, _I] + [_P] * 11 + [_P],
    "cgt_forward_sweep_solveinv_f32": [_P, _P, _P, ctypes.c_float, _I, _I,
                                       _I] + [_P] * 13 + [_P],
    "cgt_forward_sweep_solveinv_f64": [_P, _P, _P, ctypes.c_double, _I, _I,
                                       _I] + [_P] * 13 + [_P],
    "cgt_backward_solve_takahashi_f32": [_P] * 11 + [_I, _I, _I] + [_P] * 5
    + [_P],
    "cgt_backward_solve_takahashi_f64": [_P] * 11 + [_I, _I, _I] + [_P] * 5
    + [_P],
    "cgt_k_system_adjoint_f32": [_P] * 7 + [_I, _I, _I] + [_P] * 3 + [_P],
    "cgt_forward_sweep_collect_f32": [_P, _P, _P, ctypes.c_float, _I, _I,
                                      _I] + [_P] * 12 + [_P],
    "cgt_forward_sweep_collect_f64": [_P, _P, _P, ctypes.c_double, _I, _I,
                                      _I] + [_P] * 12 + [_P],
    "cgt_backward_substitute_f32": [_P] * 6 + [_I, _I, _I] + [_P] + [_P],
    "cgt_backward_substitute_f64": [_P] * 6 + [_I, _I, _I] + [_P] + [_P],
    "cgt_forward_sweep_inverse_f32": [_P, _P, ctypes.c_float, _I, _I, _I]
    + [_P] * 8 + [_P],
    "cgt_forward_sweep_inverse_f64": [_P, _P, ctypes.c_double, _I, _I, _I]
    + [_P] * 8 + [_P],
    "cgt_takahashi_backward_f32": [_P] * 11 + [_I, _I, _I] + [_P] * 4 + [_P],
    "cgt_takahashi_backward_f64": [_P] * 11 + [_I, _I, _I] + [_P] * 4 + [_P],
    "cgt_celerite_gap_mahal_sweep_f32": [_P] * 7 + [_I, _I, _I] + [_P] * 11
    + [_P],
    "cgt_celerite_filter_f32": [_P] * 7 + [_I, _I, _I, _I] + [_P] * 7
    + [_I] + [_P],
    "cgt_celerite_filter_collect_f32": [_P] * 7 + [_I, _I, _I, _I]
    + [_P] * 10 + [_I] + [_P],
    "cgt_celerite_filter_adjoint_f32": [_P] * 17 + [_I, _I, _I, _I]
    + [_P] * 5 + [_P],
}
# kernels 15's and 12's warp-per-lane designs at every nblocks (the
# routed entries take them at 5..8 only)
for _name in ("cgt_celerite_filter_adjoint", "cgt_celerite_gap_mahal_sweep"):
    _SIGNATURES[f"{_name}_warp_f32"] = _SIGNATURES[f"{_name}_f32"]
# the wide kernels, float32 and float64 (outputs, then the stream)
_SIGNATURES.update({
    name + suf: argtypes
    for suf, real in (("_f32", ctypes.c_float), ("_f64", ctypes.c_double))
    for name, argtypes in (
        ("cgt_wide_sweep", [_P] * 5 + [real, _I, _I, _I] + [_P] * 11 + [_P]),
        ("cgt_wide_sweep_solveinv",
         [_P] * 5 + [real, _I, _I, _I] + [_P] * 18 + [_P]),
        ("cgt_wide_backward", [_P] * 19 + [_I, _I, _I] + [_P] * 9 + [_P]))
})
# the dynamic shared bytes per thread block of the eight warp-per-lane
# kernels of block sizes 9-15 (rt_inverse.cu's sweep and recursion and
# rt_solve.cu's two sweeps and back-substitution at block size d,
# wide_backward.cu's and wide_sweep.cu's two sweeps at 8 + e; the second
# argument 1 for float64), of the celerite filter adjoint at nblocks and
# obs_dim, of the celerite likelihood sweep at nblocks, of the celerite
# collecting filter and filter sweep at nblocks and obs_dim, and of
# kernels 1, 6 and 7 at block size 16 (forward_sweep.cu's
# and backward_sweep.cu's warp-per-lane sweeps and walk), and of the split
# designs of kernels 7, 9 and 11 at ranks 1..8, and of kernels 6 and 8
# there (one layout), with the thread blocks an SM holds of each
_SIGNATURES.update({name: [_I, _I] for name in (
    "cgt_rt_takahashi_smem_bytes", "cgt_wide_backward_smem_bytes",
    "cgt_rt_collect_smem_bytes", "cgt_rt_backsub_smem_bytes",
    "cgt_wide_solveinv_smem_bytes",
    "cgt_wide_sweep_smem_bytes", "cgt_rt_sweep_smem_bytes",
    "cgt_rt_inverse_sweep_smem_bytes", "cgt_celerite_adjoint_smem_bytes",
    "cgt_celerite_collect_smem_bytes", "cgt_celerite_filter_smem_bytes",
    "cgt_forward_sweep_warp_smem_bytes",
    "cgt_solveinv_warp_smem_bytes", "cgt_backsolve_warp_smem_bytes",
    "cgt_backsolve_split_smem_bytes", "cgt_backsub_split_smem_bytes",
    "cgt_takahashi_split_smem_bytes", "cgt_elim_split_smem_bytes",
    "cgt_collect_split_blocks_per_sm", "cgt_solveinv_split_blocks_per_sm",
    "cgt_sweep_split_blocks_per_sm", "cgt_inverse_split_smem_bytes",
    "cgt_inverse_split_blocks_per_sm")})
_SIGNATURES["cgt_celerite_sweep_smem_bytes"] = [_I]
# the dynamic shared bytes per thread block of the K-system emission
# (kernel 3), the fused emission sweep (kernel 4) and the emission adjoint
# (kernel 5) at rank r
for _name in ("cgt_k_system_smem_bytes", "cgt_gap_mahal_sweep_smem_bytes",
              "cgt_k_system_adjoint_smem_bytes"):
    _SIGNATURES[_name] = [_I]
# the runtime-d kernels of the likelihood's sweep, the solve and the
# selected inversion (d = 9..15) take the arguments of their
# rank-templated counterparts
for _base in ("forward_sweep", "forward_sweep_collect",
              "backward_substitute", "forward_sweep_inverse",
              "takahashi_backward"):
    for _suf in ("_f32", "_f64"):
        _SIGNATURES[f"cgt_rt_{_base}{_suf}"] = _SIGNATURES[
            f"cgt_{_base}{_suf}"]
# and so do the thread-per-lane instances of the four elimination sweeps
# (float64, THREAD_RANKS below)
for _base in ("forward_sweep", "forward_sweep_solveinv",
              "forward_sweep_collect", "forward_sweep_inverse"):
    _SIGNATURES[f"cgt_{_base}_thread_f64"] = _SIGNATURES[f"cgt_{_base}_f64"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in _HEADERS + _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libcgt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, Optional[float]]:
    """Build the library if it is missing.  Returns (path, build seconds,
    or None when an earlier build was found)."""
    so = library_path()
    if so.exists():
        return so, None
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _SOURCES:
        obj = _BUILD_DIR / f"{Path(src).stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    errors, logs = [], []
    for src, proc in zip(_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    so.with_suffix(".log").write_text("".join(logs))
    tmp = so.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial
    return so, time.perf_counter() - t0


def ptxas_report(rank: int, tag: Optional[str] = None):
    """{function (mangled name): [registers, stack bytes, spill store
    bytes]} for the kernels and non-inlined device functions instantiated
    at block size ``rank`` (or whose mangled name holds ``tag``), from the
    compiler's report of the current build (registers are None for a
    device function)."""
    log = library_path().with_suffix(".log")
    report, props, entry = {}, None, None
    tag = tag or f"Li{rank}E"
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "bytes stack frame" in line and props and tag in props:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            report[props] = [None, nums[0], nums[1]]
        elif "Used" in line and "registers" in line and entry in report:
            report[entry][0] = int(line.split("Used")[1].split()[0])
    return report


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with argtypes set."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Checks shared by the kernel wrappers (ops/sweep_cuda.py, ops/expm_cuda.py).
# ---------------------------------------------------------------------------

# Block sizes each kernel is instantiated for: every kernel takes 1..8
# (one thread per chunk lane); the engine's forward sweep and its two
# backward kernels (Queue 2 items 1, 6 and 7) also take 16, the boundary
# chain of the celerite family at nblocks = 8, one warp per chunk lane
# there; the forward sweep (item 1) and the solve and selected-inversion
# kernels (items 8-11) also take 9..15, through one runtime-d instance per
# dtype (rt_solve.cu's likelihood sweep and items 17-20).
RANKS = tuple(range(1, 9))
SWEEP_RANKS = RANKS + (16,)
SOLVE_RANKS = RANKS + tuple(range(9, 16))
FORWARD_RANKS = SWEEP_RANKS + tuple(range(9, 16))


# The float64 ranks at which the four elimination sweeps (kernels 1, 6, 8
# and 10) also have a thread-per-lane kernel beside csrc/pipeline.cuh's
# split one (sweep_cuda.THREAD_F64 says where each runs).
THREAD_RANKS = (7, 8)


def runtime_d(r: int) -> bool:
    """Whether block size ``r`` takes a runtime-d instance (9..15)."""
    return 8 < r < 16


def check_rank(r: int, name: str, sizes=RANKS) -> None:
    """Refuse a block size the kernel was not instantiated for."""
    if r not in sizes:
        have = ("1..8" + (", 9..15" if 9 in sizes else "")
                + (", 16" if 16 in sizes else ""))
        raise ValueError(
            f"{name}: block size {r} has no CUDA kernel (instantiated for "
            f"{have}); at sizes 9-15 the card runs the likelihood's "
            "forward sweep, the solve and the selected inversion "
            "(runtime-d instances, csrc/rt_solve.cu and csrc/rt_inverse.cu) "
            "and the natural-layout mahal_and_logdet with its gradient (the "
            "wide-layout kernels, ops/wide_cuda.py); the likelihood's "
            "backward pair and the emission kernels at 9-15, and rank 16 of "
            "the emission, solve and selected-inversion kernels, wait for "
            "their own instantiation (ROADMAP.md, Queue 2)")


def check_no_grad(name: str, *tensors) -> None:
    """Refuse a raw kernel call that autograd would have to look through.

    A kernel writes into fresh tensors through ctypes, so its outputs carry
    no ``grad_fn``: under grad mode a gradient would silently flow only
    through the tensor glue around it.  The differentiable entry points
    (``leg.log_likelihood``, ``partitioned.mahal_and_logdet_cm``) call the
    kernels inside ``torch.autograd.Function``s, whose ``forward`` runs
    with grad mode off.  Checked before the CPU/CUDA branch, so the plain
    twins a CPU tensor runs obey the same contract."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel's outputs "
            "carry no grad_fn; call it under torch.no_grad() or through "
            "the differentiable entry points")


def check_tensors(name: str, dtypes, **tensors) -> None:
    """Every tensor on one CUDA device, of one allowed dtype, contiguous."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name}: {key} must be on {first.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype not in dtypes or t.dtype != first.dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}; expected "
                             f"one of {dtypes}, all alike")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_shape(name: str, key: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
