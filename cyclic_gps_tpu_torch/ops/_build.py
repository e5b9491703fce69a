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
            "gap_adjoint.cu")
_HEADERS = ("blockmath.cuh",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

THREADS = 128  # threads per block of every kernel (CGT_THREADS)

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
}


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


def ptxas_report(rank: int):
    """{function (mangled name): [registers, stack bytes, spill store
    bytes]} for the kernels and non-inlined device functions instantiated
    at block size ``rank``, from the compiler's report of the current
    build (registers are None for a device function)."""
    log = library_path().with_suffix(".log")
    report, props, entry = {}, None, None
    tag = f"Li{rank}E"
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

MAX_RANK = 8  # the kernels are instantiated for block sizes 1..8


def check_rank(r: int, name: str) -> None:
    """Refuse a block size the kernels were not instantiated for."""
    if not 1 <= r <= MAX_RANK:
        raise ValueError(
            f"{name}: block size {r} has no CUDA kernel (instantiated for "
            f"1..{MAX_RANK}); sizes 9-16 wait for the wide-layout kernels "
            "(ROADMAP.md, Queue 2, wide layout)")


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
