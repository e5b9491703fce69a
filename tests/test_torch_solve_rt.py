"""PyTorch port vs the JAX package: the natural solve and the selected
inversion at block sizes 9-15.

On the card these entries run the runtime-d instances of the solve and
selected-inversion kernels (``csrc/rt_solve.cu``, ``csrc/rt_inverse.cu``)
at every chunked ladder level, and the solve's analytic backward runs the
wide-layout kernels 21 and 22 (`partitioned._solve_inverse_from_cm`'s wide
branch).  Here "cuda" routes resolve every backend but "torch" to "cuda"
on CPU tensors, so the glue runs with each kernel's plain twin.

Inputs are tests/test_torch_wide.py's seeded, float32-representable
system, so one float64 JAX reference of the plain XLA route
(tests/test_wideblock.py holds it equal to the wide Pallas kernels) serves
the float64 and the float32 comparisons.  Each reference is computed once
per test run and shared between the xdist workers
(tests/torch_reference_cache.py); the file traces two JAX functions (a
trace and a cache load take 10-20 s each), and its deeper ladder case is
held against the port's own plain route instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.ops import partitioned as jpt
from cyclic_gps_tpu_torch.ops import _build
from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda, wide_cuda
from test_torch_wide import _nat_system
from torch_reference_cache import shared

torch.set_num_threads(1)

# the gradient's seeded weights: loss = sum(x * w) + 0.7 log|J|
_LD_WEIGHT = 0.7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _weights(n, d):
    return np.float32(np.random.RandomState(11).randn(n, d)).astype(
        np.float64)


def _to_cuda_route(monkeypatch):
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")


def _spy(monkeypatch, seen, module, names):
    """Record (wrapper, chunk count) of every call of the named wrappers
    in ``seen`` (the routes look them up on the module at each call)."""
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _f=fn, _n=name, **k: seen.append(
                (_n, a[0].shape[-1])) or _f(*a, **k))


@functools.lru_cache(maxsize=None)
def _jax_reference_fn(s, jitter, grad):
    """jit of the JAX XLA route, float64: ((x, ld), (sig_diag, sig_off))
    of solve_and_logdet and inverse_blocks; with ``grad`` also the
    gradient of sum(x w) + 0.7 ld in (diag, off, y)."""
    def loss(diag, off, y, w):
        x, ld = jpt.solve_and_logdet(diag, off, y, s=s, jitter=jitter,
                                     backend="xla")
        return jnp.sum(x * w) + _LD_WEIGHT * ld, (x, ld)

    def f(diag, off, y, w):
        inv = jpt.inverse_blocks(diag, off, s=s, jitter=jitter,
                                 backend="xla")
        if not grad:
            return loss(diag, off, y, w)[1], inv, None
        (_, sol), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(diag, off, y, w)
        return sol, inv, g

    return jax.jit(f)


def _reference(d, n, s, jitter, grad):
    """((x, ld), (sig_diag, sig_off), grads | None) of the JAX XLA route on
    `_nat_system(n, d, seed=d)`, once per run."""
    system = _nat_system(n, d, seed=d)
    return shared(f"solve_rt_{d}_{n}_{s}_{jitter}_{grad}",
                  lambda: _jax_reference_fn(s, jitter, grad)(
                      *map(jnp.asarray, system + (_weights(n, d),))))


def _port_solve(system, s, jitter, dtype, grad=False):
    """The port's natural solve_and_logdet on the inputs cast to
    ``dtype``; with ``grad`` also the gradient of sum(x w) + 0.7 ld (diag
    symmetrised)."""
    ts = [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in system]
    x, ld = pt.solve_and_logdet(*ts, s=s, jitter=jitter)
    if not grad:
        return (x, ld), None
    w = torch.tensor(_weights(*x.shape), dtype=dtype)
    g = torch.autograd.grad(torch.sum(x * w) + _LD_WEIGHT * ld, ts)
    return (x, ld), (0.5 * (g[0] + g[0].transpose(1, 2)), g[1], g[2])


_CASES = [
    (9, 96, 0.0),     # clean chunking; with the gradient
    (12, 90, 1e-3),   # chunk-pad tail + jitter path
]


@pytest.mark.parametrize("d,n,jitter", _CASES)
def test_natural_solve_and_inverse_match_jax(d, n, jitter, monkeypatch):
    """On the forced "cuda" route (the kernels' twins at the top level,
    s = 8), against the JAX XLA route; the cases are those of
    tests/test_wideblock.py:test_wide_solve_matches_xla and
    test_wide_inverse_matches_xla, with their float32 bars.

    solve_and_logdet: rtol 1e-10 at float64; x rtol 2e-4 / atol 2e-5 and
    ld rtol 2e-5 at float32.  At d = 9 also the analytic gradient of
    sum(x w) + 0.7 ld (rtol 1e-8, atol 1e-10: test_wide_solve_gradient's
    bars), the diag cotangents symmetrised; its backward runs the wide
    solve + selected inversion (kernels 21 and 22's twins), never the
    plain pair.  inverse_blocks (the raw-factor sweep and Takahashi
    twins): rtol 1e-10 at float64, rtol 2e-4 / atol 2e-6 at float32."""
    grad = d == 9
    (x_ref, ld_ref), (sd_ref, so_ref), g_ref = _reference(d, n, 8, jitter,
                                                          grad)
    system = _nat_system(n, d, seed=d)
    _to_cuda_route(monkeypatch)
    seen = []
    _spy(monkeypatch, seen, sweep_cuda,
         ("forward_sweep_collect_cuda", "backward_substitute_cuda",
          "forward_sweep_solveinv_cuda", "forward_sweep_inverse_cuda",
          "takahashi_backward_cuda"))
    _spy(monkeypatch, seen, wide_cuda, ("forward_sweep_solveinv_wide_cuda",))
    (x, ld), g = _port_solve(system, 8, jitter, torch.float64, grad)
    _close(x, x_ref, 1e-10)
    _close(ld, ld_ref, 1e-10)
    if grad:
        sym = np.asarray(g_ref[0])
        sym = 0.5 * (sym + sym.transpose(0, 2, 1))
        for name, a, b in zip(("diag", "off", "y"), g, (sym, *g_ref[1:])):
            _close(a, b, 1e-8, 1e-10, err_msg=name)
    (x, ld), _ = _port_solve(system, 8, jitter, torch.float32)
    assert x.dtype == torch.float32
    _close(x, x_ref, 2e-4, 2e-5)
    _close(ld, ld_ref, 2e-5)
    for dtype, rtol, atol in ((torch.float64, 1e-10, 0.0),
                              (torch.float32, 2e-4, 2e-6)):
        sd, so = pt.inverse_blocks(
            *[torch.tensor(a, dtype=dtype) for a in system[:2]], s=8,
            jitter=jitter)
        assert sd.dtype == dtype
        _close(sd, sd_ref, rtol, atol, err_msg=f"{dtype} diag")
        _close(so, so_ref, rtol, atol, err_msg=f"{dtype} off")
    c = -(-n // 8)
    solve = [("forward_sweep_collect_cuda", c),
             ("backward_substitute_cuda", c)]
    inverse = [("forward_sweep_inverse_cuda", c),
               ("takahashi_backward_cuda", c)]
    assert seen == (solve + [("forward_sweep_solveinv_wide_cuda", c)] * grad
                    + solve + inverse * 2)


# d = 13, n = 2,112 with the default chunk length (s = 32): the top level
# (C = 66) and the reduced ladder's first level (66 blocks, C = 3) both
# take the kernels' routes
_LADDER = (13, 2112, (66, 3))


def test_natural_solve_ladder_levels(monkeypatch):
    """At both ladder levels the solve runs the collect and
    back-substitution wrappers and its backward the wide solve + selected
    inversion.  Values and gradient == the port's plain route
    (backend="torch", held against the JAX package at d = 3-8 and, above,
    at 9 and 12), float64: rtol 1e-10 on values, rtol 1e-8 / atol 1e-10
    on the gradient."""
    d, n, levels = _LADDER
    system = _nat_system(n, d, seed=d)
    (x_p, ld_p), g_p = _port_solve(system, None, 0.0, torch.float64,
                                   grad=True)
    _to_cuda_route(monkeypatch)
    seen = []
    _spy(monkeypatch, seen, sweep_cuda,
         ("forward_sweep_collect_cuda", "backward_substitute_cuda"))
    _spy(monkeypatch, seen, wide_cuda, ("forward_sweep_solveinv_wide_cuda",))
    (x, ld), g = _port_solve(system, None, 0.0, torch.float64, grad=True)
    _close(x, x_p, 1e-10)
    _close(ld, ld_p, 1e-10)
    for name, a, b in zip(("diag", "off", "y"), g, g_p):
        _close(a, b, 1e-8, 1e-10, err_msg=name)
    assert seen == (
        [("forward_sweep_collect_cuda", c) for c in levels]
        + [("backward_substitute_cuda", c) for c in levels[::-1]]
        + [("forward_sweep_solveinv_wide_cuda", c) for c in levels])


def test_inverse_blocks_ladder_levels(monkeypatch):
    """At both ladder levels inverse_blocks runs the raw-factor sweep and
    Takahashi wrappers; its blocks == the port's plain route at float64
    (rtol 1e-8, atol 1e-10)."""
    d, n, levels = _LADDER
    diag, off = map(torch.as_tensor, _nat_system(n, d, seed=d)[:2])
    ref = pt.inverse_blocks(diag, off)
    _to_cuda_route(monkeypatch)
    seen = []
    _spy(monkeypatch, seen, sweep_cuda, ("forward_sweep_inverse_cuda",
                                         "takahashi_backward_cuda"))
    for name, a, b in zip(("sig_diag", "sig_off"),
                          pt.inverse_blocks(diag, off), ref):
        _close(a, b, 1e-8, 1e-10, err_msg=name)
    assert seen == ([("forward_sweep_inverse_cuda", c) for c in levels]
                    + [("takahashi_backward_cuda", c) for c in levels[::-1]])


def test_solve_ranks_guard():
    """The solve and selected-inversion wrappers' sizes: 1..15 are
    accepted, 16 and 17 refused with a ValueError naming the ROADMAP
    queue; the likelihood's sizes are unchanged."""
    for r in range(1, 16):
        _build.check_rank(r, "forward_sweep_collect_cuda",
                          _build.SOLVE_RANKS)
    for r in (16, 17):
        with pytest.raises(ValueError, match="ROADMAP"):
            _build.check_rank(r, "forward_sweep_collect_cuda",
                              _build.SOLVE_RANKS)
    assert _build.RANKS == tuple(range(1, 9))
    assert _build.SWEEP_RANKS == _build.RANKS + (16,)


def test_runtime_d_launch_entries():
    """At block sizes 9..15 the four wrappers call the runtime-d C entries
    and count them on ``launches_rt``; at 1..8 the rank-templated ones on
    ``launches``."""
    wrappers = (sweep_cuda.forward_sweep_collect_cuda,
                sweep_cuda.backward_substitute_cuda,
                sweep_cuda.forward_sweep_inverse_cuda,
                sweep_cuda.takahashi_backward_cuda)
    for d, prefix in ((5, "cgt_"), (9, "cgt_rt_"), (15, "cgt_rt_")):
        assert sweep_cuda._solve_symbol("backward_substitute", d) == (
            prefix + "backward_substitute")
    for w in wrappers:
        before = (w.launches, w.launches_rt)
        sweep_cuda._count_solve(w, 12)
        sweep_cuda._count_solve(w, 8)
        assert (w.launches, w.launches_rt) == (before[0] + 1,
                                               before[1] + 1)
        w.launches, w.launches_rt = before
    for base in ("forward_sweep_collect", "backward_substitute",
                 "forward_sweep_inverse", "takahashi_backward"):
        for suf in ("_f32", "_f64"):
            assert (_build._SIGNATURES[f"cgt_rt_{base}{suf}"]
                    == _build._SIGNATURES[f"cgt_{base}{suf}"])
