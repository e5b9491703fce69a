"""PyTorch port vs the JAX package at the edge shapes of the two Takahashi
walks: the shortest chunk they take (s = 3) on a chunk count that is not a
multiple of the walks' 8-lane tiles.

On the card the selected inversion's recursion (``csrc/rt_inverse.cu``,
kernel 20') and the solve's fused back-substitution and recursion
(``csrc/wide_backward.cu``, kernel 22) run one warp per chunk lane, 8
lanes per thread block at float32 and 4 at float64, so C = 23 and 25 end
in a ragged tile; s = 3 gives 20' one recursion row and 22 two.  Here
"cuda" routes resolve every backend but "torch" to "cuda" on CPU tensors,
so the engine's glue around both walks runs with their plain twins, and
``chip_smoke.py``'s ``[solve-rt]`` and ``[wide]`` phases hold the kernels
against the same twins on the card at these shapes.

Each case traces one float64 JAX reference of the plain XLA route,
computed once per test run and shared between the xdist workers
(tests/torch_reference_cache.py).  The JAX trace grows with d (its small
blocks are unrolled element by element): at d = 9 it takes the value, the
gradient and the selected inverse (~10 s to trace); at d = 15 the value
and the selected inverse, and the gradient there is held against the
port's own plain route (backend="torch"), itself held against JAX at
d = 9 and 12 (tests/test_torch_wide.py, tests/test_torch_solve_rt.py).
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda, wide_cuda
from test_torch_solve_rt import (_close, _port_solve, _reference,
                                 _to_cuda_route)
from test_torch_wide import _nat_system

torch.set_num_threads(1)

_S = 3  # one Takahashi row for 20', two rows for 22

# (d, N, gradient from JAX): C = ceil(N / 3) chunks, neither a multiple
# of 8; N = 68 pads the last chunk
_CASES = [(9, 68, True), (15, 75, False)]


@pytest.mark.parametrize("d,n,jax_grad", _CASES)
def test_walks_at_s3_ragged_tiles_match_jax(d, n, jax_grad, monkeypatch):
    """inverse_blocks and solve_and_logdet with the gradient of
    sum(x w) + 0.7 log|J| at s = 3 on the forced "cuda" route, float64,
    against the JAX XLA route: values rtol 1e-10, gradient rtol 1e-8 /
    atol 1e-10 (diag cotangents symmetrised), the bars of
    tests/test_torch_solve_rt.py; without ``jax_grad`` the gradient is
    held at the same bars against the port's plain route.  Spies: the top
    level hands the Takahashi recursion stacks [2, d, d, C] and the fused
    descending pass wide stacks [2, 8, 8, C] / [2, 3e, 8, C]."""
    c = -(-n // _S)
    e = d - 8
    (x_ref, ld_ref), (sd_ref, so_ref), g_ref = _reference(d, n, _S, 0.0,
                                                          jax_grad)
    system = _nat_system(n, d, seed=d)
    if not jax_grad:
        _, g_ref = _port_solve(system, _S, 0.0, torch.float64, grad=True)
    _to_cuda_route(monkeypatch)
    shapes = []  # (wrapper, its first two inputs' shapes) per call
    for module, name in ((sweep_cuda, "takahashi_backward_cuda"),
                         (wide_cuda, "backward_solve_takahashi_wide_cuda")):
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _f=fn, _n=name, **k: shapes.append(
                (_n, tuple(a[0].shape), tuple(a[1].shape))) or _f(*a, **k))

    (x, ld), g = _port_solve(system, _S, 0.0, torch.float64, grad=True)
    _close(x, x_ref, 1e-10)
    _close(ld, ld_ref, 1e-10)
    sym = np.asarray(g_ref[0])
    sym = 0.5 * (sym + sym.transpose(0, 2, 1))  # _port_solve's is already
    for name, a, b in zip(("diag", "off", "y"), g, (sym, *g_ref[1:])):
        _close(a, b, 1e-8, 1e-10, err_msg=name)
    sd, so = pt.inverse_blocks(
        *[torch.tensor(a, dtype=torch.float64) for a in system[:2]], s=_S)
    _close(sd, sd_ref, 1e-10, err_msg="diag")
    _close(so, so_ref, 1e-10, err_msg="off")

    assert shapes == [
        ("backward_solve_takahashi_wide_cuda", (_S - 1, 8, 8, c),
         (_S - 1, 3 * e, 8, c)),
        ("takahashi_backward_cuda", (_S - 1, d, d, c), (_S - 1, d, c))]
