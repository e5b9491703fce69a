"""PyTorch port vs the JAX package: the chunk-major (mahal, log-det) and
the per-row log-dets at block sizes 9-15.

On the card both entries run the likelihood's forward sweep at these
sizes through its runtime-d instance (``csrc/rt_solve.cu``'s
``rt_sweep_kernel``, counted on ``forward_sweep_cuda.launches_rt``) at
the top level; below it the (mahal, log-det) ladder takes the wide
route and the per-row log-dets the same sweep, and the gradients run the
solve + selected-inversion kernels.  Here the "torch"
route is held against the JAX package's XLA route at float64, and the
"cuda" route's glue runs with every wrapper's plain twin on CPU tensors.
The kernel itself against its twin runs only on a card (marked
``cuda``; skipped here).
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
from cyclic_gps_tpu_torch.ops import sweep_cuda
from test_torch_wide import _nat_system
from torch_reference_cache import shared

torch.set_num_threads(1)

# s = 4 and C = 70 chunks: the reduced boundary system (70 rows) takes one
# chunked level of its own before the terminal cyclic reduction
_S, _C = 4, 70
_ROW_WEIGHT = 0.7  # the per-row log-dets' cotangent (segment-constant)


def _chunked(d, dtype=torch.float64):
    """`_nat_system` at n = s C, chunk-major at s = 4 (R_cm, O_cm, y_cm)."""
    n = _S * _C
    diag, off, y = (torch.tensor(a, dtype=dtype)
                    for a in _nat_system(n, d, seed=30 + d))
    return pt._chunk_layout(diag, off, y, _S)[:3]


@functools.lru_cache(maxsize=None)
def _jax_fn():
    """jit of the JAX XLA route: (mh, ld, rows) and the gradient of
    0.3 mh + 0.7 ld + 0.7 sum(rows) in (R_cm, O_cm, y_cm)."""
    def loss(R, O, y):
        mh, ld = jpt.mahal_and_logdet_cm(R, O, y, backend="xla")
        rows = jpt.logdet_rows_cm(R, O, backend="xla")
        return (0.3 * mh + 0.7 * ld + _ROW_WEIGHT * jnp.sum(rows),
                (mh, ld, rows))

    def f(R, O, y):
        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(R, O, y)
        return out, g

    return jax.jit(f)


def _port(R, O, y):
    """The port's (mh, ld, rows) and the same gradient, on the backend
    ``resolve_backend`` picks."""
    leaves = [t.clone().requires_grad_() for t in (R, O, y)]
    mh, ld = pt.mahal_and_logdet_cm(*leaves)
    rows = pt.logdet_rows_cm(leaves[0], leaves[1])
    g = torch.autograd.grad(0.3 * mh + 0.7 * ld
                            + _ROW_WEIGHT * torch.sum(rows), leaves)
    return (mh.detach(), ld.detach(), rows.detach()), g


def _close(got, ref, rtol, atol_of_scale):
    for a, b in zip(got, ref):
        a, b = np.asarray(a.detach().numpy()), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol_of_scale * np.abs(b).max())


@pytest.mark.parametrize("d", [9, 12, 15])
def test_mahal_and_logdet_cm_and_rows_match_jax(d):
    """mahal_and_logdet_cm and logdet_rows_cm (backend "torch") at d = 9,
    12 and 15, s = 4, C = 70, float64: values, per-row log-dets and the
    gradient of 0.3 mh + 0.7 ld + 0.7 sum(rows) against the JAX package's
    XLA route (rtol 1e-10; gradients rtol 1e-9, atol 1e-12 of each
    input's scale: the same algorithm, sums in other orders)."""
    R, O, y = _chunked(d)
    ref_out, ref_g = shared(f"sweep_rt_{d}", lambda: _jax_fn()(
        *(jnp.asarray(t.numpy()) for t in (R, O, y))))
    out, g = _port(R, O, y)
    _close(out, ref_out, 1e-10, 0.0)
    _close(g, ref_g, 1e-9, 1e-12)


def test_cuda_route_glue(monkeypatch):
    """With every backend but "torch" resolved to "cuda" (the wrappers run
    their plain twins on CPU tensors), both entries at d = 12 call the
    likelihood's forward-sweep wrapper at the top level (C = 70) and the
    per-row log-dets also at their reduced system's chunked level (70
    rows at s = 32: C = 3; the (mahal, logdet) ladder takes the wide
    route there, as in the JAX package), and the results equal the
    "torch" route's to 1e-10 (values) and 1e-9 of each input's scale
    (gradients)."""
    R, O, y = _chunked(12)
    ref_out, ref_g = _port(R, O, y)
    monkeypatch.setattr(pt, "resolve_backend",
                        lambda b, t: "torch" if b == "torch" else "cuda")
    seen = []
    fn = sweep_cuda.forward_sweep_cuda
    monkeypatch.setattr(sweep_cuda, "forward_sweep_cuda",
                        lambda *a, **k: seen.append(a[0].shape[-1])
                        or fn(*a, **k))
    out, g = _port(R, O, y)
    assert set(seen) == {_C, 3}
    _close(out, ref_out, 1e-10, 0.0)
    _close(g, ref_g, 1e-9, 1e-9)


def test_forward_ranks():
    """The forward sweep's wrapper takes 1..16 (FORWARD_RANKS) and routes
    9..15 to the runtime-d entry, counted on ``launches_rt``; RANKS,
    SWEEP_RANKS and the runtime-d entry's argument types are those of the
    rank-templated kernel."""
    assert sorted(_build.FORWARD_RANKS) == list(range(1, 17))
    assert _build.RANKS == tuple(range(1, 9))
    assert _build.SWEEP_RANKS == _build.RANKS + (16,)
    for r in range(1, 17):
        _build.check_rank(r, "forward_sweep_cuda", _build.FORWARD_RANKS)
    with pytest.raises(ValueError, match="ROADMAP"):
        _build.check_rank(17, "forward_sweep_cuda", _build.FORWARD_RANKS)
    for d, sym in ((8, "cgt_forward_sweep"), (9, "cgt_rt_forward_sweep"),
                   (15, "cgt_rt_forward_sweep"), (16, "cgt_forward_sweep")):
        assert sweep_cuda._solve_symbol("forward_sweep", d) == sym
    w = sweep_cuda.forward_sweep_cuda
    before = (w.launches, w.launches_rt)
    for d in (12, 16, 8):
        sweep_cuda._count_solve(w, d)
    assert (w.launches, w.launches_rt) == (before[0] + 2, before[1] + 1)
    w.launches, w.launches_rt = before
    for suf in ("_f32", "_f64"):
        assert (_build._SIGNATURES[f"cgt_rt_forward_sweep{suf}"]
                == _build._SIGNATURES[f"cgt_forward_sweep{suf}"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 12, 15])
def test_rt_forward_sweep_kernel_on_card(card, d):
    """On a card: the runtime-d sweep kernel against its plain twin at
    s = 4, C = 9 (a ragged second tile), float32 and float64, and one
    launch counted on ``launches_rt``."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
        R, O, y = (t.to(card) for t in _chunked(d, dtype))
        R, O, y = R[:, :, :, :9].contiguous(), O[:, :, :, :9].contiguous(), \
            y[:, :, :9].contiguous()
        before = sweep_cuda.forward_sweep_cuda.launches_rt
        got = sweep_cuda.forward_sweep_cuda(R, O, y)
        torch.cuda.synchronize()
        assert sweep_cuda.forward_sweep_cuda.launches_rt == before + 1
        ref = sweep_cuda.forward_sweep_plain(R, O, y)
        for a, b in zip(got, ref):
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= tol * scale
