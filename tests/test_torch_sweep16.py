"""PyTorch port vs the JAX package: kernels 6 and 7 at block size 16, the
rank-16 backward pair of celerite's boundary chain (csrc/backward_sweep.cu),
which run one warp per chunk lane on csrc/rtcoop.cuh there.

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``forward_sweep_solveinv_pallas`` and
``backward_solve_takahashi_pallas``) at s = 3, C = 9, float64, and the
kernel route of ``mahal_and_logdet_cm``'s backward at d = 16 (both twins
and the glue between them) against its plain route.  The kernels against their twins run
only on a card (marked ``cuda``, skipped here), at s = 3 and 32 on C = 1,
8, 9 and 245 lanes, float32 and float64.  The JAX package is imported
inside the reference helpers, so the card tests collect without it:
``python -m pytest --noconftest tests/test_torch_sweep16.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda

torch.set_num_threads(1)

D = 16
# the CPU cases: the shortest chunk (the sweep's first row and one that
# carries; the walk's seed row and one recursion row) on a ragged second
# tile of 8 (float32) or 4 (float64) lanes
_S, _C = 3, 9


def _system_cm(s, c, seed, dtype=torch.float64):
    """tests/test_wideblock.py's well-conditioned system at d = 16 on s rows
    by C = c chunks, chunk-major (R_cm, O_cm, y_cm)."""
    rng = np.random.RandomState(seed)
    n = s * c
    q = rng.randn(n, D, D)
    diag = q @ q.transpose(0, 2, 1) / D + 4 * np.eye(D)
    off = rng.randn(n - 1, D, D) / D
    y = rng.randn(n, D)
    return [t.contiguous() for t in pt._chunk_layout(
        *(torch.tensor(a, dtype=dtype) for a in (diag, off, y)), s)[:3]]


def _walk_inputs(stacks, c, seed, dtype=torch.float64):
    """Kernel 7's inputs: kernel 6's four stacks, then hat_W1, x_b,
    x_b_next, p00, p01, p10, p11 drawn from a numpy seed (scale 0.3)."""
    rng = np.random.RandomState(seed)
    extra = [torch.tensor(rng.randn(*shape) * 0.3, dtype=dtype) for shape in
             [(D, D, c), (D, c), (D, c)] + [(D, D, c)] * 4]
    return [t.to(dtype) for t in stacks] + extra


def _close(got, ref, rtol, atol_of_scale, label):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got.detach().cpu(), dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_of_scale * np.max(np.abs(ref)),
                               err_msg=label)


def _pallas_pair(R_cm, O_cm, y_cm, walk_extra):
    """The TPU kernels 6 and 7 in interpret mode on the same inputs (their
    stacks sliced to the true chunk count: kernel 6 pads C to its lane
    tile), computed once per test run."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep
    from torch_reference_cache import shared

    c = R_cm.shape[-1]

    def compute():
        with pltpu.force_tpu_interpret_mode():
            out6 = pallas_sweep.forward_sweep_solveinv_pallas(
                *(jnp.asarray(t.numpy()) for t in (R_cm, O_cm, y_cm)),
                jitter=1e-3)
            out6 = [np.asarray(b)[..., :c] if np.ndim(b) else np.asarray(b)
                    for b in out6]
            out7 = pallas_sweep.backward_solve_takahashi_pallas(
                *(jnp.asarray(a) for a in out6[8:12]),
                *(jnp.asarray(t.numpy()) for t in walk_extra))
        return out6, [np.asarray(b) for b in out7]

    return shared(f"sweep16_pallas_{R_cm.shape[0]}_{c}", compute)


@pytest.fixture(scope="module")
def pallas_pair():
    """(inputs, extra walk inputs, (kernel 6's outputs, kernel 7's)) of
    the TPU kernels at d = 16, s = 3, C = 9, float64."""
    R_cm, O_cm, y_cm = _system_cm(_S, _C, seed=16)
    extra = _walk_inputs([], _C, seed=17)
    return (R_cm, O_cm, y_cm), extra, _pallas_pair(R_cm, O_cm, y_cm, extra)


def test_solveinv_twin_at_16_matches_pallas(pallas_pair):
    """Kernel 6's plain twin at block size 16 == forward_sweep_solveinv_pallas
    in interpret mode, float64, s = 3, C = 9, pivot jitter 1e-3: the final
    state, the four hat stacks and the per-row log-dets, rtol 1e-10 and
    atol 1e-12 of each output's scale (one algorithm, reassociated)."""
    ins, _, (ref6, _) = pallas_pair
    with torch.no_grad():
        got6 = sweep_cuda.forward_sweep_solveinv_cuda(*ins, 1e-3)
    assert len(got6) == len(ref6) == 13
    for i, (a, b) in enumerate(zip(got6, ref6)):
        _close(a, b, 1e-10, 1e-12, f"kernel 6 out {i}")


def test_backsolve_twin_at_16_matches_pallas(pallas_pair):
    """Kernel 7's plain twin at block size 16 ==
    backward_solve_takahashi_pallas in interpret mode, float64, on kernel
    6's stacks at s = 3 (the seed row s-2 and one recursion row), C = 9,
    with random boundary inputs: rtol 1e-10, atol 1e-12 of each output's
    scale."""
    _, extra, (ref6, ref7) = pallas_pair
    stacks = [torch.tensor(a) for a in ref6[8:12]]
    with torch.no_grad():
        got7 = sweep_cuda.backward_solve_takahashi_cuda(*stacks, *extra)
    assert len(got7) == len(ref7) == 5
    for i, (a, b) in enumerate(zip(got7, ref7)):
        _close(a, b, 1e-10, 1e-12, f"kernel 7 out {i}")


@pytest.mark.parametrize("s,c", [(_S, _C), (32, 3)])
def test_kernel_route_at_16_matches_plain_route(s, c, monkeypatch):
    """The slice as a whole on CPU tensors: at d = 16 the kernel route of
    mahal_and_logdet_cm's analytic backward (backend "cuda", so the twins
    of kernels 6 and 7 with the glue between them: hat_W1, the shifted
    boundary solution, the selected-inverse blocks) == the plain route
    (backend "torch") at float64: solve_and_inverse_cm's three outputs and
    the gradients of mh + 0.3 ld, rtol 1e-10 and atol 1e-12 of each
    output's scale.  (The plain route is held against the JAX package at
    d = 3 in tests/test_torch_grad.py; the JAX engine's reference at d = 16
    costs 35-50 s of CPU, most of it compiling its CR terminal.)"""
    ins = _system_cm(s, c, seed=18 + s)

    def run():
        leaves = [t.clone().requires_grad_() for t in ins]
        mh, ld = pt.mahal_and_logdet_cm(*leaves)
        grads = torch.autograd.grad(mh + 0.3 * ld, leaves)
        with torch.no_grad():
            sol = pt.solve_and_inverse_cm(*ins)
        return (mh, ld) + grads + tuple(sol)

    ref = run()
    monkeypatch.setattr(pt, "resolve_backend", lambda b, t: "cuda")
    wrappers = (sweep_cuda.forward_sweep_solveinv_cuda,
                sweep_cuda.backward_solve_takahashi_cuda)
    before = [w.launches_warp for w in wrappers]
    calls = []
    for w in wrappers:
        monkeypatch.setattr(sweep_cuda, w.__name__, lambda *a, _f=w, **kw:
                            calls.append(_f.__name__) or _f(*a, **kw))
    got = run()
    assert sorted(set(calls)) == ["backward_solve_takahashi_cuda",
                                  "forward_sweep_solveinv_cuda"]
    labels = ("mh", "ld", "grad R", "grad O", "grad y", "x", "sigma_diag",
              "sigma_off")
    for label, a, b in zip(labels, got, ref):
        _close(a, b.detach().numpy(), 1e-10, 1e-12, label)
    # CPU tensors ran the twins: no kernel launch was counted
    assert [w.launches_warp for w in wrappers] == before


# ---------------------------------------------------------------------------
# On a card: the warp-per-lane kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _close_on_card(got, ref, tol, label):
    for i, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.abs().max()) or 1.0
        err = float((a - b).abs().max())
        assert err <= tol * scale, f"{label} out {i}: {err:.3e} of {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3, 32])
@pytest.mark.parametrize("c", [1, 8, 9, 245])
def test_warp_pair_at_16_on_card(card, s, c):
    """Kernels 6 and 7 at block size 16 (one warp per chunk lane) against
    their twins on s rows by C = c lanes (C = 1 a lone lane, 8 one whole
    float32 tile, 9 and 245 a ragged last tile), float32 (1e-4 of each
    output's scale) and float64 (1e-10), each launch counted on both
    ``launches`` and ``launches_warp``."""
    k6 = sweep_cuda.forward_sweep_solveinv_cuda
    k7 = sweep_cuda.backward_solve_takahashi_cuda
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        label = f"s {s}, C {c}, {dtype}"
        ins = [t.to(card) for t in _system_cm(s, c, 30 + s + c, dtype)]
        before = (k6.launches, k6.launches_warp, k7.launches,
                  k7.launches_warp)
        with torch.no_grad():
            got6 = k6(*ins, 1e-3)
            torch.cuda.synchronize()
            ref6 = sweep_cuda.forward_sweep_solveinv_plain(*ins, 1e-3)
            _close_on_card(got6, ref6, tol, f"kernel 6, {label}")
            args7 = [t.to(card) for t in _walk_inputs(
                ref6[8:12], c, 40 + s + c, dtype)]
            got7 = k7(*args7)
            torch.cuda.synchronize()
            ref7 = sweep_cuda.backward_solve_takahashi_plain(*args7)
            _close_on_card(got7, ref7, tol, f"kernel 7, {label}")
        b6, bw6, b7, bw7 = before
        assert (k6.launches, k6.launches_warp) == (b6 + 1, bw6 + 1)
        assert (k7.launches, k7.launches_warp) == (b7 + 1, bw7 + 1)
