"""PyTorch port vs the JAX package: kernel 1 at block size 16, the
likelihood's forward sweep on celerite's boundary chain
(csrc/forward_sweep.cu), and kernel 14, celerite's collecting filter sweep
(csrc/celerite_filter.cu), which run one warp per chunk lane there (kernel
14 at nblocks 5-8).

On the CPU each wrapper runs its plain twin, held here against the JAX
package: kernel 1's twin at d = 16 against ``forward_sweep_pallas`` in
interpret mode (s = 3, C = 9, float64), and kernel 14's twin at nblocks 5
and 8, obs 1 and 2, against ``conditional_filter_collect_xla`` on
``celerite._filter_inputs`` (float32, a ragged last chunk).  The kernels
against their twins run only on a card (marked ``cuda``, skipped here).
The JAX package is imported inside the reference helpers, so the card
tests collect without it:
``python -m pytest --noconftest tests/test_torch_warp16_filter.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.convert import (NumpyCeleriteParams,
                                          celerite_params_from_jax)
from cyclic_gps_tpu_torch.models import celerite, leg
from cyclic_gps_tpu_torch.ops import celerite_cuda, sweep_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt

torch.set_num_threads(1)

D = 16
# kernel 1's CPU case: the shortest chunk (the first row and one that
# carries) on a ragged second tile of 8 (float32) or 4 (float64) lanes
_S, _C = 3, 9
# kernel 14's CPU case: n = 200 at s = 32 gives C = 7 chunks, the last
# holding 8 rows and 24 padding rows (masked gaps, unobserved rows)
_FS, _FN = 32, 200


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


def _close(got, ref, rtol, atol_of_scale, label):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got.detach().cpu(), dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_of_scale * np.max(np.abs(ref)),
                               err_msg=label)


def _pallas_sweep(R_cm, O_cm, y_cm):
    """The TPU kernel 1 in interpret mode on the same inputs (its outputs
    sliced to the true chunk count: it pads C to its lane tile), computed
    once per test run."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep
    from torch_reference_cache import shared

    c = R_cm.shape[-1]

    def compute():
        with pltpu.force_tpu_interpret_mode():
            out = pallas_sweep.forward_sweep_pallas(
                *(jnp.asarray(t.numpy()) for t in (R_cm, O_cm, y_cm)),
                jitter=1e-3)
        return [np.asarray(b)[..., :c] if np.ndim(b) else np.asarray(b)
                for b in out]

    return shared(f"warp16_sweep_pallas_{R_cm.shape[0]}_{c}", compute)


def test_forward_sweep_twin_at_16_matches_pallas():
    """Kernel 1's plain twin at block size 16 == forward_sweep_pallas in
    interpret mode, float64, s = 3, C = 9, pivot jitter 1e-3: the final
    state (acc00, accy0, W0, w, D, 1/diag D), mh, ld and the per-row
    log-dets, rtol 1e-10 and atol 1e-12 of each output's scale (one
    algorithm, reassociated)."""
    ins = _system_cm(_S, _C, seed=116)
    ref = _pallas_sweep(*ins)
    with torch.no_grad():
        got = sweep_cuda.forward_sweep_cuda(*ins, 1e-3)
    assert len(got) == len(ref) == 9
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, 1e-10, 1e-12, f"kernel 1 out {i}")


def _params(nb, obs, seed):
    """Celerite parameters with couplings, unequal rates and rotations
    (oscillating and overdamped blocks), float32 values."""
    rng = np.random.RandomState(seed)
    ti = np.tril_indices(obs)
    arrays = (1.0 + 0.3 * rng.randn(2 * nb), 0.6 * rng.randn(nb),
              1.5 * rng.randn(nb), (0.1 * np.eye(obs))[ti],
              0.5 * rng.randn(obs, 2 * nb) + 0.2)
    return NumpyCeleriteParams(*(np.float32(a) for a in arrays))


def _series(n, obs, seed):
    """Irregular float32 timestamps and observations."""
    rng = np.random.RandomState(seed)
    ts = np.float32(np.cumsum(rng.exponential(0.5, n) + 0.05))
    return ts, np.float32(rng.randn(n, obs))


def _k14_inputs(nb, obs, n, seed, device="cpu"):
    """Kernel 14's inputs as the filter route builds them, float32, on s =
    32 rows per chunk (the last chunk ragged)."""
    p = _params(nb, obs, seed)
    ts, xs = _series(n, obs, seed + 1)
    c = -(-n // _FS)
    q = celerite_params_from_jax(p, device=device)
    with torch.no_grad():
        diffs, gv, real = leg._chunk_gap_geometry(
            torch.as_tensor(ts, device=device), _FS, n, c, torch.float32)
        y_cm = celerite._y_chunk_major(torch.as_tensor(xs, device=device),
                                       _FS, c)
        args = (celerite.g_blocks(q).contiguous(), q.b.detach().contiguous(),
                leg.lambda_lambda_t(q).contiguous(), diffs, gv, real, y_cm)
    return p, ts, xs, args


def _jax_k14(p, ts, xs):
    """The JAX oracle of kernel 14: conditional_filter_collect_xla on
    celerite._filter_inputs, float32; statistics [C, ...], histories
    [s, C, ...]."""
    import jax
    import jax.numpy as jnp
    from cyclic_gps_tpu.models import celerite as jcel
    from cyclic_gps_tpu.models import leg as jleg
    from cyclic_gps_tpu.ops import chunked_filter as jcf
    from torch_reference_cache import shared

    def compute():
        def f(jp, jts, jxs):
            lam = jleg.lambda_lambda_t(jp)
            e, q, y, valid = jcel._filter_inputs(jp, jts, jxs, _FS)
            return jcf.conditional_filter_collect_xla(e, q, jp.b, lam, y,
                                                      valid)

        jp = jcel.CeleriteParams(*map(jnp.asarray, p))
        return jax.jit(f)(jp, jnp.asarray(ts), jnp.asarray(xs))

    nb, obs = p.b.shape[1] // 2, p.b.shape[0]
    return shared(f"warp16_filter_collect_{nb}_{obs}", compute)


@pytest.mark.parametrize("nb", [5, 8])
@pytest.mark.parametrize("obs", [1, 2])
def test_collect_twin_matches_jax(nb, obs):
    """Kernel 14's plain twin at the widths of its warp-per-lane instance
    (nblocks 5 and 8, obs 1 and 2) == JAX conditional_filter_collect_xla on
    celerite._filter_inputs, float32, on a ragged grid (n = 200, s = 32,
    C = 7) whose last chunk's padding rows are masked gaps (gv = 0) and
    unobserved rows (real = 0): the seven statistics element-major and the
    per-step histories (a_h, F_h, P_h), rtol 1e-4 and atol 1e-5 of each
    output's scale (float32, other summation orders)."""
    p, ts, xs, args = _k14_inputs(nb, obs, _FN, seed=80 + 10 * nb + obs)
    gv, real = args[4], args[5]
    assert bool((gv[:, -1] == 0).any()) and bool((real[:, -1] == 0).any())
    out, hist = _jax_k14(p, ts, xs)
    with torch.no_grad():
        stats, hists = celerite_cuda.celerite_filter_collect_cuda(*args)
    assert len(stats) == len(out) == 7 and len(hists) == len(hist) == 3
    for i, (a, b) in enumerate(zip(stats, out)):
        _close(a, np.moveaxis(np.asarray(b), 0, -1), 1e-4, 1e-5,
               f"kernel 14 out {i}, nblocks {nb}, obs {obs}")
    for i, (a, b) in enumerate(zip(hists, hist)):
        _close(a, np.moveaxis(np.asarray(b), 1, -1), 1e-4, 1e-5,
               f"kernel 14 hist {i}, nblocks {nb}, obs {obs}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors both wrappers run their twins: kernel 1 at d = 16 and
    kernel 14 at nblocks 8, routed and with ``warp=True``, count no launch
    on ``launches``, ``launches_warp`` or ``launches_rt``."""
    k1 = sweep_cuda.forward_sweep_cuda
    k14 = celerite_cuda.celerite_filter_collect_cuda
    counts = lambda: (k1.launches, k1.launches_warp, k1.launches_rt,  # noqa
                      k14.launches, k14.launches_warp)
    before = counts()
    with torch.no_grad():
        out1 = k1(*_system_cm(_S, 2, seed=117, dtype=torch.float32))
        _, _, _, args = _k14_inputs(8, 1, 40, seed=118)
        out14 = k14(*args)
        out14w = k14(*args, warp=True)
    assert counts() == before
    assert all(bool(torch.isfinite(t).all()) for t in out1)
    for a, b in zip(out14[0] + out14[1], out14w[0] + out14w[1]):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("s,c", [(3, 1), (3, 8), (3, 9), (32, 245)])
def test_forward_sweep_warp_at_16_on_card(card, s, c):
    """Kernel 1 at block size 16 (one warp per chunk lane) against its twin
    on chip_smoke.py's EDGES16 shapes: s rows by C = c lanes (C = 1 a lone
    lane, 8 one whole float32 tile, 9 and 245 a ragged last tile), float32
    (1e-4 of each output's scale) and float64 (1e-10), each launch counted
    on ``launches`` and ``launches_warp``."""
    k1 = sweep_cuda.forward_sweep_cuda
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        ins = [t.to(card) for t in _system_cm(s, c, 130 + s + c, dtype)]
        before = (k1.launches, k1.launches_warp)
        with torch.no_grad():
            got = k1(*ins, 1e-3)
            torch.cuda.synchronize()
            ref = sweep_cuda.forward_sweep_plain(*ins, 1e-3)
        _close_on_card(got, ref, tol, f"kernel 1, s {s}, C {c}, {dtype}")
        assert (k1.launches, k1.launches_warp) == (before[0] + 1,
                                                   before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("obs", [1, 2])
def test_collect_kernel_on_card(card, nb, obs):
    """Kernel 14's two designs against its twin at n = 283 (s = 32, C = 9:
    a ragged second tile of 8 lanes and a ragged last chunk whose padding
    rows are masked gaps and unobserved rows) and on that last lane alone
    (C = 1): the routed call (one thread per lane below nblocks 5, one
    warp per lane from 5) and the warp design forced, 1e-4 of each
    output's scale, each launch counted on ``launches_warp`` as it ran."""
    w = celerite_cuda.celerite_filter_collect_cuda
    _, _, _, args9 = _k14_inputs(nb, obs, 283, seed=140 + 10 * nb + obs,
                                 device=card)
    last = lambda t: t[..., -1:].contiguous()  # noqa: E731
    args1 = args9[:3] + tuple(map(last, args9[3:]))
    for args, c in ((args9, 9), (args1, 1)):
        assert bool((args[4][:, -1] == 0).any())
        with torch.no_grad():
            ref = w(*[t.cpu() for t in args])
        for warp in (False, True):
            before = (w.launches, w.launches_warp)
            with torch.no_grad():
                got = w(*args, warp=warp)
            torch.cuda.synchronize()
            took_warp = warp or nb >= celerite_cuda.COLLECT_WARP_NBLOCKS
            assert (w.launches, w.launches_warp) == (before[0] + 1,
                                                     before[1] + took_warp)
            _close_on_card(
                [t.cpu() for t in got[0] + got[1]], ref[0] + ref[1], 1e-4,
                f"kernel 14, nblocks {nb}, obs {obs}, C {c}, warp {warp}")
