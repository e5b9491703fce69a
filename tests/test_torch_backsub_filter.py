"""PyTorch port vs the JAX package: kernel 18', the solve's
back-substitution at block sizes 9-15 (csrc/rt_solve.cu), and kernel 13,
celerite's filter sweep (csrc/celerite_filter.cu), which run one warp per
chunk lane there (kernel 13 from nblocks ``FILTER_WARP_NBLOCKS`` up).

On the CPU each wrapper runs its plain twin, held here against the JAX
package: the back-substitution's twin at d = 9 and 15 against
``backward_substitute_pallas`` in interpret mode (float64, s = 3 and 32,
C = 9, on the hat stacks of kernel 8's twin with seeded boundary
vectors), and kernel 13's twin at nblocks 5 and 8, obs 1 and 2, against
``conditional_filter_xla`` on ``celerite._filter_inputs`` (float32, a
ragged last chunk).  The kernels against their twins run only on a card
(marked ``cuda``, skipped here).  The JAX package is imported inside the
reference helpers, so the card tests collect without it:
``python -m pytest --noconftest tests/test_torch_backsub_filter.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import _build, celerite_cuda, sweep_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt
from test_torch_warp16_filter import (_FN, _FS, _close, _close_on_card,
                                      _k14_inputs)

torch.set_num_threads(1)

_C = 9  # a ragged second tile of 8 (float32) or 4 (float64) lanes


def _stacks(d, s, c, seed, dtype=torch.float64):
    """tests/test_wideblock.py's well-conditioned system at block size d on
    s rows by c chunks, chunk-major (R_cm, O_cm, y_cm), and seeded
    boundary inputs of the back-substitution (hat_W1 [d, d, c], x_b and
    x_{b,next} [d, c])."""
    rng = np.random.RandomState(seed)
    n = s * c
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / d
    y = rng.randn(n, d)
    cm = [t.contiguous() for t in pt._chunk_layout(
        *(torch.tensor(a, dtype=dtype) for a in (diag, off, y)), s)[:3]]
    bnd = [torch.tensor(rng.randn(*shape) / d, dtype=dtype)
           for shape in ((d, d, c), (d, c), (d, c))]
    return cm, bnd


def _hats(d, s, seed, dtype=torch.float64, c=_C):
    """The back-substitution's inputs at block size d on s rows by c
    chunks: the hat stacks (hat_C, hat_W0, hat_w) of kernel 8's plain twin
    on `_stacks` (pivot jitter 1e-3) and its seeded boundary inputs."""
    cm, bnd = _stacks(d, s, c, seed, dtype)
    with torch.no_grad():
        hats = sweep_cuda.forward_sweep_collect_plain(*cm, 1e-3)[8:11]
    return [t.contiguous() for t in hats], bnd


def _pallas_backsub(d, s, seed):
    """backward_substitute_pallas in interpret mode on `_hats`, computed
    once per test run."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops import pallas_sweep
    from torch_reference_cache import shared

    def compute():
        ins = [jnp.asarray(t.numpy()) for t in sum(_hats(d, s, seed), [])]
        with pltpu.force_tpu_interpret_mode():
            x = pallas_sweep.backward_substitute_pallas(*ins)
        return np.asarray(x)[..., :_C]

    return shared(f"backsub_pallas_{d}_{s}", compute)


@pytest.mark.parametrize("d", [9, 15])
@pytest.mark.parametrize("s", [3, 32])
def test_backsub_twin_matches_pallas(d, s, no_persistent_cache_writes):
    """The plain twin of kernel 18' (the back-substitution at d = 9-15) ==
    backward_substitute_pallas in interpret mode, float64, s = 3 (two rows,
    the first from hat_W1) and 32, C = 9, on the hat stacks of kernel 8's
    twin with seeded hat_W1, x_b and x_{b,next}: rtol 1e-10, atol 1e-12 of
    the output's scale (one algorithm, reassociated)."""
    seed = 170 + d + s
    ref = _pallas_backsub(d, s, seed)
    hats, bnd = _hats(d, s, seed)
    with torch.no_grad():
        got = sweep_cuda.backward_substitute_cuda(*hats, *bnd)
    assert got.shape == (s - 1, d, _C)
    _close(got, ref, 1e-10, 1e-12, f"kernel 18', d {d}, s {s}")


def _jax_k13(p, ts, xs):
    """The JAX oracle of kernel 13: conditional_filter_xla on
    celerite._filter_inputs, float32; statistics [C, ...]."""
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
            return jcf.conditional_filter_xla(e, q, jp.b, lam, y, valid)

        jp = jcel.CeleriteParams(*map(jnp.asarray, p))
        return jax.jit(f)(jp, jnp.asarray(ts), jnp.asarray(xs))

    nb, obs = p.b.shape[1] // 2, p.b.shape[0]
    return shared(f"backsub_filter_k13_{nb}_{obs}", compute)


@pytest.mark.parametrize("nb", [5, 8])
@pytest.mark.parametrize("obs", [1, 2])
def test_filter_twin_matches_jax(nb, obs, no_persistent_cache_writes):
    """Kernel 13's plain twin at the widths of its warp-per-lane instance
    (nblocks 5 and 8, obs 1 and 2) == JAX conditional_filter_xla on
    celerite._filter_inputs, float32, on a ragged grid (n = 200, s = 32,
    C = 7) whose last chunk's padding rows are masked gaps (gv = 0) and
    unobserved rows (real = 0): the seven statistics element-major, rtol
    1e-4 and atol 1e-5 of each output's scale (float32, other summation
    orders)."""
    p, ts, xs, args = _k14_inputs(nb, obs, _FN, seed=180 + 10 * nb + obs)
    gv, real = args[4], args[5]
    assert bool((gv[:, -1] == 0).any()) and bool((real[:, -1] == 0).any())
    out = _jax_k13(p, ts, xs)
    with torch.no_grad():
        stats = celerite_cuda.celerite_filter_cuda(*args)
    assert len(stats) == len(out) == 7
    for i, (a, b) in enumerate(zip(stats, out)):
        _close(a, np.moveaxis(np.asarray(b), 0, -1), 1e-4, 1e-5,
               f"kernel 13 out {i}, nblocks {nb}, obs {obs}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors both wrappers run their twins: the back-substitution
    at d = 12 and kernel 13 at nblocks 8, routed and with ``warp=True``,
    count no launch on ``launches``, ``launches_rt`` or
    ``launches_warp``."""
    k18 = sweep_cuda.backward_substitute_cuda
    k13 = celerite_cuda.celerite_filter_cuda
    counts = lambda: (k18.launches, k18.launches_rt,  # noqa: E731
                      k13.launches, k13.launches_warp)
    before = counts()
    d, s, c = 12, 4, 3
    g = torch.Generator().manual_seed(190)
    hats = (torch.randn(s - 1, d, d, c, generator=g),
            torch.randn(s - 1, d, d, c, generator=g),
            torch.randn(s - 1, d, c, generator=g))
    bnd = [torch.randn(*shape, generator=g)
           for shape in ((d, d, c), (d, c), (d, c))]
    with torch.no_grad():
        x = k18(*hats, *bnd)
        _, _, _, args = _k14_inputs(8, 1, 40, seed=191)
        out13 = k13(*args)
        out13w = k13(*args, warp=True)
    assert counts() == before
    assert x.shape == (s - 1, d, c) and bool(torch.isfinite(x).all())
    for a, b in zip(out13, out13w):
        assert torch.equal(a, b)


def test_filter_warp_nblocks_in_range():
    """The nblocks from which kernel 13 runs one warp per chunk lane is an
    instantiated width, and the back-substitution's block sizes keep
    9-15."""
    assert celerite_cuda.FILTER_WARP_NBLOCKS in celerite_cuda.NBLOCKS
    assert 1 <= celerite_cuda.FILTER_WARP_NBLOCKS <= 8
    assert set(range(9, 16)) <= set(_build.SOLVE_RANKS)


# ---------------------------------------------------------------------------
# On a card: the warp-per-lane kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 12, 15])
@pytest.mark.parametrize("s,c", [(2, 1), (3, 9), (32, 245), (128, 300)])
def test_backsub_warp_on_card(card, d, s, c):
    """Kernel 18' (one warp per chunk lane) against its twin at s rows by
    C = c lanes (s = 2 a single row from hat_W1; C = 1 a lone lane, 9, 245
    and 300 a ragged last tile), float32 (1e-4 of the output's scale) and
    float64 (1e-10), on the hat stacks of the collecting sweep's twin with
    seeded boundary inputs, each launch counted on ``launches_rt``."""
    k18 = sweep_cuda.backward_substitute_cuda
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        hats, bnd = _hats(d, s, 200 + d + s + c, dtype, c)
        ins = [t.to(card) for t in (*hats, *bnd)]
        before = (k18.launches, k18.launches_rt)
        with torch.no_grad():
            got = k18(*ins)
            torch.cuda.synchronize()
            ref = sweep_cuda.backward_substitute_plain(*ins)
        _close_on_card([got], [ref], tol,
                       f"kernel 18', d {d}, s {s}, C {c}, {dtype}")
        assert (k18.launches, k18.launches_rt) == (before[0],
                                                   before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("obs", [1, 2])
def test_filter_kernel_on_card(card, nb, obs):
    """Kernel 13's two designs against its twin at n = 283 (s = 32, C = 9:
    a ragged second tile of 8 lanes and a ragged last chunk whose padding
    rows are masked gaps and unobserved rows) and on that last lane alone
    (C = 1): the routed call (one thread per lane below
    FILTER_WARP_NBLOCKS, one warp per lane from it) and the warp design
    forced, 1e-4 of each output's scale, each launch counted on
    ``launches_warp`` as it ran; the warp design's statistics equal to
    kernel 14's warp design's bit for bit."""
    w = celerite_cuda.celerite_filter_cuda
    _, _, _, args9 = _k14_inputs(nb, obs, 283, seed=240 + 10 * nb + obs,
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
            took_warp = warp or nb >= celerite_cuda.FILTER_WARP_NBLOCKS
            assert (w.launches, w.launches_warp) == (before[0] + 1,
                                                     before[1] + took_warp)
            _close_on_card([t.cpu() for t in got], ref, 1e-4,
                           f"kernel 13, nblocks {nb}, obs {obs}, C {c}, "
                           f"warp {warp}")
        with torch.no_grad():
            got13 = w(*args, warp=True)
            got14, _ = celerite_cuda.celerite_filter_collect_cuda(
                *args, warp=True)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got13, got14)):
            assert torch.equal(a, b), (
                f"kernel 13 vs 14 out {i}, nblocks {nb}, obs {obs}, C {c}")
