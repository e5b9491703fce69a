"""PyTorch port vs the JAX package: the Pade-13 matrix exponential and
gap emission, and the plain twins of the three emission kernels against
the TPU kernels in interpret mode.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu.ops import expm_em as jexpm
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import expm_cuda
from cyclic_gps_tpu_torch.ops import expm_em

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _generator(r, seed, dtype):
    """A non-normal generator (symmetric PD part + antisymmetric part)."""
    rng = np.random.RandomState(seed)
    z = rng.randn(r, r)
    return (z @ z.T * 0.3 + (z - z.T) + 1e-5 * np.eye(r)).astype(dtype)


def test_expm_em_and_lu_solves_match_jax():
    """expm_em (Pade-13, per-matrix squaring) over six norm scales and
    the two element-major LU solves == cyclic_gps_tpu.ops.expm_em at
    float64 (rtol 1e-12 of each block's scale)."""
    rng = np.random.RandomState(0)
    d = 6
    mats = np.stack([rng.randn(d, d) * sc / d - 0.3 * sc * np.eye(d)
                     for sc in (1e-6, 1e-3, 0.3, 1.0, 7.0, 50.0)
                     for _ in range(3)], axis=-1)  # [d, d, 18]
    got = _np(expm_em.expm_em(torch.as_tensor(mats)))
    ref = np.asarray(jax.jit(jexpm.expm_em)(jnp.asarray(mats)))
    scale = np.abs(ref).max(axis=(0, 1), keepdims=True)
    assert (np.abs(got - ref) / scale).max() <= 1e-12

    a = rng.randn(5, 5, 16) + 3 * np.eye(5)[:, :, None]
    a[0, 0, :4] = 1e-14  # tiny leading pivot: only the pivoted form copes
    b = rng.randn(5, 3, 16)
    _close(expm_em.lu_solve_pivoted(torch.as_tensor(a), torch.as_tensor(b)),
           jax.jit(jexpm.lu_solve_pivoted)(jnp.asarray(a), jnp.asarray(b)),
           1e-12, 1e-12)
    a[0, 0, :4] = 3.0
    _close(expm_em.lu_solve(torch.as_tensor(a), torch.as_tensor(b)),
           jax.jit(jexpm.lu_solve)(jnp.asarray(a), jnp.asarray(b)), 1e-12,
           1e-12)


def test_transition_and_noise_em_matches_jax():
    """The Pade-13 hybrid (e, Q) construction == JAX
    leg._transition_and_noise_em_xla at float64 across gap scales, both
    branches and the squaring path (rtol 1e-12, atol 1e-14)."""
    r = 4
    g = _generator(r, 1, np.float64)
    diffs = np.logspace(-5, 2, 60)
    e, q = leg.transition_and_noise_em(torch.as_tensor(g),
                                       torch.as_tensor(diffs))
    je, jq = jax.jit(jleg._transition_and_noise_em_xla)(jnp.asarray(g),
                                                        jnp.asarray(diffs))
    _close(e, je, 1e-12, 1e-14)
    _close(q, jq, 1e-12, 1e-14)
    # the batch-major entry is the same values, [T, r, r]
    eb, qb = leg.transition_and_noise(torch.as_tensor(g),
                                      torch.as_tensor(diffs))
    _close(eb, np.moveaxis(_np(je), -1, 0), 1e-12, 1e-14)
    _close(qb, np.moveaxis(_np(jq), -1, 0), 1e-12, 1e-14)


def test_transition_and_noise_plain_matches_pallas():
    """transition_and_noise_plain (the (e, Q) kernel's twin) == the TPU
    kernel expm_pallas.transition_and_noise_pallas in interpret mode on
    the fixture of tests/test_expm.py (r = 4, 700 gaps over
    logspace(-4, 2), float32): the same algorithm in the same precision
    (rtol 1e-5, atol 1e-6)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops.expm_pallas import transition_and_noise_pallas

    rng = np.random.RandomState(0)
    r = 4
    z = rng.randn(r, r)
    g = ((z @ z.T * 0.3 + (z - z.T)) + 1e-5 * np.eye(r)).astype(np.float32)
    diffs = np.logspace(-4, 2, 700).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        je, jq = transition_and_noise_pallas(jnp.asarray(g),
                                             jnp.asarray(diffs))
    e, q = expm_cuda.transition_and_noise_cuda(torch.as_tensor(g),
                                               torch.as_tensor(diffs))
    assert e.dtype == torch.float32
    _close(e, je, 1e-5, 1e-6)
    _close(q, jq, 1e-5, 1e-6)


def _k_fixture(rank, n, s, seed):
    """Float32 LEG pieces for the emission kernels: (g, boost, ts) as
    tensors, from seeded default-init parameters and exponential gaps."""
    p = leg.init_params(rank, 2,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    with torch.no_grad():
        g = leg.g_matrix(p)
        llt = leg.lambda_lambda_t(p)
        boost = p.b.T @ torch.linalg.solve(llt, p.b)
    rng = np.random.RandomState(seed)
    ts = np.cumsum(rng.exponential(1.0, n) * 0.3 + 0.01).astype(np.float32)
    return g, boost, torch.as_tensor(ts)


def test_k_system_plain_matches_pallas():
    """k_system_plain (the K-system kernel's twin) == the TPU kernel
    expm_pallas.k_system_pallas in interpret mode on the same inputs
    (tests/test_expm.py fixture sizes: rank 3, n = 37, s = 4; float32,
    forward only; rtol 1e-4, atol 1e-5 -- the same algorithm, and
    K ~ Q1^{-1} amplifies rounding for small gaps), sliced to the true
    chunk count (the TPU kernel pads C to its lane tile)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops.expm_pallas import k_system_pallas

    rank, n, s = 3, 37, 4
    g, boost, ts = _k_fixture(rank, n, s, seed=0)
    c = -(-n // s)
    diffs, gv, real = leg._chunk_gap_geometry(ts, s, n, c, torch.float32)
    wrap = leg._wrap_row(g, diffs, gv, s)
    args = (g, boost, diffs, gv, real, wrap)
    got = expm_cuda.k_system_cuda(*args)
    with pltpu.force_tpu_interpret_mode():
        ref = k_system_pallas(*(jnp.asarray(_np(x)) for x in args))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        _close(a, np.asarray(b)[..., :c], 1e-4, 1e-5)


def test_gap_mahal_sweep_plain_matches_pallas():
    """gap_mahal_sweep_plain (the fused kernel's twin) == the TPU kernel
    expm_pallas.gap_mahal_sweep_pallas in interpret mode, all 11 outputs
    (rank 3, n = 96, s = 32, C = 3, float32; rtol 1e-4, atol 1e-5)."""
    from jax.experimental.pallas import tpu as pltpu

    from cyclic_gps_tpu.ops.expm_pallas import gap_mahal_sweep_pallas

    rank, n, s = 3, 96, 32
    g, boost, ts = _k_fixture(rank, n, s, seed=1)
    c = -(-n // s)
    diffs, gv, real = leg._chunk_gap_geometry(ts, s, n, c, torch.float32)
    wrap = leg._wrap_row(g, diffs, gv, s)
    y = torch.as_tensor(
        np.random.RandomState(2).randn(s, rank, c).astype(np.float32))
    args = (g, boost, diffs, gv, real, wrap, y)
    got = expm_cuda.gap_mahal_sweep_cuda(*args)
    with pltpu.force_tpu_interpret_mode():
        ref = gap_mahal_sweep_pallas(*(jnp.asarray(_np(x)) for x in args))
    assert len(got) == len(ref) == 11
    for a, b in zip(got, ref):
        _close(a, b, 1e-4, 1e-5)
