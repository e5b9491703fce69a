"""PyTorch port vs the JAX package: LEG parameters, the marginal
log-likelihood on every route, the entry step, and the port's import
and backend contracts.

Inputs are made with numpy from fixed seeds and handed to both packages;
parameters cross over with cyclic_gps_tpu_torch.convert.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclic_gps_tpu.data.synthetic import generate_data as jgenerate_data
from cyclic_gps_tpu.models import leg as jleg
from cyclic_gps_tpu_torch.baselines import dense
from cyclic_gps_tpu_torch.convert import params_from_jax, params_to_numpy
from cyclic_gps_tpu_torch.data.synthetic import generate_data
from cyclic_gps_tpu_torch.entry import entry
from cyclic_gps_tpu_torch.models import leg
from cyclic_gps_tpu_torch.ops import _build, expm_cuda, sweep_cuda
from cyclic_gps_tpu_torch.ops import partitioned as pt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WRAPPERS = (sweep_cuda.forward_sweep_cuda,
             expm_cuda.transition_and_noise_cuda, expm_cuda.k_system_cuda,
             expm_cuda.gap_mahal_sweep_cuda)


def _jax_params(rank, obs, dtype, seed, random_n=True):
    """JAX LEGParams made with numpy: the reference's default init
    (N = I, R = (Z - Z^T) / 5, raw Lambda = 0.1 I, B = 0.5 / sqrt(rank)),
    optionally with a random full N -- the default's normal G hides
    orientation bugs in the precision assembly."""
    rng = np.random.RandomState(seed)
    ti, tl = np.tril_indices(rank), np.tril_indices(rank, -1)
    n_params = (rng.randn(len(ti[0])) if random_n
                else np.eye(rank)[ti])
    z = rng.randn(rank, rank)
    r_params = ((z - z.T) * 0.2)[tl]
    lambda_params = (0.1 * np.eye(obs))[np.tril_indices(obs)]
    b = np.full((obs, rank), 0.5 / np.sqrt(rank))
    return jleg.LEGParams(*(jnp.asarray(a, dtype) for a in
                            (n_params, r_params, lambda_params, b)))


def _series(n, obs, dtype, spacing, seed):
    """The same series for both packages (numpy RNG in both)."""
    ts, xs = generate_data(n, obs, dtype=dtype, spacing=spacing, seed=seed,
                           device="cpu")
    jts, jxs = jgenerate_data(n, obs, dtype=jnp.float64 if dtype ==
                              torch.float64 else jnp.float32,
                              spacing=spacing, seed=seed)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    return ts, xs, jts, jxs


def _ll(*args, **kw):
    with torch.no_grad():
        return float(leg.log_likelihood(*args, **kw))


def test_params_round_trip_and_matrices():
    """params_from_jax / params_to_numpy carry the four packed arrays
    exactly; the matrix functions == JAX at float64 (rtol 1e-14); a fresh
    init has the reference's packing."""
    jp = _jax_params(4, 3, jnp.float64, seed=1)
    p = params_from_jax(jp)
    back = params_to_numpy(p)
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert p.n_params.dtype == torch.float64 and p.rank == 4
    assert p.obs_dim == 3

    matrices = ("n_matrix", "r_matrix", "lambda_matrix", "g_matrix",
                "lambda_lambda_t")
    ref = jax.jit(lambda q: [getattr(jleg, m)(q) for m in matrices])(jp)
    with torch.no_grad():
        for name, r in zip(matrices, ref):
            np.testing.assert_allclose(getattr(leg, name)(p).numpy(),
                                       np.asarray(r), rtol=1e-14,
                                       atol=1e-15, err_msg=name)

    q = leg.init_params(5, 2, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert sum(t.numel() for t in q.parameters()) == \
        leg.parameter_count(5, 2)
    with torch.no_grad():
        np.testing.assert_allclose(leg.n_matrix(q).numpy(), np.eye(5))
        r = leg.r_matrix(q).numpy()
        assert np.all(np.triu(r) == 0) and np.any(r != 0)
        np.testing.assert_allclose(np.linalg.norm(q.b.numpy(), axis=1), 0.5,
                                   rtol=1e-6)


_LL_CASES = [(n, spacing) for n in (33, 150)
             for spacing in ("regular", "irregular")]


def _ll_case(n, spacing):
    """Float64 fixture of the likelihood test: JAX params with a random
    full N, and one series for both packages."""
    jp = _jax_params(3, 2, jnp.float64, seed=n)
    return (jp,) + _series(n, 2, torch.float64, spacing, seed=n + 1)


@pytest.fixture(scope="module")
def jax_ll_reference():
    """JAX leg.log_likelihood(backend="xla") for every case of the
    likelihood test, in one compiled program."""
    args = [(_ll_case(n, sp)[0],) + _ll_case(n, sp)[3:] for n, sp in
            _LL_CASES]

    def all_cases(args):
        return [jleg.log_likelihood(p, t, x, regular=sp == "regular",
                                    backend="xla")
                for (p, t, x), (_, sp) in zip(args, _LL_CASES)]

    return dict(zip(_LL_CASES, map(float, jax.jit(all_cases)(args))))


@pytest.mark.parametrize("n,spacing", _LL_CASES)
def test_log_likelihood_matches_jax_and_dense(n, spacing, jax_ll_reference):
    """log_likelihood == JAX leg.log_likelihood(backend="xla") at float64,
    rank 3 / obs 2 with a random full N (rtol 1e-10), and == the dense
    O(N^3) oracle (rtol 1e-8).  n = 33 takes the small-N route, n = 150
    the chunk-major partitioned route."""
    jp, ts, xs, _, _ = _ll_case(n, spacing)
    p = params_from_jax(jp)
    got = _ll(p, ts, xs, regular=spacing == "regular")
    np.testing.assert_allclose(got, jax_ll_reference[n, spacing],
                               rtol=1e-10)
    with torch.no_grad():
        oracle = float(dense.log_marginal_likelihood_from_params(p, ts, xs))
    np.testing.assert_allclose(got, oracle, rtol=1e-8)


def test_kernel_routes_match_jax_float32(monkeypatch):
    """Every CUDA route of log_likelihood, run on the CPU through the
    kernel wrappers (whose CPU fallback is each kernel's plain twin) by
    resolving every backend to "cuda": the fused gaps -> sweep route ==
    JAX log_likelihood(backend="xla") at float32, n = 300 (rtol 2e-5, the
    bar of tests/test_chunked.py); the two-kernel route, the regular grid
    and the small-N route == the port's plain path (rtol 2e-5: Pade-7
    kernels vs the Pade-13 plain emission).  CPU tensors launch nothing."""
    n = 300
    jp = _jax_params(3, 2, jnp.float32, seed=5, random_n=False)
    p = params_from_jax(jp)
    ts, xs, jts, jxs = _series(n, 2, torch.float32, "irregular", seed=21)
    tr, xr = generate_data(n, 2, dtype=torch.float32, spacing="regular",
                           seed=22, device="cpu")
    ref = float(jleg.log_likelihood(jp, jts, jxs, backend="xla"))
    plain = {
        "fused": _ll(p, ts, xs, backend="torch"),
        "two_kernel": _ll(p, ts, xs, backend="torch"),
        "regular": _ll(p, tr, xr, regular=True, backend="torch"),
        "small": _ll(p, ts[:48], xs[:48], backend="torch"),
    }
    np.testing.assert_allclose(plain["fused"], ref, rtol=2e-5)

    called = []
    fused = leg._GapMahalFused.apply
    monkeypatch.setattr(pt, "resolve_backend", lambda backend, t: "cuda")
    monkeypatch.setattr(
        leg._GapMahalFused, "apply",
        lambda *a: called.append(1) or fused(*a))
    before = [w.launches for w in _WRAPPERS]
    routed = {
        "fused": _ll(p, ts, xs),
        "two_kernel": _ll(p, ts, xs, fused=False),
        "regular": _ll(p, tr, xr, regular=True),
        "small": _ll(p, ts[:48], xs[:48]),
    }
    assert len(called) == 1  # only the first call takes the fused route
    assert [w.launches for w in _WRAPPERS] == before
    np.testing.assert_allclose(routed["fused"], ref, rtol=2e-5)
    for route, value in routed.items():
        np.testing.assert_allclose(value, plain[route], rtol=2e-5,
                                   err_msg=route)


def test_entry_runs_on_cpu():
    """entry(device="cpu") builds the flagship configuration (rank 5,
    obs 2, N = 1024 irregular float32) and its step runs on the CPU,
    equal to the plain backend there."""
    fn, (p, ts, xs) = entry(device="cpu")
    with torch.no_grad():
        val = fn(p, ts, xs)
    assert val.shape == () and torch.isfinite(val)
    assert p.rank == 5 and p.obs_dim == 2
    assert ts.shape == (1024,) and ts.dtype == torch.float32
    assert float(val) == _ll(p, ts, xs, backend="torch")


def test_backend_contract_on_cpu():
    """backend="cuda" on a CPU tensor raises (no silent fallback); an
    unknown backend raises; "auto" resolves to "torch" on the CPU; block
    sizes without a kernel instance are refused with a pointer to the
    wide-layout queue."""
    t = torch.zeros(3)
    assert pt.resolve_backend("auto", t) == "torch"
    assert pt.resolve_backend("torch", t) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        pt.resolve_backend("cuda", t)
    with pytest.raises(ValueError, match="unknown backend"):
        pt.resolve_backend("xla", t)
    fn, (p, ts, xs) = entry(device="cpu")
    with pytest.raises(ValueError):
        leg.log_likelihood(p, ts, xs, backend="cuda")
    with pytest.raises(ValueError, match="ROADMAP"):
        _build.check_rank(9, "forward_sweep_cuda")
    _build.check_rank(8, "forward_sweep_cuda")


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in no JAX, and needs no
    nvcc or card."""
    code = (
        "import sys\n"
        "import cyclic_gps_tpu_torch, cyclic_gps_tpu_torch.entry, "
        "cyclic_gps_tpu_torch.convert\n"
        "from cyclic_gps_tpu_torch.models import leg\n"
        "from cyclic_gps_tpu_torch.baselines import dense\n"
        "from cyclic_gps_tpu_torch.ops import _build, cyclic_reduction, "
        "expm_cuda, expm_em, partitioned, smallblock, sweep_cuda\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'cyclic_gps_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
