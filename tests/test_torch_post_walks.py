"""PyTorch port vs the JAX package: the posterior's two descending walks at
ranks 1-8, kernel 9 (the solve's back-substitution, csrc/solve_sweep.cu)
and kernel 11 (the selected inversion's Takahashi recursion,
csrc/inverse_sweep.cu), on shapes that exercise their designs.

Both take 32 chunk lanes a thread block (fewer where shared memory is
short) and split each lane's rows between one warp that runs the serial
chain and three warps that copy the rows in ahead of it.  Kernel 9 walks
its s - 1 rows in tiles of 3 through a ring of 4 (the warps form hat_w -
hat_W0 x_b), kernel 11 its s - 2 rows in tiles of 3 through rings of 2
and 3 (the warps build each row's hats and form the Sigma blocks of the
tile before).  So the shapes here hold C = 35 and 45 chunks (no multiple
of 32: a ragged second thread block) and, for kernel 9, s = 2 (the seed
row alone), 4 (one tile) and 15 (four tiles, the ring wrapping, and a
ragged fifth); for kernel 11, s = 3 (one row), 5 (one tile) and 12 (three
tiles, both rings wrapping, and a ragged fourth).

On the CPU each wrapper runs its plain twin, held here against the TPU
kernels in interpret mode (``backward_substitute_pallas`` and
``takahashi_backward_pallas``, float64) with the bar of
tests/test_torch_posterior.py.  The kernels against their twins, at ranks
1, 5 and 8, run only on a card (marked ``cuda``, skipped here); the JAX
package is imported inside the reference helpers, so the card tests
collect without it:
``python -m pytest --noconftest tests/test_torch_post_walks.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cyclic_gps_tpu_torch.ops import partitioned as pt
from cyclic_gps_tpu_torch.ops import sweep_cuda
from test_torch_ksys_walk import _close, _pallas

torch.set_num_threads(1)

_K9_CPU = [(2, 35), (4, 45), (15, 35)]  # (s, C)
_K11_CPU = [(3, 35), (5, 45), (12, 35)]
_K9_CARD = _K9_CPU + [(2, 1), (4, 1), (15, 45), (128, 70)]
_K11_CARD = _K11_CPU + [(3, 1), (5, 1), (12, 45), (128, 70)]


def _system(d, s, c, seed):
    """A block-tridiagonal system diagonally dominant at every block size d
    (q q^T / d + 4 I on the diagonal, off-diagonal blocks randn / 2d), s
    rows by c chunks, chunk-major float64, and the numpy generator that
    made it (for the walk's other inputs)."""
    rng = np.random.RandomState(seed)
    n = s * c
    q = rng.randn(n, d, d)
    diag = q @ q.transpose(0, 2, 1) / d + 4 * np.eye(d)
    off = rng.randn(n - 1, d, d) / (2 * d)
    y = rng.randn(n, d)
    R_cm, O_cm, y_cm, _ = pt._chunk_layout(
        *(torch.tensor(a, dtype=torch.float64) for a in (diag, off, y)), s)
    return R_cm.contiguous(), O_cm.contiguous(), y_cm.contiguous(), rng


def _backsub_inputs(d, s, c, seed, dtype=torch.float64):
    """Kernel 9's inputs: kernel 8's three hat stacks (its twin, pivot
    jitter 1e-3), then hat_W1, x_b and x_b_next drawn from a numpy seed
    (scale 0.3)."""
    R_cm, O_cm, y_cm, rng = _system(d, s, c, seed)
    with torch.no_grad():
        hats = sweep_cuda.forward_sweep_collect_plain(R_cm, O_cm, y_cm,
                                                      1e-3)[8:11]
    extra = [torch.tensor(rng.randn(*shape) * 0.3)
             for shape in [(d, d, c), (d, c), (d, c)]]
    return [t.to(dtype).contiguous() for t in list(hats) + extra]


def _takahashi_inputs(d, s, c, seed, dtype=torch.float64):
    """Kernel 11's inputs: kernel 10's four raw-factor stacks (its twin,
    pivot jitter 1e-3), then p00, p01, p10, p11, the seeds phi, u0, u1 and
    the unread a0, a1, all [d, d, c], drawn from a numpy seed (scale
    0.3)."""
    R_cm, O_cm, _, rng = _system(d, s, c, seed)
    with torch.no_grad():
        stacks = sweep_cuda.forward_sweep_inverse_plain(R_cm, O_cm,
                                                        1e-3)[4:8]
    extra = [torch.tensor(rng.randn(d, d, c) * 0.3) for _ in range(9)]
    return [t.to(dtype).contiguous() for t in list(stacks) + extra]


@pytest.mark.parametrize("s,c", _K9_CPU)
def test_backsub_twin_matches_pallas(s, c, no_persistent_cache_writes):
    """backward_substitute_plain (kernel 9's twin) ==
    backward_substitute_pallas in interpret mode, float64, rank 5:
    rtol 1e-10, atol 1e-12 of the output's scale (the bar of
    tests/test_torch_posterior.py)."""
    args = _backsub_inputs(5, s, c, seed=10 * s + c)
    with torch.no_grad():
        got = sweep_cuda.backward_substitute_cuda(*args)
    ref = _pallas("pallas_sweep", "backward_substitute_pallas", args, c,
                  f"post_backsub_{s}_{c}")
    assert got.shape == (s - 1, 5, c)
    # the TPU wrapper returns one array, which _pallas iterates over rows
    _close([got], [np.stack(ref)], 1e-10, 1e-12, f"s = {s}, C = {c}")


@pytest.mark.parametrize("s,c", _K11_CPU)
def test_takahashi_twin_matches_pallas(s, c, no_persistent_cache_writes):
    """takahashi_backward_plain (kernel 11's twin) ==
    takahashi_backward_pallas in interpret mode, float64, rank 5, all four
    outputs: rtol 1e-10, atol 1e-12 of each output's scale (the bar of
    tests/test_torch_posterior.py).  The TPU kernel takes 1/diag D as
    [s-1, d, 1, C]."""
    args = _takahashi_inputs(5, s, c, seed=10 * s + c + 1)
    with torch.no_grad():
        got = sweep_cuda.takahashi_backward_cuda(*args)
    tpu_args = list(args)
    tpu_args[1] = args[1][:, :, None, :]
    ref = _pallas("pallas_sweep", "takahashi_backward_pallas", tpu_args, c,
                  f"post_takahashi_{s}_{c}")
    assert len(got) == len(ref) == 4
    _close(got, ref, 1e-10, 1e-12, f"s = {s}, C = {c}")


def test_cpu_tensors_count_no_launch():
    """On CPU tensors the wrappers run their twins and count nothing."""
    k9 = sweep_cuda.backward_substitute_cuda
    k11 = sweep_cuda.takahashi_backward_cuda
    before = (k9.launches, k9.launches_split, k9.launches_rt, k11.launches,
              k11.launches_split, k11.launches_rt)
    with torch.no_grad():
        k9(*_backsub_inputs(2, 3, 4, seed=0))
        k11(*_takahashi_inputs(2, 3, 4, seed=0))
    assert (k9.launches_split, k11.launches_split) == (0, 0)
    assert (k9.launches, k9.launches_split, k9.launches_rt, k11.launches,
            k11.launches_split, k11.launches_rt) == before


# ---------------------------------------------------------------------------
# On the card: the kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _bars(dtype):
    """chip_smoke.py's bars: rtol and atol of each output's scale."""
    return (1e-3, 1e-4) if dtype == torch.float32 else (1e-9, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", _K9_CARD)
def test_backsub_on_card(card, dtype, r, s, c):
    """Kernel 9 == its twin, the same bits on a second run, and one launch
    of the split design each."""
    args = [a.to(card) for a in _backsub_inputs(r, s, c, seed=10 * s + c,
                                                dtype=dtype)]
    k9 = sweep_cuda.backward_substitute_cuda
    with torch.no_grad():
        n, n_split, n_rt = k9.launches, k9.launches_split, k9.launches_rt
        got = k9(*args)
        again = k9(*args)
        torch.cuda.synchronize()
        assert (k9.launches - n, k9.launches_split - n_split,
                k9.launches_rt - n_rt) == (2, 2, 0)
        ref = sweep_cuda.backward_substitute_plain(*args)
    assert bool(torch.equal(got, again))
    _close([got], [ref.cpu()], *_bars(dtype), f"rank {r}, {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("s,c", _K11_CARD)
def test_takahashi_on_card(card, dtype, r, s, c):
    """Kernel 11 == its twin, all four outputs (the hat form sums u0 and
    u1 in another order), the same bits on a second run, and one launch of
    the split design each."""
    args = [a.to(card) for a in _takahashi_inputs(
        r, s, c, seed=10 * s + c + 1, dtype=dtype)]
    k11 = sweep_cuda.takahashi_backward_cuda
    with torch.no_grad():
        n, n_split, n_rt = k11.launches, k11.launches_split, k11.launches_rt
        got = k11(*args)
        again = k11(*args)
        torch.cuda.synchronize()
        assert (k11.launches - n, k11.launches_split - n_split,
                k11.launches_rt - n_rt) == (2, 2, 0)
        ref = sweep_cuda.takahashi_backward_plain(*args)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    _close(got, [b.cpu() for b in ref], *_bars(dtype), f"rank {r}, {dtype}")
