"""The system's entry step in PyTorch: the LEG log-likelihood forward on
the flagship configuration (rank 5, obs_dim 2, N = 1024 irregular
float32 points), the counterpart of ``__graft_entry__.entry()``.
"""

from __future__ import annotations

import torch

from cyclic_gps_tpu_torch.data.synthetic import generate_data
from cyclic_gps_tpu_torch.models import leg

RANK, OBS_DIM, NUM_POINTS = 5, 2, 1024


def entry(device=None):
    """(fn, example_args): ``fn(params, ts, xs)`` is the log-likelihood;
    the arguments are seeded parameters and a synthetic series on
    ``device``."""
    params = leg.init_params(
        RANK, OBS_DIM, generator=torch.Generator().manual_seed(0),
        dtype=torch.float32, device=device,
    )
    ts, xs = generate_data(NUM_POINTS, OBS_DIM, dtype=torch.float32,
                           spacing="irregular", seed=0, device=device)

    def fn(params, ts, xs):
        return leg.log_likelihood(params, ts, xs)

    return fn, (params, ts, xs)
