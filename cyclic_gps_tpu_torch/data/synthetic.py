"""Synthetic time-series generation.

Counterpart of ``cyclic_gps_tpu/data/synthetic.py``: the same numpy
random stream, so one seed gives the same series in both packages;
returns tensors on the requested device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _gaussian_filter1d(x: np.ndarray, sigma: float) -> np.ndarray:
    """Truncated-Gaussian smoothing (reflect padding), matching
    scipy.ndimage.gaussian_filter1d defaults (truncate=4)."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (t / sigma) ** 2)
    kernel /= kernel.sum()
    padded = np.pad(x, radius, mode="reflect")
    return np.convolve(padded, kernel, mode="valid")


def generate_data(
    num_datapoints: int,
    data_dim: int,
    dtype: torch.dtype = torch.float64,
    spacing: str = "irregular",
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random series: irregular gaps ~ Exp(1) + 0.01 (or unit spacing),
    values = Gaussian-smoothed white noise per dim (sigma = 10).
    Returns (ts [N], xs [N, data_dim])."""
    rng = np.random.RandomState(seed)
    if spacing == "irregular":
        gaps = rng.exponential(1.0, size=num_datapoints) + 0.01
        ts = np.cumsum(gaps)
    else:
        ts = np.cumsum(np.ones(num_datapoints))
    vals = np.stack(
        [
            _gaussian_filter1d(rng.randn(num_datapoints), 10.0)
            for _ in range(data_dim)
        ],
        axis=-1,
    )
    return (torch.as_tensor(ts, dtype=dtype, device=device),
            torch.as_tensor(vals, dtype=dtype, device=device))
