"""Windowing of trajectories into training batches (``repro/data/windows.py:20-46``).

Host-side numpy, a copy of the JAX package's ``make_windows``: [T, n]
trajectories become [N_windows, window, n] batches, z-scored per dimension
over the whole trajectory (the statistics are returned so recovered
coefficients map back to physical units).
"""

from __future__ import annotations

import numpy as np


def make_windows(
    ys: np.ndarray,
    us: np.ndarray | None,
    window: int,
    stride: int = 1,
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray | None, dict]:
    """Returns (y_windows, u_windows, norm_stats)."""
    stats = {"mean": np.zeros(ys.shape[-1]), "scale": np.ones(ys.shape[-1])}
    if normalize:
        stats["mean"] = ys.mean(axis=0)
        stats["scale"] = ys.std(axis=0) + 1e-8
        ys = (ys - stats["mean"]) / stats["scale"]
    starts = np.arange(0, ys.shape[0] - window + 1, stride)
    yw = np.stack([ys[s : s + window] for s in starts])
    uw = None
    if us is not None and us.shape[-1] > 0:
        uw = np.stack([us[s : s + window] for s in starts]).astype(np.float32)
    return yw.astype(np.float32), uw, stats
