"""Windowing of trajectories into training batches (``repro/data/windows.py``).

Two families, as in the JAX package:

- ``make_windows``: host-side numpy, a copy of the JAX package's: [T, n]
  trajectories become [N_windows, window, n] batches, z-scored per
  dimension over the whole trajectory (the statistics are returned so
  recovered coefficients map back to physical units);
- ``roll_buffer`` / ``window_views`` / ``buffer_stats``: tensor helpers of the
  streaming service (``core/stream.py``), which rolls each slot's ring buffer
  forward and re-windows it on the device every tick.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def n_buffer_windows(buf_len: int, window: int, stride: int) -> int:
    """Number of sliding windows a length-``buf_len`` buffer yields."""
    if buf_len < window:
        raise ValueError(f"buffer length {buf_len} shorter than window {window}")
    return (buf_len - window) // stride + 1


def roll_buffer(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Drop the oldest C rows of ``buf`` [..., L, n] and append ``new`` [..., C, n]."""
    return torch.cat([buf[..., new.shape[-2] :, :], new], dim=-2)


@functools.lru_cache(maxsize=32)
def _window_index(buf_len: int, window: int, stride: int, device: torch.device) -> torch.Tensor:
    """The [N, T] gather index of ``window_views``, made once per device: a
    fresh host-to-device copy every tick would wait for the card."""
    n_win = n_buffer_windows(buf_len, window, stride)
    idx = np.arange(n_win)[:, None] * stride + np.arange(window)[None, :]
    return torch.as_tensor(idx, device=device)


def window_views(buf: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Sliding windows over the time axis, [..., L, n] -> [..., N, T, n]: one
    advanced-index gather, the same slices as ``make_windows``."""
    return buf[..., _window_index(buf.shape[-2], window, stride, buf.device), :]


def buffer_stats(buf: torch.Tensor, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension (mean, scale) over the time axis of ``buf`` [..., L, n],
    each [..., 1, n]. The population std, as ``jnp.std``; a (near-)constant
    channel, such as a zero-padded state of a mixed fleet, keeps scale 1.

    On the card: two reductions. On the CPU the arithmetic is spelled out in
    the JAX package's order (XLA's on the CPU, at L <= 32; longer buffers
    split the sum there, within an ulp of this), so the CPU tests hold the
    admission statistics bit for bit: a sequential float32 sum over time,
    divided by L; a sequential multiply-add of the centred squares (XLA
    contracts it into a fused multiply-add), divided by L; the square root
    correctly rounded, through float64 (PyTorch's float32 square root on the
    CPU is not). The host and device control planes share this function, so
    on either device they agree bit for bit.
    """
    if buf.device.type != "cpu":
        mean = buf.mean(dim=-2, keepdim=True)
        std = buf.std(dim=-2, correction=0, keepdim=True)
        return mean, torch.where(std < eps, torch.ones_like(std), std)
    L = buf.shape[-2]
    total = buf[..., 0, :]
    for t in range(1, L):
        total = total + buf[..., t, :]
    count = torch.full_like(total, L)  # a true division, not a reciprocal product
    mean = total / count
    centred = buf - mean.unsqueeze(-2)
    sq = torch.zeros_like(total)
    for t in range(L):
        sq = torch.addcmul(sq, centred[..., t, :], centred[..., t, :])
    std = (sq / count).double().sqrt().to(buf.dtype)
    std = torch.where(std < eps, torch.ones_like(std), std)
    return mean.unsqueeze(-2), std.unsqueeze(-2)
