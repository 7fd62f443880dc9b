"""Bandwidth x contrast stimulus battery for tuning-curve sweeps.

Port of :mod:`tcgan_tpu.ops.stimulus`. The stimulus is a bar of width b
centered on the grid at contrast c; the input to a neuron with preferred
position x is the smoothed boxcar

    I(x; b, c) = c * sigmoid((b/2 - |x|) / smoothness)

applied identically to the E and I neurons at each site.
"""

from __future__ import annotations

import torch

from tcgan_torch.utils import profiling


def _sigmoid(y):
    return 0.5 * (torch.tanh(y / 2.0) + 1.0)


def smooth_box(x, bandwidth, smoothness):
    """Smoothed boxcar of width ``bandwidth`` centered at 0, evaluated at x."""
    return _sigmoid((bandwidth / 2.0 - torch.abs(x)) / smoothness)


def stimulus_battery(bandwidths, contrasts, x, smoothness) -> torch.Tensor:
    """Build the full stimulus battery.

    Args:
      bandwidths: (n_b,) bar widths (same units as x).
      contrasts: (n_c,) contrast levels.
      x: (N,) site positions; sets the dtype and device.
      smoothness: edge-smoothing length scale.

    Returns:
      I_ext: (n_c * n_b, 2N), one row per stimulus condition, contrast-major
      (condition index ``s = ic * n_b + ib``), duplicated over E and I.
    """
    # two copies from host memory, each a blocking transfer to a device
    with profiling.host_sync("generator.battery"):
        bandwidths = torch.as_tensor(bandwidths, dtype=x.dtype,
                                     device=x.device)
    with profiling.host_sync("generator.battery"):
        contrasts = torch.as_tensor(contrasts, dtype=x.dtype, device=x.device)
    box = smooth_box(x[None, :], bandwidths[:, None], smoothness)  # (n_b, N)
    per_cond = contrasts[:, None, None] * box[None, :, :]  # (n_c, n_b, N)
    flat = per_cond.reshape(-1, x.shape[0])  # (n_c*n_b, N)
    return torch.cat([flat, flat], dim=-1)  # (S, 2N)


def condition_features(bandwidths, contrasts, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Per-condition (bandwidth, contrast) rows in battery order."""
    bandwidths = torch.as_tensor(bandwidths, dtype=dtype, device=device)
    contrasts = torch.as_tensor(contrasts, dtype=dtype, device=device)
    bb = bandwidths.repeat(contrasts.shape[0])
    cc = contrasts.repeat_interleave(bandwidths.shape[0])
    return torch.stack([bb, cc], dim=-1)  # (S, 2)
