"""WGAN critic: dense MLP on tuning-curve vectors.

Port of :mod:`tcgan_tpu.models.critic`: an explicit parameter dict
(``w{i}`` of shape (d_in, d_out), ``b{i}`` of shape (d_out,)) and a pure
apply function, so the parameters checkpoint as a plain dict and the
reference's parameters carry across unchanged (:func:`params_from_numpy`).
The optional static per-feature input scale (the reference's normalization
knob: divide TC inputs by the dataset's mean TC) is part of the config.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CriticConfig:
    in_dim: int
    layers: Tuple[int, ...] = (128, 128)
    activation: str = "relu"  # relu | tanh | gelu
    dtype: Any = torch.float32
    input_scale: Tuple[float, ...] | None = None


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
}


def init_params(cfg: CriticConfig, generator: torch.Generator | None = None,
                device=None) -> Dict[str, torch.Tensor]:
    """He-init MLP params: hidden layers + final scalar head."""
    dims = (cfg.in_dim,) + tuple(cfg.layers) + (1,)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = math.sqrt(2.0 / din) * torch.randn(
            (din, dout), generator=generator, dtype=cfg.dtype, device=device)
        params[f"b{i}"] = torch.zeros((dout,), dtype=cfg.dtype, device=device)
    return params


def params_from_numpy(np_params, device=None, dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Critic params from a dict of arrays (e.g. the reference's
    ``init_params`` output through ``np.asarray``), copied."""
    return {k: torch.tensor(np.array(v, copy=True), dtype=dtype,
                            device=device)
            for k, v in np_params.items()}


@functools.lru_cache(maxsize=32)
def device_constant(values: Tuple[float, ...], dtype, device) -> torch.Tensor:
    """A constant table on ``device``, built once: a host->device copy per
    call would sync the host with the stream on every use. Shared; never
    modify it in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def apply(cfg: CriticConfig, params: Dict[str, torch.Tensor],
          x: torch.Tensor) -> torch.Tensor:
    """Critic score, shape (...,) for input (..., in_dim). Member-stacked
    parameters (``w{i}`` (K, d_in, d_out), ``b{i}`` (K, d_out)) score
    input (K, rows, in_dim) member by member."""
    h = x
    if cfg.input_scale is not None:
        h = x * device_constant(cfg.input_scale, x.dtype, x.device)
    # promote like jnp's matmul (the kernel returns fp32 tuning curves
    # whatever the params' dtype)
    h = h.to(torch.promote_types(h.dtype, params["w0"].dtype))
    n_layers = len(cfg.layers)
    act = _ACTIVATIONS[cfg.activation]

    def bias(i):
        b = params[f"b{i}"]
        return b if b.ndim == 1 else b.unsqueeze(-2)  # over a member's rows

    for i in range(n_layers):
        h = act(h @ params[f"w{i}"].to(h.dtype) + bias(i))
    out = h @ params[f"w{n_layers}"].to(h.dtype) + bias(n_layers)
    return out[..., 0]


def param_stats(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-layer L2 norms and maxima (the critic-param stats stream)."""
    out = {}
    for k, v in params.items():
        out[f"{k}.nnorm"] = torch.linalg.vector_norm(v.reshape(-1))
        out[f"{k}.absmax"] = v.abs().max()
    return out
