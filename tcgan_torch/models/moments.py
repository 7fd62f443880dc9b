"""Moment helpers shared by the WGAN moment anchor and rejection masks.

Port of the parts of :mod:`tcgan_tpu.models.moments` that
:mod:`tcgan_torch.models.wgan` uses: the two-phase EMA decay
(``effective_gamma``), weighted data moments and the per-circuit survivor
weights. The moment-matching objective itself waits for ROADMAP Queue 1,
item 15.
"""

from __future__ import annotations

from typing import Tuple

import torch


def effective_gamma(cfg, step: int, base=None, late=None, switch=None):
    """EMA decay at GAN step ``step`` (a host int) under the two-phase
    gamma schedule: ``late`` from step ``switch`` on, ``base`` before (and
    always when the switch is off)."""
    base = cfg.moment_ema if base is None else base
    late = cfg.moment_ema_late if late is None else late
    switch = cfg.moment_ema_switch_step if switch is None else switch
    if switch <= 0 or late <= 0:
        return base
    return late if step >= switch else base


def data_moments(tc: torch.Tensor, weights: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean vector, second-moment matrix) of TC samples (B, D), optionally
    sample-weighted. The weight sum has an epsilon floor (soft survivor
    weights can sum below 1); an all-zero mask is the caller's to guard."""
    if weights is None:
        return tc.mean(dim=0), tc.T @ tc / tc.shape[0]
    w = weights.to(tc.dtype)
    n = torch.clamp(w.sum(), min=1e-6)
    mean = (tc * w[:, None]).sum(dim=0) / n
    second = (tc * w[:, None]).T @ tc / n
    return mean, second


def survivor_chain(conv: torch.Tensor, dtype) -> torch.Tensor:
    """Per-circuit survivor weights (B,) with an absorbing-state fallback:
    1 where every condition of the circuit converged (the fake-truth
    dataset's selection); when no circuit of the batch fully converged, the
    fraction of converged conditions instead, so the gradient is not
    deleted. Not differentiable."""
    convf = conv.detach().to(dtype)  # (B, S)
    strict = convf.amin(dim=-1)
    soft = convf.mean(dim=-1)
    return torch.where(strict.sum() > 0.0, strict, soft)
