"""Conditional WGAN: a critic conditioned on the stimulus condition (C4).

Port of :mod:`tcgan_tpu.models.cwgan`. Each sampled circuit yields one
critic sample per stimulus condition: the probe readout for that condition
concatenated with the condition's (bandwidth, contrast) features. Real data
is tagged the same way, in the same condition-major row layout (row
``b * n_stim + s``), so the GP interpolates pair rows of one condition.

The step's schedule, the optimizers, the moment anchor (on the joint
per-circuit vector, ``track_offset_identity=True``), the endgame and drift
latches and the EMA are those of :mod:`tcgan_torch.models.wgan`
(:func:`wgan.run_step`); this module supplies the tagged fake batch and the
conditional losses. Like the WGAN's, they take a leading member axis (an
ensemble, :mod:`tcgan_torch.models.ensemble`) and reduce per member.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tcgan_torch.models import critic as critic_lib
from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models import wgan
from tcgan_torch.models.critic import CriticConfig, device_constant
from tcgan_torch.models.wgan import (StepMetrics, StepNoise, TrainState,
                                     WGANConfig, _wmean, gradient_penalty)

# Same state and init as the unconditional WGAN.
init_state = wgan.init_state


@dataclasses.dataclass(frozen=True)
class CWGANConfig(WGANConfig):
    """WGANConfig whose critic sees (per-condition TC block, condition)."""

    # per-(condition, probe) critic input scale, flat (S*P,), then 2 scales
    # for the (bandwidth, contrast) tag; applied at tagging time so both
    # sides and the GP interpolates live in the scaled space. None = the
    # plain ``input_scale`` path.
    cond_input_scale: Tuple[float, ...] | None = None
    # per-condition loss weights (S,), mean 1. None = uniform.
    cond_weight: Tuple[float, ...] | None = None

    @property
    def cond_dim(self) -> int:
        return 2  # (bandwidth, contrast)

    @property
    def critic_cfg(self) -> CriticConfig:
        return CriticConfig(
            in_dim=self.gen.n_probe + self.cond_dim,
            layers=self.critic_layers,
            dtype=self.gen.dtype,
            input_scale=None if self.cond_input_scale is not None
            else self.input_scale,
        )

    @property
    def critic_batch(self) -> int:
        return self.batch_size * self.gen.n_stim


def _features(cfg: CWGANConfig, dtype, device) -> torch.Tensor:
    """(S, 2) condition features in battery order, cached on ``device``."""
    feats = cfg.gen.condition_features().to(torch.float64)
    return device_constant(tuple(feats.reshape(-1).tolist()), dtype,
                           device).reshape(-1, 2)


def tag_with_conditions(cfg: CWGANConfig, tc_by_cond: torch.Tensor
                        ) -> torch.Tensor:
    """(..., B, S, P) per-condition probe blocks -> (..., B*S, P + 2) tagged
    rows, condition-major within each circuit. With ``cond_input_scale``
    the probe blocks are scaled per (condition, probe) and the tag per
    feature."""
    lead = tc_by_cond.shape[:-3]
    B, S, P = tc_by_cond.shape[-3:]
    feats = _features(cfg, tc_by_cond.dtype, tc_by_cond.device)  # (S, 2)
    if cfg.cond_input_scale is not None:
        scale = device_constant(tuple(cfg.cond_input_scale),
                                tc_by_cond.dtype, tc_by_cond.device)
        tc_by_cond = tc_by_cond * scale[:S * P].reshape(S, P)
        feats = feats * scale[S * P:]
    feats = feats.expand(lead + (B, S, feats.shape[-1]))
    return torch.cat([tc_by_cond, feats], dim=-1).reshape(lead + (B * S, -1))


def cond_row_weights(cfg: CWGANConfig, n_rows: int, dtype=None, device=None
                     ) -> torch.Tensor | None:
    """``cond_weight`` (S,) tiled over the condition-major rows (n_rows,);
    None when off."""
    if cfg.cond_weight is None:
        return None
    w = device_constant(tuple(cfg.cond_weight), dtype or cfg.gen.dtype,
                        device)
    return w.repeat(n_rows // w.shape[0])


def _combine_w(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a * b


def sample_conditional(cfg: CWGANConfig, gen_params, batch: int, *, z=None,
                       generator: torch.Generator | None = None):
    """Generator forward returning (condition-tagged critic rows, output)."""
    out = gen_lib.sample_tuning_curves(
        dataclasses.replace(cfg.gen, track_offset_identity=True),
        gen_params, batch, z=z, generator=generator)
    tc_by_cond = out.tc.reshape(out.tc.shape[:-2] + (
        batch, cfg.gen.n_stim, cfg.gen.n_probe))
    return tag_with_conditions(cfg, tc_by_cond), out


def fake_row_weights(cfg: CWGANConfig, out) -> torch.Tensor | None:
    """Per-row weights matching the fake-truth dataset's selection (a
    circuit counts only if every condition converged), broadcast over the
    circuit's condition rows; when no circuit fully converged, the
    per-solve mask instead, so the generator keeps a gradient back toward
    the convergent region. None unless ``reject_unconverged``."""
    if not cfg.reject_unconverged:
        return None
    convf = out.converged.detach().to(cfg.gen.dtype)  # (..., B, S)
    ok = convf.amin(dim=-1, keepdim=True)  # (..., B, 1)
    strict = ok.expand(convf.shape)
    any_ok = ok.sum(dim=(-2, -1), keepdim=True) > 0.0  # per member
    return torch.where(any_ok, strict, convf).reshape(
        convf.shape[:-2] + (-1,))


def critic_loss_fn(cfg: CWGANConfig, critic_params, real: torch.Tensor,
                   fake: torch.Tensor, eps: torch.Tensor, fake_w=None):
    """Critic loss -W + lambda * GP with per-condition weights; the rank
    accuracy pairs real and fake rows of the same condition only."""
    members = critic_params["w0"].ndim - 2
    d_real = critic_lib.apply(cfg.critic_cfg, critic_params, real)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, fake)
    fake_gp = fake
    if fake_w is not None:
        fake_gp = torch.where(fake_w[..., None] > 0.5, fake,
                              real[..., : fake.shape[-2], :])
    gp = gradient_penalty(cfg, critic_params, real, fake_gp, eps)
    real_cw = cond_row_weights(cfg, d_real.shape[-1], real.dtype,
                               real.device)
    fake_cw = cond_row_weights(cfg, d_fake.shape[-1], real.dtype,
                               real.device)
    wasserstein = (_wmean(d_real, real_cw)
                   - _wmean(d_fake, _combine_w(fake_w, fake_cw)))
    loss = -wasserstein + cfg.gp_lambda * gp
    S = cfg.gen.n_stim
    lead = d_real.shape[:-1]
    dr = d_real.reshape(lead + (-1, S))  # (..., B_real, S)
    df = d_fake.reshape(lead + (-1, S))  # (..., B_fake, S)
    pairs = (dr[..., :, None, :] > df[..., None, :, :]).to(real.dtype)
    if fake_w is None:
        acc = gen_lib.mean_per_member(pairs, members)
    else:
        wf = fake_w.reshape(lead + (-1, S))
        acc = (wgan._sum_per_member(pairs * wf[..., None, :, :], members)
               / torch.clamp(dr.shape[-2]
                             * wgan._sum_per_member(wf, members), min=1.0))
    return loss, (wasserstein, gp, acc)


def gen_loss_fn(cfg: CWGANConfig, gen_params, critic_params, z=None,
                generator: torch.Generator | None = None):
    """Generator loss: negative critic score of the tagged samples + rate
    penalty; the same stats as :func:`wgan.gen_loss_fn`."""
    members = gen_lib.member_axes(gen_params)
    fake, out = sample_conditional(cfg, gen_params, cfg.batch_size, z=z,
                                   generator=generator)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, fake)
    pen = gen_lib.rate_penalty(cfg.gen, out.rates, members)
    stats = (pen,) + wgan.solve_stats(out, members)
    w = _combine_w(fake_row_weights(cfg, out),
                   cond_row_weights(cfg, d_fake.shape[-1], fake.dtype,
                                    fake.device))
    return -_wmean(d_fake, w) + cfg.rate_cost * pen, stats


def train_step_impl(cfg: CWGANConfig, n_critic: int, state: TrainState,
                    real_stack: torch.Tensor, *,
                    noise: StepNoise | None = None,
                    generator: torch.Generator | None = None
                    ) -> Tuple[TrainState, StepMetrics]:
    """One conditional GAN step; ``real_stack`` is (n_critic, B*S, P + 2)
    condition-tagged rows. Noise as in :func:`wgan.train_step_impl`
    (``gp_eps[i]`` is (B*S, 1))."""
    def fake_batch(z):
        fake, out = sample_conditional(cfg, state.gen_params, cfg.batch_size,
                                       z=z)
        return fake, fake_row_weights(cfg, out)

    return wgan.run_step(
        cfg, n_critic, state, real_stack, noise, generator,
        fake_batch=fake_batch, critic_loss=critic_loss_fn,
        gen_loss=gen_loss_fn,
        anchor_gen_cfg=dataclasses.replace(cfg.gen,
                                           track_offset_identity=True))


train_step = train_step_impl
