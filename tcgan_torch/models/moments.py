"""Moment matching: the non-adversarial fit (config C5), and the moment
helpers shared with the WGAN moment anchor and rejection masks.

Port of :mod:`tcgan_tpu.models.moments`. The loss is the weighted squared
distance between generated and data tuning-curve moments (per-feature means
and second moments), each error normalized by the data moment's scale:

    L = mean_m [ (m_gen - m_data)^2 / (|m_data| + eps)^2 ]

optimized with Adam (after a global-norm clip when ``clip_grad > 0``) on
the generator parameters. Options: survivor-masked generated moments (the
fake-truth dataset keeps only fully converged circuits), an EMA of the
generated moments across steps with a two-phase decay, and a fixed z-set
(common random numbers).

Differences of form from the reference: ``MMState.step`` is a host int;
the fixed z-set itself is kept in the state (``fixed_z``, drawn at init
from a ``torch.Generator`` seeded with ``cfg.seed``), where the reference
keeps the key it redraws it from; noise is injected (``z=``) or drawn from a
``torch.Generator``.

A state with a leading member axis on every leaf (an ensemble of K fits,
:mod:`tcgan_torch.models.ensemble`) steps all K at once, with per-member
losses, moment EMAs and metrics; the data moments are shared ((F,),
(F, F)) or per member ((K, F), (K, F, F)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models.generator import GeneratorConfig, mean_per_member
from tcgan_torch.ops import weights


@dataclasses.dataclass(frozen=True)
class MomentMatchingConfig:
    """The reference's fields and defaults (see
    :class:`tcgan_tpu.models.moments.MomentMatchingConfig`)."""

    gen: GeneratorConfig = GeneratorConfig()
    batch_size: int = 64
    lr: float = 1e-3
    beta1: float = 0.5
    beta2: float = 0.9
    mean_weight: float = 1.0
    cov_weight: float = 1.0
    moment_eps: float = 1e-2
    rate_cost: float = 0.01
    clip_grad: float = 0.0  # global-norm gradient clip (0 = off)
    seed: int = 0
    # common random numbers: one fixed z-set every step
    fixed_z: bool = False
    # mask non-converged circuits out of the generated moments
    survivor_mask: bool = True
    # EMA decay of the generated moments (0 = off), switched to
    # moment_ema_late at moment_ema_switch_step (0 = no switch)
    moment_ema: float = 0.0
    moment_ema_late: float = 0.0
    moment_ema_switch_step: int = 0

    def __post_init__(self):
        if self.moment_ema_late > 0 and self.moment_ema <= 0:
            raise ValueError(
                "moment_ema_late > 0 requires moment_ema > 0 (the EMA "
                "branch is gated on the base gamma; --moment-ema-late "
                "with --moment-ema 0 would silently run without any EMA)")


def effective_gamma(cfg, step: int, base=None, late=None, switch=None):
    """EMA decay at step ``step`` (a host int) under the two-phase gamma
    schedule: ``late`` from step ``switch`` on, ``base`` before (and
    always when the switch is off)."""
    base = cfg.moment_ema if base is None else base
    late = cfg.moment_ema_late if late is None else late
    switch = cfg.moment_ema_switch_step if switch is None else switch
    if switch <= 0 or late <= 0:
        return base
    return late if step >= switch else base


class MMState(NamedTuple):
    gen_params: Dict[str, torch.Tensor]
    opt: Any
    step: int
    # EMA of the generated (mean, second) moments and the number of
    # batches blended in (moment_ema > 0 only)
    ema_mean: Any = None
    ema_second: Any = None
    ema_count: Any = None
    # the z-set every step reuses (fixed_z only), shaped as
    # weights.sample_z draws it
    fixed_z: Any = None


class MMMetrics(NamedTuple):
    loss: torch.Tensor
    mean_err: torch.Tensor
    cov_err: torch.Tensor
    rate_penalty: torch.Tensor
    frac_converged: torch.Tensor
    frac_diverged: torch.Tensor


def data_moments(tc: torch.Tensor, weights: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean vector, second-moment matrix) of TC samples (..., B, D),
    optionally sample-weighted (weights (..., B)). The weight sum has an
    epsilon floor (soft survivor weights can sum below 1); an all-zero mask
    is the caller's to guard."""
    if weights is None:
        return tc.mean(dim=-2), tc.mT @ tc / tc.shape[-2]
    w = weights.to(tc.dtype)
    n = torch.clamp(w.sum(-1), min=1e-6)[..., None]
    mean = (tc * w[..., None]).sum(dim=-2) / n
    second = (tc * w[..., None]).mT @ tc / n[..., None]
    return mean, second


def survivor_chain(conv: torch.Tensor, dtype) -> torch.Tensor:
    """Per-circuit survivor weights (..., B) with an absorbing-state
    fallback: 1 where every condition of the circuit converged (the
    fake-truth dataset's selection); when no circuit of the batch (of a
    member's batch) fully converged, the fraction of converged conditions
    instead, so the gradient is not deleted. Not differentiable."""
    convf = conv.detach().to(dtype)  # (..., B, S)
    strict = convf.amin(dim=-1)
    soft = convf.mean(dim=-1)
    return torch.where(strict.sum(-1, keepdim=True) > 0.0, strict, soft)


def sample_mask(cfg: MomentMatchingConfig, out) -> torch.Tensor:
    """Per-critic-sample survivor weights (float32, as the reference),
    repeated over a circuit's probe rows unless the probes are one
    joint sample."""
    ok = survivor_chain(out.converged, torch.float32)  # (..., B)
    if cfg.gen.track_offset_identity:
        return ok
    return ok.repeat_interleave(cfg.gen.n_probe, dim=-1)


def _moment_weights(cfg, data_mean, data_second):
    return (1.0 / (data_mean.abs() + cfg.moment_eps) ** 2,
            1.0 / (data_second.abs() + cfg.moment_eps) ** 2)


def moment_loss(cfg: MomentMatchingConfig, gen_tc, data_mean, data_second,
                weights=None, members: int = 0):
    """The normalized moment distance; returns (loss, (mean_err,
    cov_err)), per member with ``members`` leading axes."""
    gmean, gsecond = data_moments(gen_tc, weights)
    wm, wc = _moment_weights(cfg, data_mean, data_second)
    mean_err = mean_per_member(wm * (gmean - data_mean) ** 2, members)
    cov_err = mean_per_member(wc * (gsecond - data_second) ** 2, members)
    return (cfg.mean_weight * mean_err + cfg.cov_weight * cov_err,
            (mean_err, cov_err))


def make_optimizer(cfg: MomentMatchingConfig):
    """``optax.adam`` chained after ``clip_by_global_norm`` when
    ``clip_grad > 0``; no finite guard (the reference has none here)."""
    from tcgan_torch.models.wgan import Adam

    return Adam(lr=cfg.lr, b1=cfg.beta1, b2=cfg.beta2, clip=cfg.clip_grad,
                finite_guard=False)


def init_state(cfg: MomentMatchingConfig,
               gen_init: Dict[str, torch.Tensor] | None = None,
               fixed_z=None, device=None) -> MMState:
    """Fresh state at ``gen_init`` (default: the config's defaults). With
    ``cfg.fixed_z`` the state holds the z-set: ``fixed_z`` when given,
    else one draw from a ``torch.Generator`` seeded with ``cfg.seed``."""
    if gen_init is not None:
        device = next(iter(gen_init.values())).device
    device = torch.device(device or "cpu")
    gen_params = (gen_init if gen_init is not None
                  else gen_lib.init_params(cfg.gen, device=device))
    d, dtype = cfg.gen.tc_dim, cfg.gen.dtype
    ema = cfg.moment_ema > 0
    z = None
    if cfg.fixed_z:
        if fixed_z is None:
            n_draw = (cfg.batch_size // 2 if cfg.gen.antithetic
                      else cfg.batch_size)
            fixed_z = weights.sample_z(
                torch.Generator(device).manual_seed(cfg.seed), (n_draw,),
                cfg.gen.ssn.N, device=device, dtype=dtype)
        z = torch.as_tensor(fixed_z, dtype=dtype, device=device)
    return MMState(
        gen_params, make_optimizer(cfg).init(gen_params), 0,
        ema_mean=torch.zeros((d,), dtype=dtype, device=device) if ema
        else None,
        ema_second=torch.zeros((d, d), dtype=dtype, device=device) if ema
        else None,
        ema_count=torch.zeros((), dtype=dtype, device=device) if ema
        else None,
        fixed_z=z,
    )


def train_step_impl(cfg: MomentMatchingConfig, state: MMState,
                    data_mean: torch.Tensor, data_second: torch.Tensor, *,
                    z=None, generator: torch.Generator | None = None
                    ) -> Tuple[MMState, MMMetrics]:
    """One Adam step on the moment loss of a fresh generator batch: the
    state's z-set under ``cfg.fixed_z``, else ``z`` when given, else a draw
    from ``generator``."""
    from tcgan_torch.models.wgan import _grad, _leaves, apply_updates

    if cfg.fixed_z:
        z = state.fixed_z
    elif z is None and generator is None:
        raise ValueError("train_step_impl needs z= or generator=")
    tx = make_optimizer(cfg)
    members = gen_lib.member_axes(state.gen_params)
    leaves = _leaves(state.gen_params)
    out = gen_lib.sample_tuning_curves(cfg.gen, leaves, cfg.batch_size, z=z,
                                       generator=generator)
    w = sample_mask(cfg, out) if cfg.survivor_mask else None
    ema = (None, None, None)
    if cfg.moment_ema > 0:
        # blend the batch moments into the EMA (no gradient through the
        # history, debiased like Adam) and penalize the EMA's residual; a
        # batch with no survivors is not an estimate: the EMA and its
        # count hold
        g = effective_gamma(cfg, state.step)
        bmean, bsecond = data_moments(out.tc, w)
        has_data = (w.sum(-1) > 0 if w is not None
                    else torch.ones(bmean.shape[:-1], dtype=torch.bool,
                                    device=bmean.device))
        new_em = torch.where(has_data[..., None],
                             g * state.ema_mean + (1 - g) * bmean,
                             state.ema_mean)
        new_es = torch.where(has_data[..., None, None],
                             g * state.ema_second + (1 - g) * bsecond,
                             state.ema_second)
        new_count = state.ema_count + has_data.to(bmean.dtype)
        debias = torch.clamp(1.0 - g ** new_count, min=1e-12)[..., None]
        wm, wc = _moment_weights(cfg, data_mean, data_second)
        me = mean_per_member(wm * (new_em / debias - data_mean) ** 2, members)
        ce = mean_per_member(
            wc * (new_es / debias[..., None] - data_second) ** 2, members)
        mloss = cfg.mean_weight * me + cfg.cov_weight * ce
        ema = (new_em.detach(), new_es.detach(), new_count.detach())
    else:
        mloss, (me, ce) = moment_loss(cfg, out.tc, data_mean, data_second,
                                      weights=w, members=members)
    pen = gen_lib.rate_penalty(cfg.gen, out.rates, members)
    loss = mloss + cfg.rate_cost * pen
    updates, opt = tx.update(_grad(loss, leaves), state.opt)
    metrics = MMMetrics(
        loss.detach(), me.detach(), ce.detach(), pen.detach(),
        mean_per_member(out.converged.to(torch.float32), members),
        mean_per_member(out.diverged.to(torch.float32), members))
    return MMState(apply_updates(state.gen_params, updates), opt,
                   state.step + 1, ema_mean=ema[0], ema_second=ema[1],
                   ema_count=ema[2], fixed_z=state.fixed_z), metrics


# PyTorch runs eagerly: the step the driver calls is the implementation.
train_step = train_step_impl
