"""WGAN-GP training assembly: losses, optax-exact Adam, the train step.

Port of :mod:`tcgan_tpu.models.wgan`. One GAN step (:func:`train_step_impl`)
runs ``n_critic`` critic updates, each on a fresh fake batch solved forward
only, then one generator update that backpropagates through the fixed point
by the implicit function theorem (:mod:`tcgan_torch.ops.ift`), then the
optional moment-anchor updates.

Differences of form from the reference, not of behavior:

- The step is eager PyTorch. Nothing in it copies device->host except the
  adjoint's per-chunk stop test: the optimizers' skip-on-non-finite
  decisions are ``torch.where`` selections on the device, as ``lax.cond``
  is there.
- Noise comes from an explicit ``torch.Generator``, or is injected
  (:class:`StepNoise`): the fake-batch z and GP eps of each critic
  iteration, the generator update's z and the z of each anchor update.
- ``TrainState.step`` is a host int.
- Adam is written out (:class:`Adam`) to reproduce optax's
  ``apply_if_finite(chain(clip_by_global_norm, adam))`` exactly: eps 1e-8
  outside the square root, bias correction, the schedule read at the
  pre-increment count, clipping before Adam, and a skipped update that
  leaves the whole inner state (the schedule's count included) unchanged,
  so the learning rate follows applied updates, not GAN steps.

The late anchor gamma switches at a step (``anchor_ema_switch_step``) or
latches on the parameters' own motion (``anchor_ema_switch_drift``, the
ratio detector, or ``anchor_ema_switch_vel``, the velocity detector; see
:func:`next_drift_latch`). The latch state lives on the device.

:func:`run_step` is the step's schedule, shared with the conditional WGAN
(:mod:`tcgan_torch.models.cwgan`), which supplies its own fake batch and
losses.

Member axis (:mod:`tcgan_torch.models.ensemble`): when every leaf of the
state carries a leading axis of K independent fits, the same step runs all
K at once. Each reduction is taken per member (losses, GP, metrics, Adam's
finite guard and global-norm clip, the optimizer counts), every metric has
shape (K,), each solve is one kernel launch for all members, and the
members' losses are summed for one backward pass: no member shares a
parameter with another, so each gets its own exact gradient. The moment
anchor and its latches are single-fit only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tcgan_torch.models import critic as critic_lib
from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models.critic import CriticConfig
from tcgan_torch.models.generator import GeneratorConfig
from tcgan_torch.models.moments import (data_moments, effective_gamma,
                                        survivor_chain)
from tcgan_torch.ops import weights
from tcgan_torch.utils import profiling

Params = Dict[str, torch.Tensor]
_INT32_MAX = 2**31 - 1
_ADAM_EPS = 1e-8  # optax.adam's default, outside the square root
_MAX_CONSECUTIVE_ERRORS = 100  # the reference's apply_if_finite setting


@dataclasses.dataclass(frozen=True)
class WGANConfig:
    """Static GAN hyper-parameters (the reference's fields and defaults;
    see :class:`tcgan_tpu.models.wgan.WGANConfig` for the rationale of
    each lever)."""

    gen: GeneratorConfig = GeneratorConfig()
    critic_layers: Tuple[int, ...] = (128, 128)
    batch_size: int = 64  # circuits sampled per generator-side batch
    gp_lambda: float = 10.0
    n_critic: int = 5
    n_critic0: int = 50  # first-step warm-up
    lr_gen: float = 1e-4
    lr_critic: float = 1e-3
    beta1: float = 0.5
    beta2: float = 0.9
    rate_cost: float = 0.01  # generator penalty on rates above soft bound
    clip_grad: float = 0.0  # global-norm gradient clip (0 = off)
    # drop non-converged fake circuits from the critic objective
    reject_unconverged: bool = False
    # exponential lr decay: lr * rate^(step/steps); 0 steps = constant lr
    lr_decay_steps: int = 0
    lr_decay_rate: float = 0.5
    # critic-cooling endgame: the adversarial generator lr's floor, a
    # hard switch to it at a step, or a latch on the anchor residual
    gen_lr_floor: float = 0.0
    gen_lr_switch_step: int = 0
    gen_lr_switch_residual: float = 0.0
    gen_lr_switch_min_step: int = 0
    # critic-side decay horizon: -1 = follow lr_decay_steps; 0 = constant
    critic_lr_decay_steps: int = -1
    ema_decay: float = 0.0  # EMA of the generator params (0 = off)
    seed: int = 0
    # per-feature critic input scale (None = raw inputs)
    input_scale: Tuple[float, ...] | None = None
    # moment anchor: an extra Adam update per GAN step on the moment
    # residual, with this lr (0 = off)
    moment_anchor: float = 0.0
    moment_ema: float = 0.995
    # two-phase anchor gamma: moment_ema -> anchor_ema_late at a step
    anchor_ema_late: float = 0.0
    anchor_ema_switch_step: int = 0
    # latched late gamma: the max over components of |EMA(delta)| /
    # EMA(|delta|) (drift) or of the debiased |EMA(delta)| in %-per-1k
    # steps (vel) first drops below the threshold, from the arming step
    # anchor_ema_switch_step on (0 = off; vel is the recommended detector)
    anchor_ema_switch_drift: float = 0.0
    anchor_ema_switch_vel: float = 0.0
    anchor_drift_ema: float = 0.995
    moment_eps: float = 1e-2  # moment-normalization floor
    anchor_beta1: float | None = None  # None = beta1
    anchor_updates: int = 1  # anchor Adam updates per GAN step

    @property
    def critic_cfg(self) -> CriticConfig:
        return CriticConfig(
            in_dim=self.gen.tc_dim, layers=self.critic_layers,
            dtype=self.gen.dtype, input_scale=self.input_scale,
        )

    @property
    def critic_batch(self) -> int:
        """Number of critic-side samples one generator batch yields."""
        return self.batch_size * self.gen.samples_per_circuit()


class TrainState(NamedTuple):
    gen_params: Params
    gen_opt: Any
    critic_params: Params
    critic_opt: Any
    step: int
    ema_params: Any = None
    # moment-anchor buffers (moment_anchor > 0 only)
    data_mean: Any = None
    data_second: Any = None
    mom_ema_mean: Any = None
    mom_ema_second: Any = None
    mom_ema_count: Any = None
    anchor_opt: Any = None
    # critic-cooling latch (gen_lr_switch_residual > 0 only)
    endgame: Any = None
    # latched late-gamma state (a latch detector on only): EMAs of the
    # per-step parameter deltas, signed and absolute, and the latch
    drift_dir: Any = None
    drift_mag: Any = None
    gamma_late: Any = None


class StepMetrics(NamedTuple):
    """Per-step learning stats (the learning.csv columns)."""

    d_loss: torch.Tensor
    g_loss: torch.Tensor
    wasserstein: torch.Tensor
    gp: torch.Tensor
    rate_penalty: torch.Tensor
    frac_converged: torch.Tensor
    frac_diverged: torch.Tensor
    mean_iters: torch.Tensor
    d_accuracy: torch.Tensor
    d_loss_iters: torch.Tensor | None = None
    wasserstein_iters: torch.Tensor | None = None
    gp_iters: torch.Tensor | None = None
    acc_iters: torch.Tensor | None = None
    anchor_residual: torch.Tensor | None = None
    circuit_yield: torch.Tensor | None = None
    drift_ratio: torch.Tensor | None = None


class StepNoise(NamedTuple):
    """Injected noise of one GAN step. ``critic_z[i]`` and ``gp_eps[i]``
    ((critic_batch, 1)) feed critic iteration i, ``gen_z`` the generator
    update and ``anchor_z[k]`` anchor update k; each z is shaped as
    :func:`tcgan_torch.ops.weights.sample_z` would draw it."""

    critic_z: Sequence[Any]
    gp_eps: Sequence[Any]
    gen_z: Any
    anchor_z: Sequence[Any] | None = None


def draw_step_noise(cfg: WGANConfig, n_critic: int, real_stack,
                    generator: torch.Generator) -> StepNoise:
    """The noise of one step on ``real_stack`` (its layout: (n_critic, ...,
    rows, d), any member axes after the first), drawn from ``generator``:
    the step's only draw path (:func:`run_step` calls it when no noise is
    injected), so a sharded ensemble step that draws it for all members and
    keeps its own equals the unsharded step."""
    lead = tuple(real_stack.shape[1:-2])
    n_draw = cfg.batch_size // 2 if cfg.gen.antithetic else cfg.batch_size
    device = real_stack.device

    def z():
        return weights.sample_z(generator, lead + (n_draw,), cfg.gen.ssn.N,
                                device=device, dtype=cfg.gen.dtype)

    critic_z, gp_eps = [], []
    for i in range(n_critic):
        critic_z.append(z())
        gp_eps.append(torch.rand(real_stack[i].shape[:-1] + (1,),
                                 generator=generator, dtype=real_stack.dtype,
                                 device=device))
    gen_z = z()
    anchor_z = ([z() for _ in range(max(1, int(cfg.anchor_updates)))]
                if cfg.moment_anchor > 0 else None)
    return StepNoise(critic_z, gp_eps, gen_z, anchor_z)


# -- optax-exact Adam ------------------------------------------------------


def constant_schedule(value: float) -> Callable:
    return lambda count: torch.full((), value, dtype=torch.float64,
                                    device=count.device)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, end_value: float | None = None
                      ) -> Callable:
    """``optax.exponential_decay`` (no staircase, no transition_begin):
    count -> init * rate^(count/steps), clamped at ``end_value``. Like
    optax on an int32 count tensor, it computes in float32."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def sched(count):
        c = count.to(torch.float32)
        v = torch.where(c <= 0, init_value,
                        init_value * decay_rate ** (c / transition_steps))
        if end_value is not None:
            bound = torch.full_like(v, end_value)
            v = torch.maximum(v, bound) if decay_rate < 1 else \
                torch.minimum(v, bound)
        return v

    return sched


class AdamState(NamedTuple):
    """State of ``apply_if_finite(chain(clip, adam))``: Adam's count (equal
    to the schedule's count, which optax keeps separately), moments, and
    the finite-guard counters."""

    count: torch.Tensor  # int32
    mu: Params
    nu: Params
    notfinite_count: torch.Tensor  # int32
    last_finite: torch.Tensor  # bool
    total_notfinite: torch.Tensor  # int32


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (one value per member, or a scalar) broadcastable against
    ``like``, whose leading axes are the members."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax's safe_increment: saturates at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


@dataclasses.dataclass(frozen=True)
class Adam:
    """Functional ``optax.apply_if_finite(optax.chain(
    optax.clip_by_global_norm(clip), optax.adam(lr, b1, b2)), 100)``;
    ``clip`` 0 drops the clip, ``finite_guard`` False drops
    ``apply_if_finite`` (every update applies; its counters stay at their
    init values). ``lr`` is a float or a schedule (int32 count tensor ->
    scalar tensor). A state whose counters have a member axis (K,) updates
    each member on its own: its own finite test, clip norm and count."""

    lr: float | Callable
    b1: float
    b2: float
    clip: float = 0.0
    finite_guard: bool = True

    def init(self, params: Params) -> AdamState:
        device = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return AdamState(
            count=zero,
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            notfinite_count=zero,
            last_finite=torch.ones((), dtype=torch.bool, device=device),
            total_notfinite=zero)

    def update(self, grads: Params, state: AdamState
               ) -> Tuple[Params, AdamState]:
        keys = sorted(grads)  # the reference's leaf order
        members = state.count.ndim
        if self.finite_guard:
            finite = torch.stack([torch.isfinite(grads[k]).flatten(members)
                                  .all(-1) for k in keys]).all(0)
            notfinite_count = torch.where(finite, torch.zeros_like(
                state.notfinite_count), _inc(state.notfinite_count))
            apply = finite | (notfinite_count > _MAX_CONSECUTIVE_ERRORS)
        else:
            finite, notfinite_count = state.last_finite, state.notfinite_count
            apply = torch.ones((), dtype=torch.bool,
                               device=state.count.device)

        g = grads
        if self.clip > 0:
            g_norm = torch.sqrt(sum(_sum_per_member(g[k] * g[k], members)
                                    for k in keys))
            trigger = g_norm < self.clip
            g = {k: torch.where(
                _per_member(trigger, g[k]), g[k],
                (g[k] / _per_member(g_norm, g[k]).to(g[k].dtype)) * self.clip)
                 for k in keys}
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in keys}
        nu = {k: (1 - b2) * g[k] ** 2 + b2 * state.nu[k] for k in keys}
        count_inc = _inc(state.count)
        bc1 = 1 - b1 ** count_inc.to(torch.float64)
        bc2 = 1 - b2 ** count_inc.to(torch.float64)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        updates, mask = {}, {}
        for k in keys:
            dtype = g[k].dtype
            u = (mu[k] / _per_member(bc1, mu[k]).to(dtype)) / (
                torch.sqrt(nu[k] / _per_member(bc2, nu[k]).to(dtype))
                + _ADAM_EPS)
            step = (_per_member(-lr, u).to(dtype) if torch.is_tensor(lr)
                    else -lr)
            mask[k] = _per_member(apply, u)
            updates[k] = torch.where(mask[k], step * u, 0.0)
        return updates, AdamState(
            count=torch.where(apply, count_inc, state.count),
            mu={k: torch.where(mask[k], mu[k], state.mu[k]) for k in keys},
            nu={k: torch.where(mask[k], nu[k], state.nu[k]) for k in keys},
            notfinite_count=notfinite_count,
            last_finite=finite,
            total_notfinite=torch.where(finite, state.total_notfinite,
                                        _inc(state.total_notfinite)))


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: params[k] + updates[k] for k in params}


def gen_lr_schedule(cfg: WGANConfig) -> Callable:
    """The adversarial generator lr as a function of the update count: the
    exponential decay clamped below at ``gen_lr_floor``, switched to the
    floor from ``gen_lr_switch_step`` on."""
    if cfg.lr_decay_steps > 0:
        base = exponential_decay(
            cfg.lr_gen, cfg.lr_decay_steps, cfg.lr_decay_rate,
            end_value=cfg.gen_lr_floor if cfg.gen_lr_floor > 0 else None)
    else:
        base = constant_schedule(cfg.lr_gen)
    if cfg.gen_lr_switch_step <= 0:
        return base
    switch, floor = cfg.gen_lr_switch_step, cfg.gen_lr_floor

    def sched(count):
        return torch.where(count >= switch, floor, base(count))

    return sched


def make_optimizers(cfg: WGANConfig) -> Tuple[Adam, Adam]:
    """(generator, critic) optimizers."""
    def tx(lr):
        return Adam(lr=lr, b1=cfg.beta1, b2=cfg.beta2, clip=cfg.clip_grad)

    critic_decay = (cfg.lr_decay_steps if cfg.critic_lr_decay_steps < 0
                    else cfg.critic_lr_decay_steps)
    critic_lr = cfg.lr_critic
    if critic_decay > 0:
        critic_lr = exponential_decay(cfg.lr_critic, critic_decay,
                                      cfg.lr_decay_rate)
    return tx(gen_lr_schedule(cfg)), tx(critic_lr)


def make_anchor_optimizer(cfg: WGANConfig) -> Adam:
    """The anchor's own Adam: constant lr = moment_anchor, beta1
    overridable via anchor_beta1, same clip and finite guard."""
    b1 = cfg.beta1 if cfg.anchor_beta1 is None else cfg.anchor_beta1
    return Adam(lr=cfg.moment_anchor, b1=b1, b2=cfg.beta2, clip=cfg.clip_grad)


# -- state -----------------------------------------------------------------


def _check_config(cfg: WGANConfig):
    if cfg.gen_lr_switch_residual > 0 and cfg.moment_anchor <= 0:
        raise ValueError("gen_lr_switch_residual triggers on the moment "
                         "anchor's residual — it requires moment_anchor > 0")
    if cfg.anchor_ema_late > 0 and cfg.moment_anchor <= 0:
        raise ValueError("anchor_ema_late schedules the moment anchor's "
                         "EMA — it requires moment_anchor > 0")
    for field in ("anchor_ema_switch_drift", "anchor_ema_switch_vel"):
        if getattr(cfg, field) > 0 and cfg.anchor_ema_late <= 0:
            raise ValueError(f"{field} latches the LATE anchor gamma — it "
                             "requires anchor_ema_late > 0")
    if cfg.anchor_ema_switch_vel > 0 and cfg.anchor_ema_switch_drift > 0:
        raise ValueError("anchor_ema_switch_vel and anchor_ema_switch_drift "
                         "are two detectors for the same latch — pick one")


def _latched(cfg: WGANConfig) -> bool:
    return cfg.anchor_ema_switch_drift > 0 or cfg.anchor_ema_switch_vel > 0


def anchor_buffers(cfg: WGANConfig, data_moments, gen_params: Params
                   ) -> dict:
    """TrainState moment-anchor fields: frozen data moments, the
    zero-initialized generated-moment EMA and the anchor Adam state."""
    if cfg.moment_anchor <= 0:
        return {}
    if data_moments is None:
        raise ValueError("moment_anchor > 0 requires data_moments="
                         "(mean, second) at init_state time")
    dm, ds = data_moments
    dtype = cfg.gen.dtype
    device = next(iter(gen_params.values())).device
    dm, ds = (torch.as_tensor(m if torch.is_tensor(m) else np.array(m),
                              dtype=dtype, device=device) for m in (dm, ds))
    return dict(
        data_mean=dm, data_second=ds,
        mom_ema_mean=torch.zeros_like(dm),
        mom_ema_second=torch.zeros_like(ds),
        mom_ema_count=torch.zeros((), dtype=dtype, device=device),
        anchor_opt=make_anchor_optimizer(cfg).init(gen_params),
    )


def init_state(cfg: WGANConfig, generator: torch.Generator | None = None,
               gen_init: Params | None = None, data_moments=None,
               device=None) -> TrainState:
    """Fresh state: ``gen_init`` (default: the config's defaults) and
    He-initialized critic params drawn from ``generator`` (default: one
    seeded with ``cfg.seed``) on ``device`` (default: that of
    ``gen_init``, else the CPU)."""
    if gen_init is not None:
        device = next(iter(gen_init.values())).device
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(cfg.seed)
    _check_config(cfg)
    gen_params = (gen_init if gen_init is not None
                  else gen_lib.init_params(cfg.gen, device=device))
    critic_params = critic_lib.init_params(cfg.critic_cfg, generator, device)
    gen_tx, critic_tx = make_optimizers(cfg)
    return TrainState(
        gen_params=gen_params,
        gen_opt=gen_tx.init(gen_params),
        critic_params=critic_params,
        critic_opt=critic_tx.init(critic_params),
        step=0,
        ema_params=({k: v.clone() for k, v in gen_params.items()}
                    if cfg.ema_decay > 0 else None),
        endgame=(torch.zeros((), dtype=torch.bool, device=device)
                 if cfg.gen_lr_switch_residual > 0 else None),
        drift_dir=({k: torch.zeros_like(v) for k, v in gen_params.items()}
                   if _latched(cfg) else None),
        drift_mag=({k: torch.zeros_like(v) for k, v in gen_params.items()}
                   if _latched(cfg) else None),
        gamma_late=(torch.zeros((), dtype=torch.bool, device=device)
                    if _latched(cfg) else None),
        **anchor_buffers(cfg, data_moments, gen_params),
    )


# -- losses ----------------------------------------------------------------


def _leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grad(loss: torch.Tensor, leaves: Params) -> Params:
    """Gradient of ``loss`` with respect to ``leaves``; a per-member loss
    (K,) is summed first, which gives each member its own gradient."""
    if loss.ndim:
        loss = loss.sum()
    keys = list(leaves)
    return dict(zip(keys, torch.autograd.grad(loss, [leaves[k]
                                                     for k in keys])))


def gradient_penalty(cfg: WGANConfig, critic_params: Params,
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP interpolate penalty E[(||grad_xhat D|| - 1)^2], eps of
    shape (batch, 1) (after the member axis, if any). The critic maps rows
    independently, so the gradient of the summed score is each row's input
    gradient."""
    members = _critic_members(critic_params)
    xhat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    score = critic_lib.apply(cfg.critic_cfg, critic_params, xhat)
    grads, = torch.autograd.grad(score.sum(), xhat, create_graph=True)
    norms = torch.sqrt(torch.sum(
        grads ** 2, dim=tuple(range(1 + members, grads.ndim))) + 1e-12)
    return gen_lib.mean_per_member((norms - 1.0) ** 2, members)


def _critic_members(critic_params: Params) -> int:
    return critic_params["w0"].ndim - 2


def survivor_weights(cfg: WGANConfig, out) -> torch.Tensor:
    """Per-critic-sample survivor weights: per circuit (see
    :func:`survivor_chain`), repeated over that circuit's samples."""
    ok = survivor_chain(out.converged, cfg.gen.dtype)  # (..., B)
    if cfg.gen.track_offset_identity:
        return ok
    return ok.repeat_interleave(cfg.gen.samples_per_circuit(), dim=-1)


def fake_sample_weights(cfg: WGANConfig, out) -> torch.Tensor | None:
    """Survivor weights when ``reject_unconverged`` is on, else None."""
    if not cfg.reject_unconverged:
        return None
    return survivor_weights(cfg, out)


def _wmean(x: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """Weighted mean of the rows ``x`` (..., n), per member."""
    if w is None:
        return x.mean(-1)
    # degeneracy guard: every row masked out -> the unweighted mean, not a
    # silent zero that would make the critic's objective unbounded
    total = w.sum(-1)
    return torch.where(total > 0.0,
                       (x * w).sum(-1) / torch.clamp(total, min=1e-12),
                       x.mean(-1))


def critic_loss_fn(cfg: WGANConfig, critic_params: Params,
                   real: torch.Tensor, fake: torch.Tensor, eps: torch.Tensor,
                   fake_w: torch.Tensor | None = None):
    """Critic loss -W + lambda * GP; returns (loss, (W, GP, accuracy)), each
    per member with member-stacked parameters."""
    members = _critic_members(critic_params)
    d_real = critic_lib.apply(cfg.critic_cfg, critic_params, real)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, fake)
    # with rejection on, real rows stand in for rejected fakes in the GP
    # interpolates, which keeps them in-distribution
    fake_gp = fake
    if fake_w is not None:
        fake_gp = torch.where(fake_w[..., None] > 0.5, fake,
                              real[..., : fake.shape[-2], :])
    gp = gradient_penalty(cfg, critic_params, real, fake_gp, eps)
    wasserstein = (_wmean(d_real, None)
                   - _wmean(d_fake, fake_w))
    loss = -wasserstein + cfg.gp_lambda * gp
    # rank accuracy: how often a real sample outscores a (valid) fake one
    pairs = (d_real[..., :, None] > d_fake[..., None, :]).to(real.dtype)
    if fake_w is None:
        acc = gen_lib.mean_per_member(pairs, members)
    else:
        acc = (_sum_per_member(pairs * fake_w[..., None, :], members)
               / torch.clamp(d_real.shape[-1]
                             * _sum_per_member(fake_w, members), min=1.0))
    return loss, (wasserstein, gp, acc)


def _sum_per_member(x: torch.Tensor, members: int) -> torch.Tensor:
    return x.sum(tuple(range(members, x.ndim)))


def gen_loss_fn(cfg: WGANConfig, gen_params: Params, critic_params: Params,
                z=None, generator: torch.Generator | None = None):
    """Generator loss -E[D(fake)] + rate penalty; returns (loss, (penalty,
    frac_converged, frac_diverged, mean_iters, circuit_yield)), each per
    member with member-stacked parameters."""
    members = gen_lib.member_axes(gen_params)
    out = gen_lib.sample_tuning_curves(cfg.gen, gen_params, cfg.batch_size,
                                       z=z, generator=generator)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, out.tc)
    pen = gen_lib.rate_penalty(cfg.gen, out.rates, members)
    loss = -_wmean(d_fake, fake_sample_weights(cfg, out)) \
        + cfg.rate_cost * pen
    return loss, (pen,) + solve_stats(out, members)


def solve_stats(out, members: int = 0):
    """(frac_converged, frac_diverged, mean_iters, circuit_yield) of a
    generator batch, per member."""
    conv = out.converged.to(torch.float32)
    mean = gen_lib.mean_per_member
    return (mean(conv, members),
            mean(out.diverged.to(torch.float32), members),
            mean(out.iters.to(torch.float32), members),
            mean(conv.amin(dim=-1), members))


# -- moment anchor and endgame ---------------------------------------------


def anchor_gamma(cfg: WGANConfig, state: TrainState):
    """EMA decay of this step's anchor moment blend: in latched mode the
    late gamma once ``state.gamma_late`` has latched (a device scalar),
    else the step switch (a host float)."""
    if _latched(cfg) and state.gamma_late is not None:
        late, base = critic_lib.device_constant(
            (cfg.anchor_ema_late, cfg.moment_ema), state.mom_ema_mean.dtype,
            state.gamma_late.device)
        return torch.where(state.gamma_late, late, base)
    return effective_gamma(cfg, state.step, base=cfg.moment_ema,
                           late=cfg.anchor_ema_late,
                           switch=cfg.anchor_ema_switch_step)


def next_drift_latch(cfg: WGANConfig, state: TrainState,
                     new_gen_params: Params):
    """Advance the latched late-gamma state from this step's parameter
    motion (adversarial and anchor updates together). Returns (the three
    TrainState fields, the detector's statistic for the ``drift_ratio``
    column, or None when off).

    Ratio mode: per component |EMA(delta)| / EMA(|delta|), ~1 while it
    descends and ~0 in a limit cycle; the statistic is the max over
    components. Velocity mode: the max over components of the debiased
    |EMA(delta)| (relative: log-space params already are, raw ones are
    divided by |p|) in %-per-1000-steps. The latch fires when the
    statistic is below the threshold at or after the arming step
    ``anchor_ema_switch_step``; it can fire at the arming step itself.
    Everything stays on the device."""
    if state.drift_dir is None:
        return dict(drift_dir=None, drift_mag=None,
                    gamma_late=state.gamma_late), None
    b = cfg.anchor_drift_ema
    keys = sorted(new_gen_params)  # the reference's leaf order
    delta = {k: new_gen_params[k] - state.gen_params[k] for k in keys}
    drift_dir = {k: b * state.drift_dir[k] + (1.0 - b) * delta[k]
                 for k in keys}
    drift_mag = {k: b * state.drift_mag[k] + (1.0 - b) * delta[k].abs()
                 for k in keys}
    armed = (state.step + 1) >= cfg.anchor_ema_switch_step
    if cfg.anchor_ema_switch_vel > 0:
        # the debias assumes the EMAs started at step 0
        debias = 1.0 - b ** (state.step + 1.0)
        if cfg.gen.param_space == "log":
            rel = [drift_dir[k].abs() for k in keys]
        else:
            rel = [drift_dir[k].abs() / (new_gen_params[k].abs() + 1e-12)
                   for k in keys]
        stat = torch.stack([r.max() for r in rel]).max() / debias * 1e5
        threshold = cfg.anchor_ema_switch_vel
    else:
        stat = torch.stack([
            (drift_dir[k].abs() / (drift_mag[k] + 1e-12)).max()
            for k in keys]).max()
        threshold = cfg.anchor_ema_switch_drift
    fired = (stat < threshold) & armed
    return dict(drift_dir=drift_dir, drift_mag=drift_mag,
                gamma_late=state.gamma_late | fired), stat


def anchor_loss(cfg: WGANConfig, state: TrainState, out):
    """Survivor-masked, EMA-averaged moment residual of the generated TCs
    against the frozen data moments. Returns (loss, new_ema_mean,
    new_ema_second, new_ema_count); the value uses the debiased EMA and
    the gradient the current batch's full-scale pathwise derivative
    (straight-through)."""
    tc = out.tc.reshape(-1, out.tc.shape[-1])
    ok = survivor_chain(out.converged, tc.dtype)  # (B,)
    if tc.shape[0] != ok.shape[0]:
        ok = ok.repeat_interleave(tc.shape[0] // ok.shape[0])
    g = anchor_gamma(cfg, state)
    bmean, bsecond = data_moments(tc, ok)
    # zero-survivor guard: hold the EMA and its count
    has_data = ok.sum() > 0
    new_em = torch.where(has_data,
                         g * state.mom_ema_mean + (1 - g) * bmean.detach(),
                         state.mom_ema_mean)
    new_es = torch.where(has_data,
                         g * state.mom_ema_second + (1 - g) * bsecond.detach(),
                         state.mom_ema_second)
    count = (state.mom_ema_count if state.mom_ema_count is not None
             else torch.tensor(float(state.step), dtype=bmean.dtype,
                               device=bmean.device))
    new_count = count + has_data.to(bmean.dtype)
    debias = torch.clamp(1.0 - g ** new_count, min=1e-12)
    m_mean = (new_em / debias).detach() + bmean - bmean.detach()
    m_second = (new_es / debias).detach() + bsecond - bsecond.detach()
    wm = 1.0 / (state.data_mean.abs() + cfg.moment_eps) ** 2
    wc = 1.0 / (state.data_second.abs() + cfg.moment_eps) ** 2
    me = torch.mean(wm * (m_mean - state.data_mean) ** 2)
    ce = torch.mean(wc * (m_second - state.data_second) ** 2)
    return me + ce, new_em, new_es, new_count


def apply_anchor_update(cfg: WGANConfig, state: TrainState,
                        gen_params: Params, anchor_z,
                        gen_cfg: GeneratorConfig | None = None):
    """``anchor_updates`` composed Adam updates on the anchor residual,
    update k on the generator batch of ``anchor_z[k]``, after the
    adversarial update. Returns (params, anchor TrainState fields, last
    residual)."""
    if cfg.moment_anchor <= 0:
        return gen_params, dict(mom_ema_mean=None, mom_ema_second=None,
                                mom_ema_count=None, anchor_opt=None), None
    anchor_tx = make_anchor_optimizer(cfg)
    gen_cfg = cfg.gen if gen_cfg is None else gen_cfg
    params, opt = gen_params, state.anchor_opt
    em, es = state.mom_ema_mean, state.mom_ema_second
    cnt = (state.mom_ema_count if state.mom_ema_count is not None
           else torch.tensor(float(state.step), dtype=em.dtype,
                             device=em.device))
    for k in range(max(1, int(cfg.anchor_updates))):
        st = state._replace(mom_ema_mean=em, mom_ema_second=es,
                            mom_ema_count=cnt)
        leaves = _leaves(params)
        out = gen_lib.sample_tuning_curves(
            gen_cfg, leaves, cfg.batch_size, z=anchor_z[k])
        aloss, em, es, cnt = anchor_loss(cfg, st, out)
        updates, opt = anchor_tx.update(_grad(aloss, leaves), opt)
        params = apply_updates(params, updates)
        em, es, cnt = em.detach(), es.detach(), cnt.detach()
    return params, dict(mom_ema_mean=em, mom_ema_second=es,
                        mom_ema_count=cnt, anchor_opt=opt), aloss.detach()


def scale_updates_for_endgame(cfg: WGANConfig, state: TrainState,
                              g_updates: Params) -> Params:
    """Once the endgame latch is set, rescale the adversarial update so its
    effective lr is ``gen_lr_floor`` (Adam's update is linear in lr). A
    zero schedule already is the floor, so its scale is 1."""
    if cfg.gen_lr_switch_residual <= 0 or state.endgame is None:
        return g_updates
    lr_now = gen_lr_schedule(cfg)(torch.full(
        (), state.step, dtype=torch.int32, device=state.endgame.device))
    safe = torch.where(state.endgame & (lr_now > 0),
                       cfg.gen_lr_floor / torch.where(lr_now > 0, lr_now, 1.0),
                       1.0)
    return {k: u * safe.to(u.dtype) for k, u in g_updates.items()}


def next_endgame(cfg: WGANConfig, state: TrainState, a_res):
    """Advance the endgame latch from this step's anchor residual; it
    first cools the NEXT step's adversarial update."""
    if state.endgame is None:
        return None
    fired = a_res < cfg.gen_lr_switch_residual
    if cfg.gen_lr_switch_min_step > 0:
        fired = fired & (state.step >= cfg.gen_lr_switch_min_step)
    return state.endgame | fired


# -- the step --------------------------------------------------------------


def run_step(cfg: WGANConfig, n_critic: int, state: TrainState,
             real_stack: torch.Tensor, noise: StepNoise | None,
             generator: torch.Generator | None, *, fake_batch: Callable,
             critic_loss: Callable, gen_loss: Callable,
             anchor_gen_cfg: GeneratorConfig | None = None
             ) -> Tuple[TrainState, StepMetrics]:
    """The GAN step's schedule: ``n_critic`` critic updates, each on
    ``fake_batch(z) -> (fake rows, row weights or None)`` solved without a
    graph, then one generator update on ``gen_loss``, the anchor updates
    (their batches in ``anchor_gen_cfg``'s layout), the drift latch and the
    parameter EMA."""
    _check_config(cfg)
    if noise is None:
        if generator is None:
            raise ValueError("train_step_impl needs noise= or generator=")
        noise = draw_step_noise(cfg, n_critic, real_stack, generator)
    if gen_lib.member_axes(state.gen_params) and cfg.moment_anchor > 0:
        raise NotImplementedError(
            "the moment anchor is single-fit only: a member-stacked state "
            "has no per-member anchor buffers")
    gen_tx, critic_tx = make_optimizers(cfg)
    critic_params, critic_opt = state.critic_params, state.critic_opt
    d_losses, ws, gps, accs = [], [], [], []
    for i in range(n_critic):
        real = real_stack[i]
        # the fake batch is data to the critic: no graph through the solve
        with profiling.span("wgan.critic_solve"), torch.no_grad():
            fake, fake_w = fake_batch(noise.critic_z[i])
        with profiling.span("wgan.critic_update"):
            eps = noise.gp_eps[i]
            if torch.is_tensor(eps) and eps.device == real.device:
                eps = eps.to(real.dtype)
            else:  # from host memory: a blocking copy to the device
                with profiling.host_sync("wgan.gp_eps"):
                    eps = torch.as_tensor(eps, dtype=real.dtype,
                                          device=real.device)
            leaves = _leaves(critic_params)
            loss, (w, gp, acc) = critic_loss(cfg, leaves, real, fake, eps,
                                             fake_w=fake_w)
            updates, critic_opt = critic_tx.update(_grad(loss, leaves),
                                                   critic_opt)
            critic_params = apply_updates(critic_params, updates)
        d_losses.append(loss.detach())
        ws.append(w.detach())
        gps.append(gp.detach())
        accs.append(acc.detach())

    with profiling.span("wgan.gen_forward"):
        leaves = _leaves(state.gen_params)
        g_loss, (pen, fconv, fdiv, miters, cyield) = gen_loss(
            cfg, leaves, critic_params, z=noise.gen_z)
    with profiling.span("wgan.gen_backward"):
        g_grads = _grad(g_loss, leaves)
    with profiling.span("wgan.gen_update"):
        g_updates, gen_opt = gen_tx.update(g_grads, state.gen_opt)
        g_updates = scale_updates_for_endgame(cfg, state, g_updates)
        gen_params = apply_updates(state.gen_params, g_updates)
    with profiling.span("wgan.anchor"):
        gen_params, anchor_state, a_res = apply_anchor_update(
            cfg, state, gen_params, anchor_z=noise.anchor_z,
            gen_cfg=anchor_gen_cfg)
    drift_fields, drift_ratio = next_drift_latch(cfg, state, gen_params)

    ema_params = state.ema_params
    if cfg.ema_decay > 0 and ema_params is not None:
        d = cfg.ema_decay
        ema_params = {k: d * ema_params[k] + (1.0 - d) * gen_params[k]
                      for k in gen_params}

    new_state = TrainState(
        gen_params=gen_params,
        gen_opt=gen_opt,
        critic_params=critic_params,
        critic_opt=critic_opt,
        step=state.step + 1,
        ema_params=ema_params,
        data_mean=state.data_mean,
        data_second=state.data_second,
        endgame=next_endgame(cfg, state, a_res),
        **drift_fields,
        **anchor_state,
    )
    metrics = StepMetrics(
        d_loss=d_losses[-1],
        g_loss=g_loss.detach(),
        wasserstein=ws[-1],
        gp=gps[-1],
        rate_penalty=pen.detach(),
        frac_converged=fconv,
        frac_diverged=fdiv,
        mean_iters=miters,
        d_accuracy=accs[-1],
        d_loss_iters=torch.stack(d_losses, dim=-1),
        wasserstein_iters=torch.stack(ws, dim=-1),
        gp_iters=torch.stack(gps, dim=-1),
        acc_iters=torch.stack(accs, dim=-1),
        anchor_residual=a_res,
        circuit_yield=cyield,
        drift_ratio=drift_ratio,
    )
    return new_state, metrics


def train_step_impl(cfg: WGANConfig, n_critic: int, state: TrainState,
                    real_stack: torch.Tensor, *,
                    noise: StepNoise | None = None,
                    generator: torch.Generator | None = None
                    ) -> Tuple[TrainState, StepMetrics]:
    """One GAN step: ``n_critic`` critic updates on ``real_stack[i]``
    ((n_critic, critic_batch, tc_dim), or (n_critic, K, critic_batch,
    tc_dim) for a member-stacked state), one generator update, then the
    anchor. Noise is ``noise`` when given, else drawn from ``generator``."""
    def fake_batch(z):
        out = gen_lib.sample_tuning_curves(cfg.gen, state.gen_params,
                                           cfg.batch_size, z=z)
        return out.tc, fake_sample_weights(cfg, out)

    return run_step(cfg, n_critic, state, real_stack, noise, generator,
                    fake_batch=fake_batch, critic_loss=critic_loss_fn,
                    gen_loss=gen_loss_fn)


# PyTorch runs eagerly: the step the drivers call is the implementation.
train_step = train_step_impl
