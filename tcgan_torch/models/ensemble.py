"""Ensemble (multi-start) fitting: K independent fits stepped as one.

Port of :mod:`tcgan_tpu.models.ensemble`. The reference vmaps a single fit's
step over a member axis; here every leaf of the state carries an explicit
leading member axis K and the single-fit step itself runs all members at
once (see the member-axis notes of :mod:`tcgan_torch.models.wgan` and
:mod:`tcgan_torch.models.moments`): every solve builds W (K, B, 2N, 2N) and
reaches the CUDA solver kernel in ONE launch, so a step launches the kernel
as often as one fit's step does, and the host's work per step is about one
fit's. ``torch.func.vmap`` cannot express the step: it calls
``torch.autograd.grad`` and the kernel is a ctypes call.

Each member gets its own generator start (optionally jittered in log-space),
critic init, real minibatches and noise; members share the static config.
Member 0 keeps the exact requested start, its parameter EMA included.

Random draws differ from the reference's (torch's generator, not JAX keys):
:func:`states_from_numpy` carries a reference state's leaves over.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models import moments as mm_lib
from tcgan_torch.models import wgan as wgan_lib
from tcgan_torch.ops import weights


def stack_states(states: Sequence[Any]) -> Any:
    """One state with a leading member axis on every tensor leaf, from K
    single-fit states of one structure (host ints, such as the step, must
    agree)."""
    first = states[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_states([getattr(s, f) for s in states])
                             for f in first._fields))
    if isinstance(first, dict):
        return {k: stack_states([s[k] for s in states]) for k in first}
    if torch.is_tensor(first):
        return torch.stack(list(states))
    if any(s != first for s in states):
        raise ValueError(f"member states disagree on {first!r}")
    return first


def member_state(states: Any, m: int) -> Any:
    """Member ``m`` of a member-stacked state, as a single-fit state."""
    if isinstance(states, tuple) and hasattr(states, "_fields"):
        return type(states)(*(member_state(v, m) for v in states))
    if isinstance(states, dict):
        return {k: member_state(v, m) for k, v in states.items()}
    if torch.is_tensor(states):
        return states[m]
    return states


def _jitter(generator, gp: Dict[str, torch.Tensor], start_jitter: float):
    """Log-space N(0, jitter^2) noise on every parameter leaf."""
    if start_jitter <= 0.0:
        return dict(gp)
    return {k: p + start_jitter * torch.randn(
        p.shape, generator=generator, dtype=p.dtype, device=p.device)
        for k, p in gp.items()}


def _generator(seed: int, generator, gen_init, device):
    if gen_init is not None:
        device = next(iter(gen_init.values())).device
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    return generator, device


def init_ensemble(cfg: wgan_lib.WGANConfig, n_members: int,
                  generator: torch.Generator | None = None,
                  gen_init: Dict[str, torch.Tensor] | None = None,
                  start_jitter: float = 0.0, model=wgan_lib,
                  device=None):
    """TrainState with a leading member axis on every leaf.

    ``gen_init``: the shared start (unconstrained space; default: the
    config's params). ``start_jitter``: stddev of the log-space noise added
    to members 1..K-1. Jitter and critic inits come from ``generator``
    (default: one seeded with ``cfg.seed``). ``model``: the module supplying
    ``init_state`` (wgan or cwgan, one state contract)."""
    generator, device = _generator(cfg.seed, generator, gen_init, device)
    base = (gen_init if gen_init is not None
            else gen_lib.init_params(cfg.gen, device=device))
    states = []
    for m in range(n_members):
        gp = dict(base) if m == 0 else _jitter(generator, base, start_jitter)
        states.append(model.init_state(cfg, generator=generator, gen_init=gp))
    return stack_states(states)


def init_mm_ensemble(cfg: mm_lib.MomentMatchingConfig, n_members: int,
                     generator: torch.Generator | None = None,
                     gen_init: Dict[str, torch.Tensor] | None = None,
                     start_jitter: float = 0.0, device=None):
    """Member-stacked moment-matching state (the moment-EMA buffers
    included), with the jitter semantics of :func:`init_ensemble`. Under
    ``cfg.fixed_z`` each member draws its own z-set: a shared one would turn
    the z-set's Monte-Carlo error into a bias common to all members, which
    their spread cannot show."""
    generator, device = _generator(cfg.seed, generator, gen_init, device)
    base = (gen_init if gen_init is not None
            else gen_lib.init_params(cfg.gen, device=device))
    n_draw = (cfg.batch_size // 2 if cfg.gen.antithetic
              else cfg.batch_size)
    states = []
    for m in range(n_members):
        gp = dict(base) if m == 0 else _jitter(generator, base, start_jitter)
        z = (weights.sample_z(generator, (n_draw,), cfg.gen.ssn.N,
                              device=device, dtype=cfg.gen.dtype)
             if cfg.fixed_z else None)
        states.append(mm_lib.init_state(cfg, gen_init=gp, fixed_z=z))
    return stack_states(states)


def states_from_numpy(states, **fields):
    """``states`` (member-stacked) with the named fields replaced by
    member-stacked arrays, or dicts of them for parameter fields, such as a
    reference ensemble state's leaves through ``np.asarray``. Each array
    takes the dtype and device of the field it replaces and must have its
    shape."""
    def convert(new, old, where):
        if isinstance(old, dict):
            return {k: convert(new[k], v, f"{where}.{k}")
                    for k, v in old.items()}
        t = torch.tensor(np.array(new, copy=True), dtype=old.dtype,
                         device=old.device)
        if t.shape != old.shape:
            raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                             f"{tuple(old.shape)}")
        return t

    return states._replace(**{f: convert(v, getattr(states, f), f)
                              for f, v in fields.items()})


def ensemble_train_step(cfg, n_critic: int, states, real_stacks: torch.Tensor,
                        *, model=wgan_lib, noise=None,
                        generator: torch.Generator | None = None):
    """One step of every member: ``real_stacks`` (K, n_critic, critic_batch,
    d) as the reference's; ``noise`` a :class:`wgan.StepNoise` of
    member-stacked arrays ((K, B, 2N, 2N) z, (K, critic_batch, 1) eps), or
    draws from ``generator``. Metrics have shape (K,). A moment-matching
    ensemble steps through ``moments.train_step_impl`` itself, with the data
    moments shared ((F,), (F, F)) or one dataset per member ((K, F),
    (K, F, F))."""
    return model.train_step_impl(cfg, n_critic, states,
                                 real_stacks.transpose(0, 1), noise=noise,
                                 generator=generator)


def member_params(gen_cfg, gen_params_host, member: int):
    """Positive-space (J, D, S) of one member, from host arrays."""
    return gen_lib.param_values_np(
        gen_cfg, {k: np.asarray(v)[member] for k, v in gen_params_host.items()})


def ensemble_summary(gen_cfg, gen_params_host,
                     true_params: Dict | None = None) -> Dict:
    """Across-member parameter statistics (+ per-member recovery errors
    when truth is known): the multi-start consistency check."""
    from tcgan_torch.analysis.metrics import param_recovery_error

    K = int(np.asarray(gen_params_host["J"]).shape[0])
    members = []
    for m in range(K):
        J, D, S = member_params(gen_cfg, gen_params_host, m)
        row = {"J": np.asarray(J).tolist(), "D": np.asarray(D).tolist(),
               "S": np.asarray(S).tolist()}
        if true_params is not None:
            row["recovery_error"] = param_recovery_error(
                {"J": J, "D": D, "S": S}, true_params)
        members.append(row)
    stack = {k: np.asarray([m[k] for m in members]) for k in ("J", "D", "S")}
    return {
        "n_members": K,
        "members": members,
        "mean": {k: v.mean(axis=0).tolist() for k, v in stack.items()},
        "std": {k: v.std(axis=0).tolist() for k, v in stack.items()},
    }
