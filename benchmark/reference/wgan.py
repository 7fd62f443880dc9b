"""Plain PyTorch reference of one fixed-point WGAN-GP step.

One step: ``n_critic`` critic updates, each on a fresh fake batch solved by
:func:`benchmark.reference.ssn.solve` at the generator's current
parameters, then one generator update whose gradient reaches the parameters
through the fixed point by the implicit function theorem. Written from the
method (Gulrajani et al. 2017 for the gradient penalty, Kingma & Ba 2015 for
Adam, the round-2 fit's flags for the rest); it imports nothing of the
program under test.

- Critic: an MLP on tuning curves scaled per feature by ``input_scale``,
  ReLU hidden layers, a scalar head. Loss: -(mean D(real) - mean D(fake)) +
  lambda mean((|grad_x D(x_hat)| - 1)^2), x_hat = eps real + (1 - eps) fake,
  the norm taken as sqrt(sum g^2 + 1e-12).
- Generator loss: -mean D(tc) + rate_cost mean(relu(r - soft)^2) / soft^2,
  over the rates r of every row.
- Implicit gradient: with g = dL/dr* and phi = f'(W r* + I), lam solves
  (1 - diag(phi) W)^T lam = g by damped Richardson, lam += alpha (W^T (phi
  lam) + g - lam), until max |step| < ``bwd_atol`` over the batch (or
  ``bwd_max_iter`` steps); rows that did not converge carry no gradient.
  Then dL/dW = sum_s (phi lam)_s r*_s^T, carried to log J, D, S by autograd
  through :func:`benchmark.reference.ssn.weights`.
- Adam with the global-norm clip before it (optax's ``chain(
  clip_by_global_norm, adam)``: eps outside the square root, bias
  correction at the incremented count), an update skipped whole where a
  gradient is not finite.

``precision`` is that of :mod:`benchmark.reference.ssn`: every product of
the step, solve, adjoint and critic, goes through its ``matmul``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import ssn

ADAM_EPS = 1e-8


class Adam(NamedTuple):
    count: int
    mu: dict
    nu: dict


def adam_init(params: dict) -> Adam:
    return Adam(0, {k: torch.zeros_like(v) for k, v in params.items()},
                {k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(params: dict, grads: dict, st: Adam, lr: float, b1: float,
                b2: float, clip: float):
    """(new params, new state)."""
    keys = sorted(params)
    if not all(bool(torch.isfinite(grads[k]).all()) for k in keys):
        return params, st
    g = {k: grads[k] for k in keys}
    if clip > 0:
        norm = torch.sqrt(sum((g[k] * g[k]).sum() for k in keys))
        if not bool(norm < clip):
            g = {k: g[k] / norm * clip for k in keys}
    mu = {k: (1 - b1) * g[k] + b1 * st.mu[k] for k in keys}
    nu = {k: (1 - b2) * g[k] ** 2 + b2 * st.nu[k] for k in keys}
    count = st.count + 1
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    new = {k: params[k] - lr * ((mu[k] / bc1)
                                / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
           for k in keys}
    return new, Adam(count, mu, nu)


def critic_apply(params: dict, x: torch.Tensor, scale: torch.Tensor | None,
                 precision: str) -> torch.Tensor:
    """Scores (rows,) of tuning curves x (rows, d)."""
    h = x if scale is None else x * scale
    depth = len(params) // 2 - 1
    for i in range(depth):
        h = torch.relu(ssn.matmul(h, params[f"w{i}"], precision)
                       + params[f"b{i}"])
    return (ssn.matmul(h, params[f"w{depth}"], precision)
            + params[f"b{depth}"])[..., 0]


def critic_loss(params, real, fake, eps, scale, gp_lambda, precision):
    """(loss, the Wasserstein estimate mean D(real) - mean D(fake))."""
    d_real = critic_apply(params, real, scale, precision)
    d_fake = critic_apply(params, fake, scale, precision)
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    score = critic_apply(params, x_hat, scale, precision)
    grad, = torch.autograd.grad(score.sum(), x_hat, create_graph=True)
    norm = torch.sqrt((grad ** 2).sum(dim=-1) + 1e-12)
    gp = ((norm - 1.0) ** 2).mean()
    wasserstein = d_real.mean() - d_fake.mean()
    return -wasserstein + gp_lambda * gp, wasserstein.detach()


def values(log_params: dict) -> tuple:
    """(J, D, S) from the generator's log parameters."""
    return tuple(torch.exp(log_params[k]) for k in ("J", "D", "S"))


def adjoint(circuit, W, I, r, conv, g, *, bwd_atol, bwd_max_iter,
            precision):
    """(phi * lam, iterations) of the implicit gradient's adjoint."""
    k, n = circuit["k"], circuit["n"]
    ok = conv[..., None]
    phi = torch.where(ok, ssn.slope_fn(
        ssn.matmul(r, W.transpose(-1, -2), precision) + I, k, n), 0.0)
    g = torch.where(ok, g, 0.0)
    alpha = ssn.gain(circuit, W.device)
    lam, it = g, 0
    while it < bwd_max_iter:
        step = ssn.matmul(phi * lam, W, precision) + g - lam
        lam = lam + alpha * step
        it += 1
        if not bool(step.abs().max() >= bwd_atol):
            break
    return phi * torch.where(ok, lam, 0.0), it


def generator_grad(circuit, fit, log_params, critic_params, z, I, scale,
                   precision):
    """(loss, gradient of the log parameters, adjoint iterations)."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in log_params.items()}
    x = ssn.site_positions(circuit["N"], circuit["L"], z.device)
    W = ssn.weights(*values(leaves), z, x)
    r, conv, _, _ = ssn.solve(circuit, W.detach(), I, atol=fit["atol"],
                              max_iter=fit["max_iter"],
                              check_every=circuit["check_every"],
                              precision=precision)
    r = r.requires_grad_(True)
    soft = circuit["rate_soft_bound"]
    d_fake = critic_apply(critic_params, ssn.tuning_curves(circuit, r),
                          scale, precision)
    penalty = (torch.relu(r - soft) ** 2).mean() / soft ** 2
    loss = -d_fake.mean() + fit["rate_cost"] * penalty
    g, = torch.autograd.grad(loss, r)
    philam, its = adjoint(circuit, W.detach(), I, r.detach(), conv, g,
                          bwd_atol=fit["bwd_atol"],
                          bwd_max_iter=fit["bwd_max_iter"],
                          precision=precision)
    r_ok = torch.where(conv[..., None], r.detach(), 0.0)
    W_bar = torch.matmul(philam.transpose(-1, -2), r_ok)
    grads = torch.autograd.grad(W, list(leaves.values()), grad_outputs=W_bar)
    return loss.detach(), dict(zip(leaves, grads)), its


class State(NamedTuple):
    gen: dict  # log J, D, S, each (2, 2)
    gen_opt: Adam
    critic: dict
    critic_opt: Adam


def init_state(gen_values: dict, critic_params: dict) -> State:
    """The state at step 0: the generator at ``gen_values`` (J, D, S, 4
    numbers each), the critic at ``critic_params``."""
    device = critic_params["w0"].device
    gen = {k: torch.log(torch.as_tensor(gen_values[k], dtype=torch.float32,
                                        device=device).reshape(2, 2))
           for k in ("J", "D", "S")}
    critic = {k: v.detach().clone() for k, v in critic_params.items()}
    return State(gen, adam_init(gen), critic, adam_init(critic))


def step(circuit, fit, state: State, real_stack, noise, I, scale,
         precision="fp32"):
    """(new state, losses: the n_critic critic losses then the generator
    loss, the critic updates' Wasserstein estimates, adjoint iterations).
    ``noise``: (critic z list, GP eps list, generator z)."""
    critic_z, gp_eps, gen_z = noise
    x = ssn.site_positions(circuit["N"], circuit["L"], gen_z.device)
    critic, critic_opt = state.critic, state.critic_opt
    losses, ws = [], []
    for i in range(fit["n_critic"]):
        with torch.no_grad():
            W = ssn.weights(*values(state.gen), critic_z[i], x)
            r = ssn.solve(circuit, W, I, atol=fit["atol"],
                          max_iter=fit["max_iter"],
                          check_every=circuit["check_every"],
                          precision=precision)[0]
        fake = ssn.tuning_curves(circuit, r)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in critic.items()}
        loss, w = critic_loss(leaves, real_stack[i], fake, gp_eps[i], scale,
                              fit["gp_lambda"], precision)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            critic, critic_opt = adam_update(
                critic, grads, critic_opt, fit["lr_critic"], fit["beta1"],
                fit["beta2"], fit["clip_grad"])
        losses.append(loss.detach())
        ws.append(w)
    critic_fixed = {k: v.detach() for k, v in critic.items()}
    g_loss, grads, its = generator_grad(circuit, fit, state.gen,
                                        critic_fixed, gen_z, I, scale,
                                        precision)
    with torch.no_grad():
        gen, gen_opt = adam_update(state.gen, grads, state.gen_opt,
                                   fit["lr_gen"], fit["beta1"], fit["beta2"],
                                   fit["clip_grad"])
    losses.append(g_loss)
    return State(gen, gen_opt, critic, critic_opt), losses, ws, its


def input_scale(tc_data) -> torch.Tensor:
    """The critic's per-feature input scale of ``--normalize-input``:
    1 / max(|mean of each feature over the data|, 1e-6)."""
    mean = tc_data.to(torch.float64).mean(dim=0).abs()
    return (1.0 / torch.clamp(mean, min=1e-6)).to(torch.float32)


def leaf_norms(tree: dict) -> dict:
    return {k: math.sqrt(float((v.double() ** 2).sum())) for k, v in
            tree.items()}
