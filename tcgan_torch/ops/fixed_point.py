"""Fixed-point solver: the masked, batched lockstep Euler iteration.

Port of :mod:`tcgan_tpu.ops.fixed_point`. Semantics:

- iterate ``r <- min(r + alpha * (-r + f(W r + I)), 10*rate_stop_at)``
  until the residual ``max_i |-r_i + f(u_i)| < atol`` (converged), any rate
  exceeds ``rate_stop_at`` (diverged), or ``max_iter`` is hit (unresolved);
- the whole batch steps in lockstep; a resolved row is frozen, so its
  result does not depend on how long the other rows take;
- the check runs every ``check_every`` steps, on the last step's residual;
  ``iters`` records the step count at resolution, clamped to ``max_iter``.

This lockstep path is the semantic reference of the port; the CUDA kernel
(:mod:`tcgan_torch.ops.cuda.ssn_solve`) computes the same function with
per-circuit early exit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tcgan_torch.ops.ssn import SSNConfig, recurrent_drive


class FixedPointResult(NamedTuple):
    """Solver output.

    r:         (..., S, 2N) final rates (fixed point where ``converged``).
    converged: (..., S) bool — residual dropped below atol.
    diverged:  (..., S) bool — some rate exceeded rate_stop_at.
    iters:     (..., S) int32 — iterations consumed when the sample resolved
               (== max_iter for samples that never resolved).
    """

    r: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    iters: torch.Tensor


def solve_any(cfg: SSNConfig, W: torch.Tensor, I_ext: torch.Tensor,
              model=None) -> FixedPointResult:
    """Backend-dispatching fixed-point solve (forward only).

    With ``cfg.backend == "cuda"`` every solve goes to the CUDA kernel
    wrapper: W (..., B, 2N, 2N) under a shared battery I (S, 2N), the
    leading axes (an ensemble's members) folded into the circuit axis of
    ONE launch and the outputs unfolded to (..., B, S, ...). Any other
    layout raises ``ValueError``; nothing falls back to the lockstep solve.
    The kernel path computes and returns float32 rates whatever the input
    dtype; the lockstep path keeps ``W.dtype``.

    ``model`` (a :class:`tcgan_torch.parallel.mesh.ModelAxis`): W holds this
    rank's columns (..., B, 2N, 2N/M), and the lockstep path sums the drive
    over the model group at every step. The kernel solves whole circuits
    of a whole W and raises ``ValueError`` on a model axis: there the
    generator splits the circuits over the model group instead
    (``models/generator.py``).
    """
    check_every = max(cfg.check_every, 1)
    if cfg.backend != "cuda":
        return solve_fixed_point(cfg, W, I_ext, check_every=check_every,
                                 model=model)
    if model is not None:
        raise ValueError("the cuda backend solves whole circuits of a whole "
                         "W; under a model axis the generator splits the "
                         "circuits over the model group")
    if W.ndim < 3 or I_ext.ndim != 2:
        raise ValueError(
            "the cuda backend solves W (..., B, 2N, 2N) under a shared "
            f"battery I_ext (S, 2N); got W {tuple(W.shape)} and I_ext "
            f"{tuple(I_ext.shape)}")
    from tcgan_torch.ops.cuda.ssn_solve import solve_fixed_point_cuda

    lead = W.shape[:-2]
    res = solve_fixed_point_cuda(cfg, W.reshape((-1,) + W.shape[-2:]), I_ext,
                                 check_every=check_every,
                                 accel=(cfg.accel == "anderson"))
    return FixedPointResult(*(t.reshape(lead + t.shape[1:]) for t in res))


def solve_fixed_point(
    cfg: SSNConfig,
    W: torch.Tensor,
    I_ext: torch.Tensor,
    r0: torch.Tensor | None = None,
    check_every: int = 1,
    model=None,
) -> FixedPointResult:
    """Solve the SSN fixed point for a batch of circuits and stimuli.

    Args:
      cfg: configuration (dt, tau, io, atol, max_iter, rate_stop_at, init,
        stepper, accel).
      W: (..., 2N, 2N) weight matrices.
      I_ext: (..., S, 2N) external inputs, broadcastable against W's
        leading dims.
      r0: optional initial rates; defaults to zeros or f(I_ext) by
        ``cfg.init``.
      check_every: run the convergence/divergence check every k steps.
      model: a :class:`tcgan_torch.parallel.mesh.ModelAxis` when W holds
        this rank's columns only; the rates stay whole on every rank of the
        model group, and the group takes each stop decision together.

    Returns:
      FixedPointResult on W's device, rates in W's dtype. Not
      differentiable.
    """
    f = cfg.io_fun()
    dtype, device = W.dtype, W.device
    lead = torch.broadcast_shapes(W.shape[:-2], I_ext.shape[:-2])
    S, n2 = I_ext.shape[-2], I_ext.shape[-1]
    I_ext = I_ext.to(dtype)
    if r0 is None:
        if cfg.init == "feedforward":
            r0 = f(I_ext)
        else:
            r0 = torch.zeros((), dtype=dtype, device=device)
    r = r0.to(dtype).expand(lead + (S, n2)).clone()

    alpha = cfg.step_gain(dtype=dtype, device=device)  # (2N,)
    # Hard ceiling well above the divergence bound: the power-law io grows
    # runaway rates super-exponentially, so an unchecked check_every window
    # could carry a row to overflow; clipping above rate_stop_at keeps the
    # diverged flag exact and the rates finite.
    r_ceiling = torch.tensor(10.0 * cfg.rate_stop_at, dtype=dtype,
                             device=device)

    # unsharded, the drive keeps its three-argument call (an emulated
    # drive, tests/test_torch_ssn_solve_tf32.py, takes three)
    sharded = {} if model is None else {"model": model}

    def step(r):
        delta = -r + f(recurrent_drive(W, r, I_ext, **sharded))
        return torch.minimum(r + alpha * delta, r_ceiling), delta

    anderson = cfg.accel == "anderson"
    converged = torch.zeros(lead + (S,), dtype=torch.bool, device=device)
    diverged = torch.zeros_like(converged)
    iters = torch.full(lead + (S,), cfg.max_iter, dtype=torch.int32,
                       device=device)
    r_in_prev = f_prev = torch.zeros_like(r) if anderson else None
    it = 0
    # one host sync per chunk: the lockstep loop's "any row active" test
    while it < cfg.max_iter:
        active = ~(converged | diverged)
        more = active.any()
        if model is not None:
            more = model.max(more.to(torch.int32))
        if not bool(more):
            break
        r_new = r
        for _ in range(check_every):
            r_new, delta = step(r_new)
        err = delta.abs().amax(dim=-1)
        peak = r_new.amax(dim=-1)
        it_next = it + check_every
        newly_div = active & (peak > cfg.rate_stop_at)
        newly_conv = active & ~newly_div & (err < cfg.atol)
        resolved_now = newly_div | newly_conv
        r_next = r_new
        if anderson:
            # Anderson(1) on the chunk map H: gamma = <F, F - F_prev> /
            # ||F - F_prev||^2, r_aa = H(r) - gamma * (H(r) - H(r_prev)).
            # Safeguards: history exists, |gamma| < 2, denom > 0, the
            # extrapolation stays under rate_stop_at (no false divergence
            # flags), active and unresolved rows only; clamped to
            # [0, ceiling]. Flags use the plain chunk.
            f_cur = r_new - r
            dF = f_cur - f_prev
            denom = (dF * dF).sum(dim=-1, keepdim=True)
            gamma = (f_cur * dF).sum(dim=-1, keepdim=True) / (denom + 1e-30)
            h_prev = r_in_prev + f_prev
            r_aa = torch.clamp(r_new - gamma * (r_new - h_prev), 0.0,
                               10.0 * cfg.rate_stop_at)
            ok = ((it > 0) & (gamma[..., 0].abs() < 2.0)
                  & (denom[..., 0] > 0.0)
                  & (r_aa.amax(dim=-1) <= cfg.rate_stop_at)
                  & active & ~resolved_now)
            r_next = torch.where(ok[..., None], r_aa, r_new)
            r_in_prev, f_prev = r, f_cur
        r = torch.where(active[..., None], r_next, r)
        converged = converged | newly_conv
        diverged = diverged | newly_div
        # clamp: the final chunk may overshoot max_iter by up to
        # check_every-1 steps; iters == max_iter must keep meaning
        # "unresolved"
        iters = torch.where(resolved_now,
                            torch.full_like(iters, min(it_next, cfg.max_iter)),
                            iters)
        it = it_next
    return FixedPointResult(r, converged, diverged, iters)

