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
per-circuit early exit. With ``two_phase`` (:class:`TwoPhase`) it runs the
kernel's default schedule, the TPU kernel's two phases and its refinement
tail; the kernel's plain version is this loop in one of its schedules.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


class TwoPhase(NamedTuple):
    """The TPU kernel's two-phase schedule on the lockstep solve, with a
    phase per tile of ``rows`` rows of one circuit: phase 1 drives with
    ``fast_drive(W, r, I)`` (None: the full drive) to the residual
    ``coarse`` within ``max_iter1`` substeps; a tile switches at the first
    chunk boundary where its rows have all resolved or that budget is
    spent. There every flag of the tile is cleared, but those of diverged
    rows whose peak passes ``reopen_at`` (0: none), the reopened rows get
    ``iters = max_iter``, Anderson's history restarts, and phase 2 runs the
    full drive on to ``atol``, its substeps counted on from phase 1's.

    With ``refine`` phase 2 runs the TPU kernel's refinement tail
    (``_solver_kernel`` :252-273): once per chunk an anchor ``u = W r + I``
    in the full drive at the chunk's input rates ``r_base``, then each
    substep on the correction ``e = r - r_base`` from zero, ``u = anchor +
    W e`` with ``W e`` in the fast drive (``fast_drive(W, e, 0)``), ``delta
    = -(r_base + e) + f(u)``, ``e = min(e + alpha delta, ceiling -
    r_base)``; the chunk ends at ``r = r_base + e``."""

    rows: int
    coarse: float
    max_iter1: int
    reopen_at: float
    fast_drive: Callable | None = None
    refine: bool = False


def solve_fixed_point(
    cfg: SSNConfig,
    W: torch.Tensor,
    I_ext: torch.Tensor,
    r0: torch.Tensor | None = None,
    check_every: int = 1,
    model=None,
    two_phase: TwoPhase | None = None,
    stop_at: torch.Tensor | None = None,
    stats: dict | None = None,
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
      two_phase: the schedule of :class:`TwoPhase` (not under ``model``);
        None: one phase.
      stop_at: (..., S) int substeps, 0 for none: a row with a count stops
        as converged at the first check at or past it (in phase 2 under
        ``two_phase``) unless it diverged, whatever its residual; it
        replays another solve's row to that solve's stopping substep.
      stats: where given, receives the substeps each row ran in each phase
        (``phase1_substeps``, ``phase2_substeps``); in one phase every
        substep counts as phase 2, the full-precision phase.

    Returns:
      FixedPointResult on W's device, rates in W's dtype. Not
      differentiable.
    """
    if two_phase is not None and model is not None:
        raise ValueError("the two-phase schedule solves whole circuits; it "
                         "takes no model axis")
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
    zero = torch.zeros((), dtype=dtype, device=device)

    # unsharded, the drive keeps its three-argument call (an emulated
    # drive, tests/test_torch_ssn_solve_tf32.py, takes three)
    sharded = {} if model is None else {"model": model}

    def full(W, r, I):
        return recurrent_drive(W, r, I, **sharded)

    def step(r, drive, base=None):
        if base is None:
            delta = -r + f(drive(W, r, I_ext))
            return torch.minimum(r + alpha * delta, r_ceiling), delta
        # the refinement tail: r is the correction from base
        delta = -(base + r) + f(drive(W, r, I_ext))
        return torch.minimum(r + alpha * delta, r_ceiling - base), delta

    anderson = cfg.accel == "anderson"
    converged = torch.zeros(lead + (S,), dtype=torch.bool, device=device)
    diverged = torch.zeros_like(converged)
    iters = torch.full(lead + (S,), cfg.max_iter, dtype=torch.int32,
                       device=device)
    r_in_prev = f_prev = torch.zeros_like(r) if anderson else None
    ph = None  # the rows in phase 1 (two phases only)
    if stats is not None:  # by phase 1, 2
        steps = torch.zeros((2,) + lead + (S,), dtype=torch.int32,
                            device=device)
    if two_phase is not None:
        rows = two_phase.rows
        K = -(-S // rows)
        tile = torch.arange(S, device=device) // rows  # the tile of each row
        phase1 = torch.full(lead + (K,), two_phase.max_iter1 > 0,
                            device=device)
        nhist = torch.zeros(lead + (K,), dtype=torch.int32, device=device)
        atols = torch.tensor([cfg.atol, two_phase.coarse], dtype=dtype,
                             device=device)  # by phase 2, 1
    it = 0
    # one host sync per chunk: the lockstep loop's "any row active" test
    while it < cfg.max_iter:
        active = ~(converged | diverged)
        more = active.any()
        if model is not None:
            more = model.max(more.to(torch.int32))
        if not bool(more):
            break
        drive, atol = full, cfg.atol
        if two_phase is not None:
            ph = phase1[..., tile]  # (..., S)
            atol = atols[ph.long()]
            fast = two_phase.fast_drive
            if fast is not None and bool(ph.any()):
                drive = fast if bool(ph.all()) else (
                    lambda W, r, I: torch.where(ph[..., None], fast(W, r, I),
                                                full(W, r, I)))
        r_new, base = r, None
        if (two_phase is not None and two_phase.refine
                and not bool(ph.all())):
            # the refinement tail on the rows in phase 2: iterate on the
            # correction from base = r (zero on the rows in phase 1, whose
            # substeps this leaves bit for bit as they were) around the
            # anchor W r + I (I on the rows in phase 1), W e in the fast
            # pass
            tail = ~ph[..., None]
            base = torch.where(tail, r, zero)
            anchor = torch.where(tail, full(W, r, I_ext), I_ext)
            fast = two_phase.fast_drive or full
            drive = lambda W, e, I: fast(W, e, zero) + anchor  # noqa: E731
            r_new = r - base
        for _ in range(check_every):
            r_new, delta = step(r_new, drive, base)
        if base is not None:
            r_new = base + r_new
        err = delta.abs().amax(dim=-1)
        peak = r_new.amax(dim=-1)
        it_next = it + check_every
        newly_div = active & (peak > cfg.rate_stop_at)
        newly_conv = active & ~newly_div & (err < atol)
        if stop_at is not None:
            forced = stop_at > 0 if ph is None else (stop_at > 0) & ~ph
            newly_conv = torch.where(
                forced, active & ~newly_div & (it_next >= stop_at),
                newly_conv)
        resolved_now = newly_div | newly_conv
        r_next = r_new
        if anderson:
            # Anderson(1) on the chunk map H: gamma = <F, F - F_prev> /
            # ||F - F_prev||^2, r_aa = H(r) - gamma * (H(r) - H(r_prev)).
            # Safeguards: history exists (since the phase began, in two
            # phases), |gamma| < 2, denom > 0, the extrapolation stays
            # under rate_stop_at (no false divergence flags), active and
            # unresolved rows only; clamped to [0, ceiling]. Flags use the
            # plain chunk.
            f_cur = r_new - r
            dF = f_cur - f_prev
            denom = (dF * dF).sum(dim=-1, keepdim=True)
            gamma = (f_cur * dF).sum(dim=-1, keepdim=True) / (denom + 1e-30)
            h_prev = r_in_prev + f_prev
            r_aa = torch.clamp(r_new - gamma * (r_new - h_prev), 0.0,
                               10.0 * cfg.rate_stop_at)
            history = it > 0 if ph is None else nhist[..., tile] > 0
            ok = (history & (gamma[..., 0].abs() < 2.0)
                  & (denom[..., 0] > 0.0)
                  & (r_aa.amax(dim=-1) <= cfg.rate_stop_at)
                  & active & ~resolved_now)
            r_next = torch.where(ok[..., None], r_aa, r_new)
            r_in_prev, f_prev = r, f_cur
        r = torch.where(active[..., None], r_next, r)
        converged = converged | newly_conv
        diverged = diverged | newly_div
        # clamp: the final chunk may overshoot max_iter (phase 1: its
        # budget) by up to check_every-1 steps; iters == max_iter must keep
        # meaning "unresolved"
        if ph is None:
            cap = torch.full_like(iters, min(it_next, cfg.max_iter))
        else:
            cap = torch.where(ph, min(it_next, two_phase.max_iter1),
                              min(it_next, cfg.max_iter)).to(torch.int32)
        iters = torch.where(resolved_now, cap, iters)
        it = it_next
        if stats is not None:
            if ph is None:
                steps[1] += active * check_every
            else:
                steps[0] += (active & ph) * check_every
                steps[1] += (active & ~ph) * check_every
        if two_phase is not None:
            nhist += 1
            (converged, diverged, iters, nhist, r_in_prev, f_prev,
             phase1) = _phase_boundary(
                cfg, two_phase, it, tile, r, converged, diverged, iters,
                nhist, r_in_prev, f_prev, phase1)
    if stats is not None:
        stats["phase1_substeps"], stats["phase2_substeps"] = steps
    return FixedPointResult(r, converged, diverged, iters)


def _phase_boundary(cfg, sched, it, tile, r, converged, diverged, iters,
                    nhist, r_in_prev, f_prev, phase1):
    """Switch the tiles done with phase 1 after the chunk that ends at
    substep ``it`` (:class:`TwoPhase`); returns the state updated."""
    lead, S = converged.shape[:-1], converged.shape[-1]
    K, rows = phase1.shape[-1], sched.rows
    open_rows = torch.nn.functional.pad(~(converged | diverged),
                                        (0, K * rows - S))
    done = phase1 & ~(open_rows.reshape(lead + (K, rows)).any(-1)
                      & (it < sched.max_iter1))
    if not bool(done.any()):
        return converged, diverged, iters, nhist, r_in_prev, f_prev, phase1
    sw = done[..., tile]
    keep = (diverged & (r.amax(dim=-1) > sched.reopen_at)
            if sched.reopen_at > 0 else torch.zeros_like(diverged))
    converged = converged & ~sw
    diverged = torch.where(sw, keep, diverged)
    iters = torch.where(sw & ~keep, torch.full_like(iters, cfg.max_iter),
                        iters)
    nhist = torch.where(done, 0, nhist)
    if r_in_prev is not None:
        r_in_prev = torch.where(sw[..., None], 0.0, r_in_prev)
        f_prev = torch.where(sw[..., None], 0.0, f_prev)
    return (converged, diverged, iters, nhist, r_in_prev, f_prev,
            phase1 & ~done)
