"""Unrolled Euler integration: the BPTT-differentiable path (config C3).

Port of :mod:`tcgan_tpu.ops.euler`. A fixed number of Euler steps

    r <- min(r + alpha * (-r + f(W r + I)), clip_factor * rate_stop_at)

from r0 (zeros by default), differentiated by backpropagation through the
unrolled loop. Differences of form from the reference (``lax.scan``):

- the loop is a Python loop of eager ops; it never copies device->host;
- ``checkpoint_chunk`` wraps each chunk of steps in
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so the
  backward keeps one state per chunk and recomputes a chunk's steps when it
  reaches them (``jax.checkpoint`` over a scan of the chunk there).

Divergence is flagged on the FIRST step any rate exceeds ``rate_stop_at``
(on detached rates, OR'd on the device); the clip sits above that ceiling,
so a clipped sample stays flagged and its gradient dies at the clip.
``torch.minimum``, like ``lax.min``, splits the gradient at ties.

Under a model axis (``model``, :class:`tcgan_torch.parallel.mesh.ModelAxis`)
W holds this rank's columns: each Euler step's drive is one all-reduce over
the model group (again in each checkpoint recompute), its backward one
gather of r's cotangent (``ModelAxis.drive``). The rates stay whole and
alike on every rank of the group, so the divergence flag and the clip take
no collective, and every rank replays the same chunks in the same order.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tcgan_torch.ops.fixed_point import FixedPointResult
from tcgan_torch.ops.ssn import SSNConfig, recurrent_drive


def solve_dynamics(
    cfg: SSNConfig,
    W: torch.Tensor,
    I_ext: torch.Tensor,
    r0: torch.Tensor | None = None,
    seqlen: int | None = None,
    checkpoint_chunk: int | None = None,
    return_trajectory: bool = False,
    clip_factor: float = 10.0,
    model=None,
):
    """Integrate the SSN for a fixed number of Euler steps (differentiable).

    Args:
      cfg: configuration (io function, dt, tau, stepper, atol,
        rate_stop_at, seqlen).
      W: (..., 2N, 2N); I_ext: (..., S, 2N); r0 defaults to zeros.
      seqlen: number of steps (default ``cfg.seqlen``).
      checkpoint_chunk: if set, recompute each chunk of this many steps in
        the backward instead of keeping its states; must divide seqlen.
      return_trajectory: also return the (seqlen, ..., S, 2N) trajectory
        (memory-heavy; for tests and analysis; no checkpointing then).
      clip_factor: rates are clipped at ``clip_factor * rate_stop_at``.
      model: the model axis W's columns split over (see the module
        docstring); None: W whole.

    Returns:
      FixedPointResult (``converged`` from the final state's residual,
      ``iters`` = seqlen), or (FixedPointResult, trajectory) when
      ``return_trajectory``.
    """
    seqlen = cfg.seqlen if seqlen is None else seqlen
    f = cfg.io_fun()
    dtype, device = W.dtype, W.device
    lead = torch.broadcast_shapes(W.shape[:-2], I_ext.shape[:-2])
    S, n2 = I_ext.shape[-2], W.shape[-2]
    if r0 is None:
        r0 = torch.zeros(lead + (S, n2), dtype=dtype, device=device)
    else:
        r0 = r0.to(dtype).expand(lead + (S, n2))
    I_ext = I_ext.to(dtype)
    alpha = cfg.step_gain(dtype=dtype, device=device)
    ceiling = torch.full((), clip_factor * cfg.rate_stop_at, dtype=dtype,
                         device=device)
    stop_at = cfg.rate_stop_at

    def step(r, div):
        r_next = r + alpha * (-r + f(recurrent_drive(W, r, I_ext, model)))
        div = div | (r_next.detach().amax(dim=-1) > stop_at)
        return torch.minimum(r_next, ceiling), div

    def run(r, div, n):
        for _ in range(n):
            r, div = step(r, div)
        return r, div

    r = r0
    div = torch.zeros(lead + (S,), dtype=torch.bool, device=device)
    traj = None
    if return_trajectory:
        traj = []
        for _ in range(seqlen):
            r, div = step(r, div)
            traj.append(r)
        traj = torch.stack(traj)
    elif checkpoint_chunk:
        if seqlen % checkpoint_chunk:
            raise ValueError("checkpoint_chunk must divide seqlen")
        if torch.is_grad_enabled():
            for _ in range(seqlen // checkpoint_chunk):
                r, div = checkpoint(run, r, div, checkpoint_chunk,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:  # nothing to recompute without a graph
            r, div = run(r, div, seqlen)
    else:
        r, div = run(r, div, seqlen)

    # convergence diagnostics on the final state, outside the gradient path
    with torch.no_grad():
        rT = r.detach()
        delta = -rT + f(recurrent_drive(W.detach(), rT, I_ext.detach(),
                                        model))
        err = delta.abs().amax(dim=-1)
    converged = ~div & (err < cfg.atol)
    iters = torch.full(lead + (S,), seqlen, dtype=torch.int32, device=device)
    res = FixedPointResult(r, converged, div, iters)
    if return_trajectory:
        return res, traj
    return res
