"""Implicit-function-theorem gradients through the SSN fixed point.

Port of :mod:`tcgan_tpu.ops.ift`. The fixed point satisfies r* = F(r*, W, I)
with F(r, W, I) = f(W r + I). For a downstream cotangent g = dL/dr* the IFT
gives

    lam solves  (I - dF/dr)^T lam = g,
    W_bar = (dF/dW)^T lam,   I_bar = (dF/dI)^T lam,

with dF/dr = diag(f'(u*)) W at u* = W r* + I. :class:`FixedPointRates` is a
``torch.autograd.Function`` whose forward is :func:`fixed_point.solve_any`,
the CUDA solver kernel on CUDA tensors, and whose backward solves the
adjoint system by one of three methods:

- ``"iterative"`` (default): damped Richardson on the adjoint,
  lam <- lam + alpha * (-lam + (dF/dr)^T lam + g), until max |delta| drops
  below ``bwd_atol`` or ``bwd_max_iter`` iterations ran. The max runs over
  the whole batch, or per independent group: ``group_axes`` leading axes
  (an ensemble's members, or a batch of cotangents in
  :func:`vjp_W_batched`) each keep their own residual, stop test and
  iteration count, and a converged group is frozen while the others go on,
  which is what ``lax.while_loop`` under ``vmap`` does in the reference.
  With the ``cuda`` backend on CUDA tensors the loop is one launch of the
  adjoint kernel (:mod:`tcgan_torch.ops.cuda.ift_adjoint`), which tests
  the stop rule on every iteration on the device, as the reference does;
  the host reads its iteration count once (half types run it in float32,
  as the solver kernel does; what the kernel does not take raises: nothing
  falls back). Elsewhere, CPU tensors included, the plain
  loop runs, ``check_stride`` iterations per host sync; an iteration after
  the stop rule held leaves lam unchanged, so the result does not depend
  on the stride. ``check_stride`` applies to the plain loop alone.
- ``"direct"``: batched dense solve of the transposed system.
- ``"jfb"``: Jacobian-free backprop, lam = g.

Split over ranks (``split``, a :class:`tcgan_torch.parallel.mesh.Split`),
the iterative adjoint's stop test takes its max over every rank's
circuits, one all-reduce per check stride (:func:`_chunk_over_ranks`), so
each rank stops on the iteration the unsharded batch would; the chunk and
its replay run through the kernel on the ``cuda`` backend's CUDA tensors
and through the plain loop elsewhere. With a model
axis (``split.model``) W holds this rank's columns only: the forward is
the lockstep solve with the drive summed over the model group, the
iterative adjoint gathers each rank's columns of ``(phi * lam) @ W`` (lam
stays whole on every rank), ``"direct"`` gathers W's columns once and
solves the dense system, and W's cotangent comes back for this rank's
columns. (On the kernel backend the model group splits the circuits
instead, and ``split.model`` is None: ``models/generator.py``.)

While a profiler runs (:mod:`tcgan_torch.utils.profiling`) each adjoint,
whatever its method, adds its rows to ``ift.adjoint_rows.<2N>`` and its
circuits (the W matrices it reads) to ``ift.adjoint_circuits.<2N>``: what
the adjoint's least work and the bytes of W read once are counted from.

Cotangents, io slopes, adjoints and rates of samples whose forward solve did
not converge are zeroed with ``torch.where`` (not a multiply: NaN * 0 is
NaN), so an excluded sample is inert in every method and cannot poison the
batch gradient. The backward runs in ``W.dtype`` whatever dtype the forward
returned (the kernel returns fp32 rates).
"""

from __future__ import annotations

import math

import torch

from tcgan_torch.ops.cuda import ift_adjoint
from tcgan_torch.ops.fixed_point import FixedPointResult, solve_any
from tcgan_torch.ops.ssn import SSNConfig, recurrent_drive
from tcgan_torch.utils import profiling

GRAD_METHODS = ("iterative", "direct", "jfb")
# Adjoint iterations per host sync of the plain loop's stop test.
DEFAULT_CHECK_STRIDE = 64

# Iterative-adjoint iterations since import (or since a caller reset it to
# 0).
adjoint_iterations = 0


def _bwd(cfg: SSNConfig, grad_method: str, bwd_max_iter: int,
         bwd_atol: float, residuals, g: torch.Tensor,
         check_stride: int = DEFAULT_CHECK_STRIDE, group_axes: int = 0,
         split=None):
    """(W_bar, I_bar) for the rates' cotangent ``g`` at the saved fixed point
    ``residuals = (W, I_ext, r_star, converged)``, reduced to the shapes of
    W and I_ext."""
    W, I_ext = residuals[:2]
    W_bar, philam = _adjoint(cfg, grad_method, bwd_max_iter, bwd_atol,
                             residuals, g, check_stride, group_axes, split)
    return _unbroadcast(W_bar, W.shape), _unbroadcast(philam, I_ext.shape)


def _adjoint(cfg: SSNConfig, grad_method: str, bwd_max_iter: int,
             bwd_atol: float, residuals, g: torch.Tensor, check_stride: int,
             group_axes: int, split=None):
    """(W_bar, phi * lam) in the broadcast shape of ``g`` and the
    residuals, not reduced; the iterative method's stop rule runs per group
    of the ``group_axes`` leading axes (over every rank's circuits of a
    ``split``)."""
    global adjoint_iterations
    W, I_ext, r_star, converged = residuals
    model = None if split is None else split.model
    dtype = W.dtype
    r_star = r_star.to(dtype)
    g = g.to(dtype)
    # (..., S, 2N)
    phi = cfg.io_deriv()(recurrent_drive(W, r_star, I_ext, model))
    ok = converged[..., None]
    zero = torch.zeros((), dtype=dtype, device=W.device)
    g = torch.where(ok, g, zero)
    phi = torch.where(ok, phi, zero)
    if profiling.enabled():
        n2 = W.shape[-2]
        profiling.add(f"ift.adjoint_rows.{n2}", math.prod(
            torch.broadcast_shapes(g.shape, phi.shape)[:-1]))
        profiling.add(f"ift.adjoint_circuits.{n2}", math.prod(W.shape[:-2]))

    if grad_method == "jfb":
        lam = g
    elif grad_method == "direct":
        n2 = W.shape[-2]
        W_all = W if model is None else model.gather_cols(
            W, n2, kind="model_gather_W")
        eye = torch.eye(n2, dtype=dtype, device=W.device)
        # (..., S, 2N, 2N)
        A = eye - phi[..., :, None] * W_all[..., None, :, :]
        # solve_ex: a singular system yields non-finite values, as in the
        # reference, instead of raising
        lam = torch.linalg.solve_ex(A.transpose(-1, -2), g[..., None])[0]
        lam = torch.where(ok, lam[..., 0], zero)
    elif grad_method == "iterative":
        if check_stride < 1:
            raise ValueError(f"check_stride must be >= 1; got {check_stride}")
        alpha = cfg.step_gain(dtype=dtype, device=W.device)
        shape = torch.broadcast_shapes(g.shape, phi.shape)
        groups, per_group = shape[:group_axes], tuple(
            range(group_axes, len(shape)))
        kernel = cfg.backend == "cuda" and W.device.type == "cuda"
        if kernel and model is not None:
            raise ValueError("the adjoint kernel takes whole rows of W; the "
                             "cuda backend splits circuits, not columns")

        def iteration(lam, active):
            """One damped step where ``active``; (lam, this rank's
            max |delta| per group)."""
            jt = torch.matmul(phi * lam, W)
            if model is not None:
                jt = model.gather_cols(jt, lam.shape[-1])
            delta = -lam + jt + g
            lam = torch.where(active.reshape(groups + (1,) * len(per_group)),
                              lam + alpha * delta, lam)
            return lam, delta.abs().amax(per_group)

        def run(start, counts, steps: int, norms: bool = True):
            """``steps`` iterations from ``start``, group k's first
            ``counts[k]`` applied: (lam, this rank's max |delta| per
            iteration and group, or None without ``norms``)."""
            if kernel:
                profiling.add("ift.adjoint_kernel_launches")
                lam, out = ift_adjoint.iterate(W, phi, g, alpha, start,
                                               counts, steps, group_axes,
                                               norms)
                return lam.to(dtype), out
            profiling.add("ift.adjoint_eager_iterations", steps)
            lam, out = start, []
            for i in range(steps):
                lam, norm = iteration(lam, counts > i)
                out.append(norm)
            return lam, torch.stack(out) if norms else None

        if kernel and split is None:
            profiling.add("ift.adjoint_kernel_launches")
            lam, _, n_dev = ift_adjoint.solve(W, phi, g, alpha, bwd_atol,
                                              bwd_max_iter, group_axes)
            lam = lam.to(dtype)
            with profiling.host_sync("ift.stop_test"):
                n_it = n_dev.item()
        else:
            lam = g
            delta_norm = torch.full(groups, float("inf"), dtype=dtype,
                                    device=W.device)
            iters = torch.zeros(groups, dtype=dtype, device=W.device)
            done, n_it = 0, 0.0
            while done < bwd_max_iter:
                steps = min(check_stride, bwd_max_iter - done)
                if split is None:
                    profiling.add("ift.adjoint_eager_iterations", steps)
                    for _ in range(steps):
                        active = delta_norm >= bwd_atol
                        lam, norm = iteration(lam, active)
                        delta_norm = torch.where(active, norm, delta_norm)
                        iters = iters + active
                else:
                    lam, delta_norm, applied = _chunk_over_ranks(
                        run, lam, delta_norm, steps, bwd_atol, split)
                    iters = iters + applied
                done += check_stride
                # one copy: "any group active" and the slowest group's count
                flags = torch.stack([(delta_norm >= bwd_atol).any().to(dtype),
                                     iters.max()])
                with profiling.host_sync("ift.stop_test"):
                    more, n_it = flags.tolist()
                if not more:
                    break
        adjoint_iterations += int(n_it)
        # a non-finite lam of a trusted sample is left in place, so the
        # optimizer's finite-update guard skips the step visibly
        lam = torch.where(ok, lam, zero)
    else:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")

    philam = phi * lam
    r_ok = torch.where(ok, r_star, zero)
    if model is not None:
        r_ok = r_ok[..., model.cols(r_ok.shape[-1])]
    return torch.matmul(philam.transpose(-1, -2), r_ok), philam


def _chunk_over_ranks(run, lam, delta_norm, steps: int, bwd_atol: float,
                      split):
    """``steps`` adjoint iterations on this rank's circuits under the
    stop rule of the whole split batch, at one collective: the chunk runs
    as if no group stopped, recording this rank's max |delta| per
    iteration; one all-reduce gives the batch's, hence the iteration at
    which each group stops; where one stopped inside the chunk, the chunk
    is replayed from its start with those decisions. lam is then the
    unsharded loop's (the same arithmetic up to each stop). ``run(start,
    counts, steps, norms)`` runs the iterations, group k's first
    ``counts[k]`` applied (the plain loop or the kernel). Returns (lam,
    delta_norm, iterations applied per group)."""
    start, live = lam, delta_norm >= bwd_atol
    lam, norms = run(start, live.to(torch.int32) * steps, steps)
    norms = split.max(norms)  # (steps,) + groups
    before = torch.cat([delta_norm[None], norms[:-1]])
    active = torch.cumprod((before >= bwd_atol).to(torch.int32), 0) > 0
    applied = active.sum(0)
    replay = (live & ~active[-1]).any()
    with profiling.host_sync("ift.chunk_over_ranks"):
        replay = bool(replay)
    if replay:
        lam, _ = run(start, applied, steps, norms=False)
    last = norms.gather(0, (applied - 1).clamp(min=0).unsqueeze(0))[0]
    return lam, torch.where(applied > 0, last, delta_norm), applied


def _unbroadcast(bar: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a cotangent to the primal's shape: sum over leading axes the
    primal lacks and over axes where it had size 1 (e.g. I_ext (1, S, 2N)
    against W (B, 2N, 2N))."""
    shape = tuple(shape)
    if tuple(bar.shape) == shape:
        return bar
    extra = bar.ndim - len(shape)
    if extra:
        bar = bar.sum(dim=tuple(range(extra)))
    keep = tuple(ax for ax, (b, p) in enumerate(zip(bar.shape, shape))
                 if b != p and p == 1)
    if keep:
        bar = bar.sum(dim=keep, keepdim=True)
    return bar


class FixedPointRates(torch.autograd.Function):
    """Differentiable fixed-point solve: gradients flow through the rates
    only (the flags and iters are diagnostics)."""

    @staticmethod
    def forward(W, I_ext, cfg, grad_method, bwd_max_iter, bwd_atol,
                check_stride, group_axes, split):
        return tuple(solve_any(cfg, W, I_ext,
                               None if split is None else split.model))

    @staticmethod
    def setup_context(ctx, inputs, output):
        (W, I_ext, cfg, grad_method, bwd_max_iter, bwd_atol, stride,
         group_axes, split) = inputs
        r, converged, diverged, iters = output
        ctx.save_for_backward(W, I_ext, r, converged)
        ctx.mark_non_differentiable(converged, diverged, iters)
        ctx.args = (cfg, grad_method, bwd_max_iter, bwd_atol)
        ctx.check_stride = stride
        ctx.group_axes = group_axes
        ctx.split = split

    @staticmethod
    def backward(ctx, g_r, _g_conv, _g_div, _g_iters):
        W, I_ext, r, converged = ctx.saved_tensors
        with profiling.span("ift.adjoint"):
            W_bar, I_bar = _bwd(*ctx.args, (W, I_ext, r, converged), g_r,
                                ctx.check_stride, ctx.group_axes, ctx.split)
        return (W_bar if ctx.needs_input_grad[0] else None,
                I_bar.to(I_ext.dtype) if ctx.needs_input_grad[1] else None,
                None, None, None, None, None, None, None)


def solve_fixed_point_implicit(
    cfg: SSNConfig,
    W: torch.Tensor,
    I_ext: torch.Tensor,
    grad_method: str = "iterative",
    bwd_max_iter: int = 20000,
    bwd_atol: float = 1e-6,
    check_stride: int = DEFAULT_CHECK_STRIDE,
    group_axes: int = 0,
    split=None,
) -> FixedPointResult:
    """User-facing differentiable fixed-point solve (see module docstring).
    ``group_axes`` leading axes of W (an ensemble's members) are
    independent problems: each keeps its own adjoint stop rule. ``split``:
    W holds this rank's part of a batch split over ranks (see the module
    docstring)."""
    if grad_method not in GRAD_METHODS:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")
    return FixedPointResult(*FixedPointRates.apply(
        W, I_ext, cfg, grad_method, bwd_max_iter, bwd_atol, check_stride,
        group_axes, split))


def vjp_W_batched(cfg: SSNConfig, W: torch.Tensor, I_ext: torch.Tensor,
                  res: FixedPointResult, g: torch.Tensor,
                  grad_method: str = "iterative", bwd_max_iter: int = 20000,
                  bwd_atol: float = 1e-6,
                  check_stride: int = DEFAULT_CHECK_STRIDE) -> torch.Tensor:
    """W's cotangents (C, ..., 2N, 2N) for C rate cotangents ``g`` (C, ...,
    S, 2N) at the fixed point ``res`` of (W, I_ext): ONE adjoint solve for
    the whole chunk, each cotangent with its own stop rule, so each equals
    its own solo backward (the reference's ``vmap`` over ``vjp``)."""
    if grad_method not in GRAD_METHODS:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")
    with profiling.span("ift.adjoint"), torch.no_grad():
        W_bar, _ = _adjoint(cfg, grad_method, bwd_max_iter, bwd_atol,
                            (W, I_ext, res.r, res.converged), g,
                            check_stride, group_axes=1)
    return W_bar
