"""The implicit adjoint's damped iteration on Hopper: wrapper of
``csrc/ift_adjoint.cu``.

Replaces no TPU kernel: the reference runs this loop as a
``lax.while_loop`` (``tcgan_tpu/ops/ift.py::_bwd``). It runs the iterative
adjoint of :mod:`tcgan_torch.ops.ift` on the card in one cooperative
launch, in place of the eager loop's ~12 launches an iteration. Per
circuit, with lam0 = g,

    delta = -lam + (phi * lam) W + g,   lam <- lam + alpha * delta

where the circuit's group is active. :func:`solve` decides the stop rule
on the device, as the eager loop does on the host: every group runs the
first iteration, and a group stops after the first iteration whose max
|delta| over its circuits is below ``atol`` or is NaN, or at ``max_iter``.
:func:`iterate` runs group k's first ``counts[k]`` iterations from a given
lam, recording each iteration's max |delta| per group, for the stop test
of a batch split over ranks (``ops/ift.py::_chunk_over_ranks``).

The plain version is the eager loop in ``ops/ift.py``, the only path for
CPU tensors; these functions take CUDA tensors alone and raise on
anything else (:func:`problem`). They run in W's dtype, in full precision
(FFMA, no TF32), half types widened to float32 as the solver kernel widens
them. W lies in shared memory where a circuit's W fits a block, else in
device memory (:func:`query`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tcgan_torch.utils import profiling

_DTYPES = {torch.float32: 0, torch.float64: 1}
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
# The kernel's arithmetic for each dtype it takes: half types widened to
# float32, as the solver kernel widens them; float64 never narrowed.
_COMPUTE = {torch.float32: torch.float32, torch.float64: torch.float64,
            torch.bfloat16: torch.float32, torch.float16: torch.float32}

# Kernel launches since import (or since a caller reset it to 0). While a
# profiler runs (tcgan_torch.utils.profiling), the launches whose plan reads
# W from device memory are counted as ``ift.adjoint_w_device_launches``.
launches = 0


def bind(path) -> ctypes.CDLL:
    """Load a built adjoint library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ift_adjoint_launch.argtypes = ([i] + [p] * 7 + [i] * 5 + [d]
                                       + [p] * 6)
    lib.ift_adjoint_launch.restype = i
    lib.ift_adjoint_query.argtypes = [i] * 4 + [p]
    lib.ift_adjoint_query.restype = i
    lib.ift_adjoint_slots_per_group.argtypes = []
    lib.ift_adjoint_slots_per_group.restype = i
    lib.ift_adjoint_error_string.argtypes = [i]
    lib.ift_adjoint_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/ift_adjoint.cu``."""
    from tcgan_torch.ops.cuda import build

    return bind(build.build("ift_adjoint").path)


class Plan(NamedTuple):
    """The launch's plan: W in shared memory or device memory, circuits a
    block holds, blocks, threads a block, blocks an SM holds, shared
    memory a block."""

    w_shared: bool
    circuits_per_block: int
    grid: int
    threads: int
    blocks_per_sm: int
    smem_bytes: int


def _raise(lib, err: int, what: str):
    raise RuntimeError(f"ift_adjoint {what} failed: cudaError {err} "
                       f"({lib.ift_adjoint_error_string(err).decode()})")


def query(C: int, S: int, n2: int, dtype=torch.float32,
          device: torch.device | str = "cuda") -> Plan:
    """The kernel's plan for C circuits of S rows and 2N = ``n2`` neurons
    on ``device``."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.ift_adjoint_query(_DTYPES[dtype], C, S, n2, out)
    if err:
        _raise(lib, err, "query")
    return Plan(bool(out[0]), *out[1:])


class Problem(NamedTuple):
    """The launch's operands: phi and g broadcast to lam's shape (..., S,
    2N) and contiguous, W contiguous with the index of each circuit's
    matrix (None where circuit c has W's c-th), alpha, and the circuit
    and group counts."""

    shape: torch.Size
    W: torch.Tensor
    w_index: torch.Tensor | None
    phi: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    circuits: int
    groups: int


def problem(W: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
            alpha: torch.Tensor, group_axes: int) -> Problem:
    """Check and lay out the operands, in float64 for float64 and float32
    otherwise; raises ``ValueError`` on what the kernel does not take:
    tensors off one CUDA device, a dtype other than float64, float32,
    bfloat16 or float16 or one that differs between them, shapes that do
    not broadcast to (..., S, 2N) against W (..., 2N, 2N), or group axes
    beyond the batch's."""
    ts = (W, phi, g, alpha)
    if any(t.device.type != "cuda" or t.device != W.device for t in ts):
        raise ValueError("the adjoint kernel takes tensors on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    if W.dtype not in _COMPUTE or any(t.dtype != W.dtype for t in ts):
        raise ValueError("the adjoint kernel takes one floating dtype for "
                         f"all; got {[t.dtype for t in ts]}")
    W, phi, g, alpha = (t.to(_COMPUTE[W.dtype]) for t in ts)
    shape = torch.broadcast_shapes(g.shape, phi.shape)
    n2 = W.shape[-1]
    if (len(shape) < 2 or W.ndim < 2 or W.shape[-2] != n2
            or shape[-1] != n2 or tuple(alpha.shape) != (n2,)):
        raise ValueError("expected W (..., 2N, 2N), phi and g broadcasting "
                         "to (..., S, 2N) and alpha (2N,); got "
                         f"{tuple(W.shape)}, {tuple(phi.shape)}, "
                         f"{tuple(g.shape)}, {tuple(alpha.shape)}")
    if not 0 <= group_axes <= len(shape) - 2:
        raise ValueError(f"group_axes must lie in [0, {len(shape) - 2}]; "
                         f"got {group_axes}")
    batch = shape[:-2]
    if torch.broadcast_shapes(W.shape[:-2], batch) != batch:
        raise ValueError(f"W's batch {tuple(W.shape[:-2])} does not "
                         f"broadcast to the cotangent's {tuple(batch)}")
    w_index = None
    if tuple(W.shape[:-2]) != tuple(batch):
        w_index = torch.arange(math.prod(W.shape[:-2]), dtype=torch.int32,
                               device=W.device).reshape(W.shape[:-2])
        w_index = w_index.expand(batch).contiguous()
    return Problem(shape, W.contiguous(), w_index,
                   phi.expand(shape).contiguous(),
                   g.expand(shape).contiguous(), alpha.contiguous(),
                   math.prod(batch), math.prod(shape[:group_axes]))


# The launch as a dispatcher op, so that a profiler records it as a host op
# inside the caller's span and links the kernel to it.
_OPS = torch.library.Library("tcgan", "DEF")
_OPS.define(
    "ift_adjoint(Tensor W, Tensor? w_index, Tensor phi, Tensor g, "
    "Tensor alpha, Tensor lam0, Tensor(a!) lam, int circuits, int groups, "
    "int max_iter, float atol, Tensor(b!)? slots, Tensor(c!)? iters, "
    "Tensor(d!)? iters_max, Tensor? counts, Tensor(e!)? norms) -> ()")


def _launch_impl(W, w_index, phi, g, alpha, lam0, lam, circuits, groups,
                 max_iter, atol, slots, iters, iters_max, counts, norms):
    lib = _library()
    ptr = lambda t: None if t is None else ctypes.c_void_p(  # noqa: E731
        t.data_ptr())
    with torch.cuda.device(W.device):
        err = lib.ift_adjoint_launch(
            _DTYPES[W.dtype], ptr(W), ptr(w_index), ptr(phi), ptr(g),
            ptr(alpha), ptr(lam0), ptr(lam), circuits, groups, g.shape[-2],
            g.shape[-1], max_iter, atol, ptr(slots), ptr(iters),
            ptr(iters_max), ptr(counts), ptr(norms),
            ctypes.c_void_p(torch.cuda.current_stream(W.device).cuda_stream))
    if err:
        _raise(lib, err, "launch")


_OPS.impl("ift_adjoint", _launch_impl, "CUDA")


def _launch(pr: Problem, lam0: torch.Tensor, max_iter: int, atol: float,
            stop_outputs, counts, norms) -> torch.Tensor:
    global launches
    lam = torch.empty_like(pr.g)
    slots, iters, iters_max = stop_outputs or (None,) * 3
    if profiling.enabled() and not query(
            pr.circuits, pr.shape[-2], pr.shape[-1], pr.W.dtype,
            pr.W.device).w_shared:
        profiling.add("ift.adjoint_w_device_launches")
    torch.ops.tcgan.ift_adjoint(
        pr.W, pr.w_index, pr.phi, pr.g, pr.alpha, lam0, lam, pr.circuits,
        pr.groups, max_iter, float(atol), slots, iters, iters_max, counts,
        norms)
    launches += 1
    return lam


def solve(W: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
          alpha: torch.Tensor, atol: float, max_iter: int,
          group_axes: int = 0):
    """The adjoint under the device's stop rule, one launch: (lam of
    lam's broadcast shape, in the kernel's arithmetic (:func:`problem`),
    int32 iterations per group (the ``group_axes`` leading axes), the
    slowest group's count as an int32 scalar on the device). Nothing is
    read back to the host."""
    pr = problem(W, phi, g, alpha, group_axes)
    groups = pr.shape[:group_axes]
    dev = W.device
    iters = torch.empty(groups, dtype=torch.int32, device=dev)
    iters_max = torch.empty((), dtype=torch.int32, device=dev)
    if pr.circuits == 0 or max_iter < 1:
        return pr.g.clone(), iters.zero_(), iters_max.zero_()
    slots = torch.empty(_library().ift_adjoint_slots_per_group() * pr.groups,
                        dtype=_BITS[pr.W.dtype], device=dev)
    lam = _launch(pr, pr.g, max_iter, atol, (slots, iters, iters_max), None,
                  None)
    return lam, iters, iters_max


def iterate(W: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
            alpha: torch.Tensor, lam0: torch.Tensor, counts: torch.Tensor,
            steps: int, group_axes: int = 0, norms: bool = True):
    """``steps`` iterations from ``lam0``, group k's first ``counts[k]``
    (<= steps) of them applied, one launch: (lam, each iteration's max
    |delta| per group, (steps,) + groups, 0 where a group did not run,
    or None without ``norms``)."""
    pr = problem(W, phi, g, alpha, group_axes)
    groups = pr.shape[:group_axes]
    if tuple(counts.shape) != tuple(groups) or counts.device != W.device:
        raise ValueError(f"counts must be {tuple(groups)} on {W.device}; "
                         f"got {tuple(counts.shape)} on {counts.device}")
    rec = (torch.zeros((steps,) + tuple(groups), dtype=pr.W.dtype,
                       device=W.device) if norms else None)
    lam0 = lam0.to(pr.W.dtype).expand(pr.shape).contiguous()
    if pr.circuits == 0 or steps < 1:
        return lam0.clone(), rec
    lam = _launch(pr, lam0, steps, 0.0, None,
                  counts.to(torch.int32).contiguous(), rec)
    return lam, rec
