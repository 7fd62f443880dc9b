"""The fused SSN fixed-point solver on Hopper: wrapper of ``csrc/ssn_solve.cu``.

Replaces the Pallas TPU kernel
``tcgan_tpu/ops/pallas/ssn_solve.py::_solver_kernel`` (launched by
``solve_fixed_point_pallas`` through ``pl.pallas_call``). One thread block
per circuit iterates until all of its stimulus rows resolve, with the
circuit's W resident in shared memory for the whole solve where it fits;
the io function, the stepper gain, the feedforward init, the ceiling clamp,
the per-row residual and peak reductions, the flag and ``iters``
bookkeeping and Anderson(1) are fused into it. Each substep's mat-vec runs
on the tensor cores (warp-level ``mma.sync`` m16n8k8, one warp per 16
neurons); the kernel is bound by its arithmetic and, at small batches, by
the slowest circuit's substep latency (see the note at the top of the CUDA
source). A circuit whose state passes one block's shared memory (2N beyond
about 220, the paper's N=201 among them) is solved by a thread-block
cluster of 2, 4 or 8 blocks, each holding a slab of W's rows and
exchanging rates through distributed shared memory. A battery too large
for a cluster of 8 is split into chunks of rows, each solved by its own
block or cluster against the circuit's whole W (the rows are independent,
so this computes what one block over all rows computes). Where W's slab
leaves no room for 8 rows even in a cluster of 8 (2N >= 598, 578 with
Anderson), W stays in device memory and each warp reads its rows of it
every substep (the W-global path, bit-equal to the shared-W launch at the
same cluster size and rows); a block of a cluster of 8 then holds up to
512 threads, so every 2N <= 2048 is solved. :func:`plan` gives the cluster
size, the chunks and where W is read from.

Precision (``KERNEL_PRECISION``): the mat-vec is 3xTF32, i.e. each fp32
operand is split into a TF32 high part and a TF32 low part and the products
hi*hi, hi*lo and lo*hi are accumulated in fp32, which holds the fp32
lockstep solver's flags and rates (one TF32 pass does not: it changes
flags and leaves rows unconverged at atol 1e-5). Everything else runs in
fp32.

The schedule (:func:`schedule`) is the TPU kernel's. With
``SSNConfig.pallas_two_phase`` (the default) a first phase runs one TF32
pass per product (the tensor cores' fast pass, in the role of the TPU's
default-precision pass) down to a coarse residual, max(100 atol, 1e-2),
within max_iter // 2 substeps; then every flag is cleared (but those of
rows pinned above ``pallas_reopen_margin`` * rate_stop_at, when the margin
is above 0) and the 3xTF32 phase runs on to atol, Anderson's history
restarted. Every flag is thus decided at full precision. The phase boundary
belongs to the unit of launch, one circuit's chunk of rows (:func:`plan`):
the TPU kernel's tile at ``pallas_block_b`` = 1 wherever the battery is one
chunk; ``pallas_block_b`` is not read. With ``pallas_refine`` (the default)
phase 2 is the TPU kernel's refinement tail: once per chunk a 3xTF32 anchor
``W r + I`` at the chunk's input rates, then the substeps on the correction
``e`` from those rates in one TF32 pass, ``u = anchor + W e`` (the pass's
rounding error is relative to the small ``|e|``); the anchor and the input
rates take two more planes of shared memory (one with Anderson), so the
plan may differ from the 3xTF32 tail's (:func:`plan`, ``refine``). Without
it phase 2 is the 3xTF32 loop. With ``pallas_two_phase`` off the kernel
runs the 3xTF32 loop alone.

On CPU tensors :func:`solve_fixed_point_cuda` runs the plain version,
:func:`solve_fixed_point_plain`: in one phase the lockstep solver in fp32,
which has the same per-row semantics (frozen resolved rows, flags from the
plain chunk, the same ``iters`` clamp); in two, the same lockstep with a
phase per chunk of rows, the fast pass (phase 1, and the refinement
tail's ``W e``) in fp32 (what the TPU kernel's default-precision pass
computes on a CPU) unless given another drive (:func:`drive_1xtf32`
computes the kernel's). On CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from tcgan_torch.ops import fixed_point, io_funs
from tcgan_torch.ops.ssn import SSNConfig
from tcgan_torch.utils import profiling

KERNEL_PRECISION = "3xtf32"
# Largest dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
TILE_N = 8  # kTileN in the CUDA source: stimulus rows per mma tile
TILE_M = 16  # kTileM: neurons per warp
MAX_THREADS = 512  # kMaxThreads: threads per block
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks per circuit; 8 is the portable maximum
_IO_CODES = {"asym_power": 0, "asym_tanh": 1, "asym_linear": 2}

# Kernel launches since import (or since a caller reset it to 0), of those
# the launches in two phases, and of those the launches whose phase 2 is the
# refinement tail.
launches = 0
launches_two_phase = 0
launches_refine = 0
# While a profiler runs (tcgan_torch.utils.profiling), the solves' rows
# (host counter ``ssn_solve.rows``), the solves by the plan's cluster size
# (``ssn_solve.launches_cluster.<1, 2, 4 or 8>``), the launches whose
# one-TF32-pass loop ran as independent partial sums
# (``ssn_solve.launches_partial_sums``; both from the plan the launch
# reports, on the CPU from the plain version's plan, with no partial sums)
# and the substeps they ran by phase (a device total each, added by the
# kernel).
SUBSTEPS = ("ssn_solve.phase1_substeps", "ssn_solve.phase2_substeps")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def slab(n2: int, cluster: int) -> int:
    """Neurons per block of a cluster: round_up(ceil(2N / c), 16)."""
    return _round_up(-(-n2 // cluster), TILE_M)


def _layout_bytes(n2: int, S: int, accel: bool, cluster: int, ld: int,
                  lds: int, w_global: bool, refine: bool) -> int:
    rows = _round_up(S, TILE_N)
    w = 0 if w_global else min(slab(n2, cluster), n2)
    slab_planes = (4 if accel else 1) + ((1 if accel else 2) if refine else 0)
    floats = w * ld + 2 * rows * ld + rows * lds * slab_planes
    ints = 2 * S + rows + rows // TILE_N + 1 + (
        3 * cluster * rows if cluster > 1 and accel else 0)
    return 4 * (floats + ints)


def smem_bytes(n2: int, S: int, accel: bool, cluster: int = 1,
               w_global: bool = False, refine: bool = False) -> int:
    """Dynamic shared memory of one block of a cluster of ``cluster``
    blocks per circuit: the layout in ``ssn_solve.cu``. W's rows of the
    block's slab (all 2N at one block; none with ``w_global``) and both
    rate planes at stride ld, the battery, Anderson's planes and, with
    ``refine``, the refinement tail's anchor and input rates (the latter
    Anderson's chunk input where it has one) over the slab at stride lds,
    each the least stride >= its row that is 4 mod 8, or the row rounded up
    to 4 where that padding would not fit."""
    w = min(slab(n2, cluster), n2)
    padded = _layout_bytes(n2, S, accel, cluster, _round_up(n2 + 4, 8) - 4,
                           _round_up(w + 4, 8) - 4, w_global, refine)
    if padded <= MAX_SMEM_BYTES:
        return padded
    return _layout_bytes(n2, S, accel, cluster, _round_up(n2, 4),
                         _round_up(w, 4), w_global, refine)


class Plan(NamedTuple):
    """How the kernel launches an S-row battery: ``chunks`` chunks of
    ``rows`` rows per circuit (the last may be shorter), each on a cluster
    of ``cluster`` blocks, W read from device memory where ``w_global``."""

    cluster: int
    rows: int
    chunks: int
    w_global: bool


def _fits(n2: int, R: int, accel: bool, cluster: int, w_global: bool,
          refine: bool) -> bool:
    return ((cluster > 1 or not w_global)
            and 32 * slab(n2, cluster) // TILE_M <= MAX_THREADS
            and smem_bytes(n2, R, accel, cluster, w_global,
                           refine) <= MAX_SMEM_BYTES)


@functools.cache
def _max_rows(n2: int, accel: bool, cluster: int, w_global: bool,
              refine: bool) -> int:
    """The most rows, a multiple of 8, whose layout fits at this cluster
    size (at least 8: called where 8 fit)."""
    R = TILE_N
    while _fits(n2, R + TILE_N, accel, cluster, w_global, refine):
        R += TILE_N
    return R


def _plan_at(n2: int, S: int, accel: bool, w_global: bool,
             refine: bool) -> Plan | None:
    """The plan at one kind of layout, W in shared memory or not: the least
    cluster size that fits the whole battery, one chunk; else the least at
    which an 8-row chunk fits, K = ceil(S / the most rows that fit there)
    chunks of round_up(ceil(S / K), 8) rows. None where 8 rows fit no
    cluster."""
    for c in CLUSTER_SIZES:
        if _fits(n2, S, accel, c, w_global, refine):
            return Plan(c, S, 1, w_global)
    c = next((c for c in CLUSTER_SIZES if _fits(n2, TILE_N, accel, c,
                                                w_global, refine)), 0)
    if not c:
        return None
    chunks = -(-S // _max_rows(n2, accel, c, w_global, refine))
    return Plan(c, _round_up(-(-S // chunks), TILE_N), chunks, w_global)


def plan(n2: int, S: int, accel: bool, rows: int | None = None,
         w_global: bool = False, refine: bool = False) -> Plan:
    """The launch plan of ``plan()`` in ``ssn_solve.cu``. W in shared
    memory wherever a cluster of :data:`CLUSTER_SIZES` holds 8 rows with
    it: the least cluster size that fits the whole battery, one chunk;
    otherwise the least at which an 8-row chunk fits, K = ceil(S / the most
    rows that fit there) chunks of round_up(ceil(S / K), 8) rows. Past
    that, the same rule with W read from device memory, at cluster sizes 2,
    4 and 8. ``rows`` forces the rows per chunk (at the least cluster size
    that fits them with W in shared memory); ``w_global`` forces W from
    device memory at the plan's cluster size, which must be 2 or more.
    ``refine``: the same rule on the layout of the refinement tail
    (:func:`smem_bytes`), which a launch in that schedule takes.
    Raises ``ValueError`` past 2N = 2048, where a block of a cluster of 8
    would need more than 512 threads."""
    if rows is not None:
        c = next((c for c in CLUSTER_SIZES
                  if _fits(n2, rows, accel, c, False, refine)), 0)
        if rows < 1 or not c:
            raise ValueError(f"2N={n2}: no cluster size fits a chunk of "
                             f"{rows} rows with W in shared memory")
        p = Plan(c, rows, -(-S // rows), False)
    else:
        p = (_plan_at(n2, S, accel, False, refine)
             or _plan_at(n2, S, accel, True, refine))
        if p is None:
            big = CLUSTER_SIZES[-1]
            raise ValueError(
                f"2N={n2}{' with Anderson' if accel else ''}: a block of a "
                f"cluster of {big} would hold {slab(n2, big)} neurons, "
                f"{32 * slab(n2, big) // TILE_M} threads, past the "
                f"{MAX_THREADS}-thread limit of a block (every 2N <= "
                f"{big * MAX_THREADS // 32 * TILE_M} is solved)")
    if w_global and not p.w_global:
        if p.cluster == 1:
            raise ValueError(f"2N={n2}, S={S}: W from device memory needs a "
                             f"cluster of 2 or more blocks; the plan has 1")
        p = p._replace(w_global=True)
    return p


class Schedule(NamedTuple):
    """The kernel's schedule: in two phases or one; phase 1's residual and
    substep budget; the peak above which a phase-1 diverged row keeps its
    flag (0: every row reopens); whether phase 2 is the refinement tail."""

    two_phase: bool
    coarse: float
    max_iter1: int
    reopen_at: float
    refine: bool


def schedule(cfg: SSNConfig) -> Schedule:
    """The schedule ``cfg`` asks for (the TPU kernel's ``_solver_kernel``
    :291-343): phase 1 to max(100 atol, 1e-2) within max_iter // 2
    substeps; rows pinned above ``pallas_reopen_margin`` * rate_stop_at keep
    their phase-1 divergence flag where the margin is above 0; phase 2 in
    the refinement tail with ``pallas_refine``, which (as in the TPU
    kernel, :339) acts in two phases only. Raises ``ValueError`` on a flag
    that is not a bool or a margin that is not a finite number >= 0."""
    for name in ("pallas_two_phase", "pallas_refine"):
        if not isinstance(getattr(cfg, name), bool):
            raise ValueError(f"{name} must be a bool; got "
                             f"{getattr(cfg, name)!r}")
    m = cfg.pallas_reopen_margin
    if (isinstance(m, bool) or not isinstance(m, (int, float))
            or not math.isfinite(m) or m < 0):
        raise ValueError("pallas_reopen_margin must be a finite number >= 0 "
                         f"(0: every row reopens); got {m!r}")
    return Schedule(cfg.pallas_two_phase, max(cfg.atol * 100.0, 1e-2),
                    cfg.max_iter // 2,
                    m * cfg.rate_stop_at if m > 0 else 0.0,
                    cfg.pallas_two_phase and cfg.pallas_refine)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10-bit mantissa), to nearest, ties away from
    zero, as the kernel's ``rna_tf32``: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def drive_1xtf32(W: torch.Tensor, r: torch.Tensor,
                 I_ext: torch.Tensor) -> torch.Tensor:
    """u = r @ W^T + I in one TF32 pass, as the kernel's phase 1 and the
    refinement tail's ``W e`` (with I = 0) compute it: both operands
    rounded to TF32, exact products summed in fp32 (in another order than
    the tensor cores')."""
    return torch.matmul(rna_tf32(r), rna_tf32(W.transpose(-1, -2))) + I_ext


def drive_3xtf32(W: torch.Tensor, r: torch.Tensor,
                 I_ext: torch.Tensor) -> torch.Tensor:
    """u = r @ W^T + I in 3xTF32, as the kernel's 3xTF32 loop and the
    refinement tail's anchor compute it: each operand split into TF32 high
    and low parts, u = hh + (hl + lh) + I with hh = W_hi r_hi, hl = W_hi
    r_lo, lh = W_lo r_hi, each product exact and each sum in fp32."""
    Wt = W.transpose(-1, -2)
    W_hi, r_hi = rna_tf32(Wt), rna_tf32(r)
    W_lo, r_lo = rna_tf32(Wt - W_hi), rna_tf32(r - r_hi)
    hh = torch.matmul(r_hi, W_hi)
    hl = torch.matmul(r_lo, W_hi)
    lh = torch.matmul(r_hi, W_lo)
    return hh + (hl + lh) + I_ext


def solve_fixed_point_plain(cfg: SSNConfig, W: torch.Tensor,
                            I_ext: torch.Tensor, check_every: int = 1,
                            accel: bool = False, fast_drive=None,
                            stop_at: torch.Tensor | None = None,
                            stats: dict | None = None
                            ) -> fixed_point.FixedPointResult:
    """The kernel's function in plain torch, in fp32: the lockstep solve
    (``fixed_point.solve_fixed_point``) in the schedule of :func:`schedule`,
    in two phases with a phase per tile, one chunk of rows of one circuit
    as :func:`plan` cuts the battery (``fixed_point.TwoPhase``), phase 2 in
    the refinement tail where the schedule asks for it. The fast pass,
    phase 1's drive and the tail's ``W e``, is ``fast_drive(W, r, I)``
    (default: the fp32 drive; :func:`drive_1xtf32` computes the kernel's).
    ``stop_at`` (B, S) replays a launch's rows to their ``iters``, and
    ``stats`` receives the substeps each row ran in each phase, as
    ``solve_fixed_point`` takes them, and under ``plan`` the launch's
    :func:`plan`. Raises ``ValueError`` where the kernel has no plan."""
    cfg = dataclasses.replace(cfg, accel="anderson" if accel else "none")
    W, I_ext = W.to(torch.float32), I_ext.to(torch.float32)
    sched = schedule(cfg)
    p = plan(W.shape[-1], I_ext.shape[-2], accel, refine=sched.refine)
    if stats is not None:
        stats["plan"] = p
    two_phase = None
    if sched.two_phase:
        two_phase = fixed_point.TwoPhase(p.rows, sched.coarse,
                                         sched.max_iter1, sched.reopen_at,
                                         fast_drive, sched.refine)
    return fixed_point.solve_fixed_point(
        cfg, W, I_ext, check_every=check_every, two_phase=two_phase,
        stop_at=stop_at, stats=stats)


def bind(path) -> ctypes.CDLL:
    """Load a built solver library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ssn_solve_run.argtypes = ([p] * 7 + [i] * 4 + [f] * 9 + [i] * 4
                                  + [p] + [i, i, i, f, i, f, p, p])
    lib.ssn_solve_run.restype = i
    lib.ssn_solve_query.argtypes = [i, i, i, i, p]
    lib.ssn_solve_query.restype = i
    lib.ssn_solve_error_string.argtypes = [i]
    lib.ssn_solve_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/ssn_solve.cu``."""
    from tcgan_torch.ops.cuda import build

    return bind(build.build("ssn_solve").path)


class Query(NamedTuple):
    """The compiled kernel's plan of a shape in a schedule (``ssn_solve_query``
    in ``ssn_solve.cu``), its shared memory per block, its occupancy on the
    current device (blocks per SM and chunks of rows at once), and whether
    its one-pass loop runs as partial sums."""

    plan: Plan
    smem_bytes: int
    blocks_per_sm: int
    chunks_at_once: int
    partial_sums: bool


def query(n2: int, S: int, accel: bool = False, refine: bool = False,
          device: torch.device | str = "cuda", lib=None) -> Query:
    """The kernel's own plan and occupancy at this shape, in one phase (the
    same plan as two phases with the 3xTF32 tail) or, with ``refine``, in
    two phases with the refinement tail; raises ``ValueError`` where no
    layout fits, ``RuntimeError`` where the runtime's query fails."""
    lib = lib or _library()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        err = lib.ssn_solve_query(n2, S, int(accel), 2 if refine else 0, out)
    if err == 1:  # cudaErrorInvalidValue: no layout fits
        raise ValueError(f"2N={n2}, S={S}: the kernel has no plan")
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err} "
                           f"({lib.ssn_solve_error_string(err).decode()})")
    c, rows, chunks, wg, nbytes, blocks, at_once, partials = out
    return Query(Plan(c, rows, chunks, bool(wg)), nbytes, blocks, at_once,
                 bool(partials))


def solve_fixed_point_cuda(cfg: SSNConfig, W: torch.Tensor,
                           I_ext: torch.Tensor, check_every: int = 1,
                           accel: bool = False
                           ) -> fixed_point.FixedPointResult:
    """Fixed-point solve of W (B, 2N, 2N) under a shared battery I (S, 2N).

    Returns fp32 rates (B, S, 2N), bool converged/diverged (B, S) and int32
    iters (B, S), on the inputs' device, one launch for any S, in the
    schedule of :func:`schedule`. Raises ``ValueError`` past 2N = 2048
    (:func:`plan`; every S is solved below) or on a bad schedule flag, and
    ``RuntimeError`` when the launch fails. While a profiler runs it counts
    the rows, the solve under its plan's cluster size, the launch again if
    its one-pass loop ran as partial sums, and the rows' substeps by phase
    (:data:`SUBSTEPS`): on the card from the plan the launch reports and the
    kernel's totals, on the CPU from the plain version's plan and ``stats``
    (no kernel, so no partial sums); and it spans the launch's host side
    (``ssn_solve.launch``).
    """
    global launches, launches_two_phase, launches_refine
    if (W.ndim != 3 or I_ext.ndim != 2 or W.shape[1] != W.shape[2]
            or I_ext.shape[1] != W.shape[2]):
        raise ValueError("expected W (B, 2N, 2N) and I_ext (S, 2N); got "
                         f"{tuple(W.shape)} and {tuple(I_ext.shape)}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1; got {check_every}")
    B, n2 = W.shape[0], W.shape[2]
    S = I_ext.shape[0]
    sched = schedule(cfg)  # raises on a bad flag
    if W.device.type == "cpu" and I_ext.device.type == "cpu":
        if not profiling.enabled():
            return solve_fixed_point_plain(cfg, W, I_ext, check_every, accel)
        stats = {}
        out = solve_fixed_point_plain(cfg, W, I_ext, check_every, accel,
                                      stats=stats)
        profiling.device_totals(SUBSTEPS, W.device).add_(torch.stack(
            [stats[k].sum(dtype=torch.int64)
             for k in ("phase1_substeps", "phase2_substeps")]))
        p, partials = stats["plan"], False
    else:
        if W.device.type != "cuda" or I_ext.device != W.device:
            raise ValueError("W and I_ext must both be CPU tensors or both "
                             f"lie on one CUDA device; got {W.device} and "
                             f"{I_ext.device}")
        if B == 0 or S == 0:
            return _outputs(B, S, n2, W.device)
        with profiling.span("ssn_solve.launch"):
            substeps = (profiling.device_totals(SUBSTEPS, W.device)
                        if profiling.enabled() else None)
            out, p, partials = launch(_library(), cfg, W, I_ext, check_every,
                                      accel, substeps=substeps)
        launches += 1
        launches_two_phase += sched.two_phase
        launches_refine += sched.refine
    profiling.add("ssn_solve.rows", B * S)
    profiling.add(f"ssn_solve.launches_cluster.{p.cluster}")
    if partials:
        profiling.add("ssn_solve.launches_partial_sums")
    return out


def _outputs(B: int, S: int, n2: int, device) -> fixed_point.FixedPointResult:
    return fixed_point.FixedPointResult(
        torch.empty((B, S, n2), dtype=torch.float32, device=device),
        torch.empty((B, S), dtype=torch.bool, device=device),
        torch.empty((B, S), dtype=torch.bool, device=device),
        torch.empty((B, S), dtype=torch.int32, device=device))


def launch(lib: ctypes.CDLL, cfg: SSNConfig, W: torch.Tensor,
           I_ext: torch.Tensor, check_every: int, accel: bool,
           rows_per_chunk: int | None = None, w_global: bool = False,
           sched: Schedule | None = None,
           substeps: torch.Tensor | None = None
           ) -> tuple[fixed_point.FixedPointResult, Plan, bool]:
    """One launch of the solver in ``lib`` (see :func:`bind`) on CUDA
    tensors that :func:`solve_fixed_point_cuda` has checked, in the
    schedule of :func:`schedule`: (outputs, the plan the kernel took,
    whether its one-pass loop ran as partial sums). Raises ``ValueError``
    where no layout fits (the message of :func:`plan`), ``RuntimeError``
    where the launch fails. Counts nothing. ``rows_per_chunk`` forces the
    plan's rows per chunk (``plan(..., rows=)``), so that a split launch can
    be held to an unsplit one; ``w_global`` forces W from device memory at
    the plan's cluster size (``plan(..., w_global=)``), so that the W-global
    path can be held to the shared-W one. ``sched`` replaces
    ``schedule(cfg)`` (a tool's phase budget, for example). ``substeps``: an
    int64 buffer of two on the device to which the launch adds its rows'
    substeps in phase 1 and in phase 2 (one phase: all in phase 2)."""
    B, n2, S = W.shape[0], W.shape[2], I_ext.shape[0]
    sched = sched or schedule(cfg)
    device = W.device
    W32 = W.to(torch.float32).contiguous()
    I32 = I_ext.to(torch.float32).contiguous()
    alpha = cfg.step_gain(dtype=torch.float32, device=device).contiguous()
    r, conv, div, iters = out = _outputs(B, S, n2, device)
    u0, slope = io_funs.linear_knee(cfg.k, cfg.n, cfg.rate_soft_bound)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    taken = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.ssn_solve_run(
            ptr(W32), ptr(I32), ptr(alpha), ptr(r), ptr(conv), ptr(div),
            ptr(iters), B, n2, S, _IO_CODES[cfg.io_type], cfg.k, cfg.n,
            cfg.rate_soft_bound, cfg.rate_hard_bound, u0, slope, cfg.atol,
            cfg.rate_stop_at, 10.0 * cfg.rate_stop_at, cfg.max_iter,
            check_every, int(cfg.init == "feedforward"), int(accel),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
            rows_per_chunk or 0, int(w_global),
            (2 if sched.refine else 1) if sched.two_phase else 0,
            sched.coarse, sched.max_iter1, sched.reopen_at,
            None if substeps is None else ptr(substeps), taken)
    if err == 1:  # cudaErrorInvalidValue: no layout fits; plan() says why
        plan(n2, S, accel, rows_per_chunk, w_global, sched.refine)
    if err:
        raise RuntimeError(
            f"ssn_solve launch failed: cudaError {err} "
            f"({lib.ssn_solve_error_string(err).decode()})")
    c, rows, chunks, wg, partials = taken
    return out, Plan(c, rows, chunks, bool(wg)), bool(partials)
