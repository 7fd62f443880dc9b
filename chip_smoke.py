"""Drive the PyTorch/CUDA port once on one GPU and check its kernel.

Run from the repository root, with one CUDA device visible:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build the SSN solver kernel (``tcgan_torch/csrc/ssn_solve.cu``) with nvcc;
3. kernel against its plain PyTorch version on the card at the shapes of
   the main paths (``tcgan_torch/tools/ssn_solve_ab.py::SHAPES``: N=51 with
   the 8-stimulus battery at 512 and 32 circuits, the 16-stimulus GAN
   battery at 256 circuits and atol 1e-5) and at the shared-memory limit
   (2N=224, 8 stimuli), each with its time (median of 5), its bound from
   the run's own iters (the mat-vec as 3 TF32 passes at the tensor cores'
   peak; the fp32-peak figure beside), the share of that bound and the
   slowest circuit's time per substep; then 2N=224 with the slice's J and
   D unscaled, where a row outside rtol/atol is held to the fp32
   trajectory at its own iters (the float64 solve printed beside); then at
   32 circuits for each io type, the expo stepper, feedforward init,
   Anderson(1), a ragged batch and a batch of hard divergers; then past one
   block's shared memory, on thread-block clusters
   (``ssn_solve_ab.CLUSTER_SHAPES``: 2N=240, 402 at S=8, 16 with Anderson
   and atol 1e-5, and 24, and 512) and past a cluster of 8, each circuit's
   rows in chunks (``ssn_solve_ab.SPLIT_SHAPES``: 2N=402 at S=32 with
   Anderson and 48, 512 at 24, 102 at 256), J and D scaled to N, each with
   its time, bound, share, plan (cluster size, rows per chunk, chunks;
   the C entry points' and the wrapper's must agree) and circuits at once,
   a row outside rtol/atol held to its own fp32 trajectory, and each chunk
   held bit for bit to its rows launched alone; a battery forced into
   chunks of 8 rows held bit for bit to the same battery in one chunk
   (2N=102, S=32, with and without Anderson); split batteries to contrast
   20 (phase 4c's at 2N=402 with Anderson, 32 contrasts at N=51) with
   flags and rates against the fp32 plain solve and their iters gaps
   beside those between the fp32 and float64 plain solves
   (``_split_witness``); past a cluster of 8's shared memory at 8 rows, W
   read from device memory (``ssn_solve_ab.GLOBAL_SHAPES``: 2N=600 at S=8,
   B=64, at the GAN battery (S=16, atol 1e-5) and S=24, B=16, and at S=32,
   B=16 with Anderson, 2N=1024 at S=8, B=16, 2N=2048 at S=8, B=4), each
   with its time, bound, share, plan and circuits at once;
   the W-global path forced at 2N=402 (S=8, and S=32 with Anderson in row
   chunks) held bit for bit to the shared-W launch; the plain version's
   time at 512 circuits, at 2N=402 and at 2N=600. All of these run one
   phase (``--pallas-two-phase off``), as before the two-phase schedule,
   so their times and digests compare with earlier runs. Then the
   two-phase schedule, the CLI's default (``ab.TWO_PHASE_SHAPES``: N=51 at
   B=512 S=8, B=256 S=16 atol 1e-5, B=32 S=8, and B=256 at S=24 and 32
   (3 and 4 row tiles) on the register path,
   2N=224, 2N=402 on clusters of 4, 2N=402 S=32 with Anderson in row
   chunks, 2N=600 with W from device memory), with the refinement tail
   (the default) and with the 3xTF32 tail (``--pallas-refine off``), each
   held to the plain version in its schedule with the fast pass (phase 1,
   the tail's ``W e``) in emulated TF32, and the three schedules timed in
   turns (``[refine]`` lines), each beside its bound and phase 1's share
   of the substeps; hard divergers and the slice's circuit with J x4 at
   reopen margins 0 and 2.0 (the same flags; no more iters on a diverged
   row at 2.0);
4. the serving path: ``python -m tcgan_torch.run.forward`` (through its
   ``main``) with the CUDA backend, 8 batches of 512 circuits, checked for
   launches (all in the default schedule), shapes, convergence and
   agreement with the plain version; 2 batches with ``--pallas-refine
   off`` (the 3xTF32 tail) and 2 with ``--pallas-two-phase off`` (one
   phase), each checked the same way, their circuits/s beside; then one
   batch on the 24-stimulus battery;
4b. the paper's circuit, N=201, through ``run.forward``: 4 batches of 64
   circuits (one launch each, batch 0 against the plain solve, circuits/s),
   then 2 batches with the reference's ``--solver-backend pallas``;
4c. the same circuit with the 32-row battery (contrasts 5, 10, 13, 20) and
   ``--accel anderson``, past a cluster of 8: 2 batches of 64, one launch
   each (4 chunks of 8 rows per circuit), batch 0 against the plain solve
   (a row outside rtol/atol that stopped at another substep passes where
   the plain version run to the kernel's iters for it agrees, ``_witness``;
   at most 8), circuits/s;
4d. past a cluster's shared memory, N=300 (2N=600, J and D scaled by
   51/300; W read from device memory), through ``run.forward``: 2 batches
   of 64 circuits (one launch each, batch 0 against the plain solve), then
   2 with ``--solver-backend pallas``; then ``run.gan --N 300`` at 16
   circuits a batch with the round-2 battery for 2 steps (fake truth of
   128 circuits), launches checked against the step schedule, and its
   first solve (the fake truth's first batch, 64 circuits) held to the
   plain solve;
5. implicit gradients on the card: at N=51, 256 circuits and the GAN
   battery (8 bandwidths x contrasts 5, 10), the gradient of the mean probe
   rate with respect to the log-space (J, D, S), with the kernel forward
   and with the plain forward under the same adjoint, held to a relative
   tolerance (the plain forward: the kernel's plain version, phase 1 in
   emulated TF32); the adjoint's iterations and host syncs; the forward
   kernel's time; the adjoint kernel against the plain loop on the same
   inputs at that shape and at 2N=600 (W in device memory): W_bar and
   I_bar held to a relative tolerance, iterations equal, one launch an
   adjoint, the kernel's time beside its bound and the whole adjoint's
   through the kernel and through the plain loop; the solver kernel's
   blocks per SM at that battery and the waves a 256-circuit batch takes;
6. the training path: ``python -m tcgan_torch.run.gan`` (through its
   ``main``) at the round-2 GAN configuration (N=51, 16 conditions, 256
   circuits per batch, fake truth, start +30% J and -30% D off truth) for 6
   steps with a checkpoint every 3, then ``--resume`` for 2 more, then 2
   steps with the moment anchor (2 updates); checked for launches against
   the step schedule, finite losses, one row per step, the start
   parameters, checkpoints, the parameter export and convergence; then
   ``wgan_step_ms`` at the bench configuration of the JAX package
   (``bench.py::_wgan_step_ms``) and the step's device-time split from
   ``torch.profiler``; the round-2 step the same way at reopen margin 0
   (the default), at 2.0 and with ``--pallas-two-phase off``;
7. BPTT (config C3): at N=51 and the GAN battery, the gradient of the mean
   probe rate with respect to the log-space (J, D, S) through 4000 Euler
   steps for 8 circuits on the card, held to the same computation in
   float64 on the CPU; chunked (100 steps) against unchunked at 32
   circuits, with the peak device memory of each; ``run.bptt_wgan
   --seqlen 4000 --bptt-checkpoint-chunk 100`` at 256 circuits for 2 steps
   and ``--resume`` for 1, launching the kernel for the fake truth only;
   the device-time split of a BPTT step (at 400 Euler steps: the profiler
   records every op of the unroll);
8. the conditional WGAN (C4): ``run.bptt_cwgan --solver ift`` at the
   round-2 configuration for 4 steps and ``--resume`` for 2, launches
   checked against the step schedule, then ``--solver bptt`` for 1 step at
   32 circuits; the device-time split of the conditional step;
9. moment matching (C5): ``run.moments --moment-ema 0.99 --fixed-z`` at 64
   circuits for 6 steps and ``--resume`` for 2 (one launch per step after
   the fake truth; the z-set checkpointed before the resume is the one in
   the state after it), then ``run.bptt_moments`` for 1 step; the
   device-time split of a moment-matching step;
10. the multi-start ensemble (``run.ensemble``): 8 WGAN members of 64
   circuits (start jitter 0.05) for 3 steps and ``--resume`` for 1, 4
   conditional members for 2 steps, 8 moment-matching members (fixed z,
   EMA 0.99, one fake truth per member) for 3 steps; launches per step
   checked against ONE fit's schedule (all members in one launch per
   solve), finite losses and ``frac_converged`` >= 0.99 per member, K rows
   per step, the parameter export, member 0's exact start; then member m
   of one ensemble step against ``wgan.train_step_impl`` run alone on
   member m's state and noise (params, metrics and the first Adam
   moments, which carry the raw gradients; beside them, the same step with
   one adjoint stop rule over all members), and the ensemble step's host
   time, device busy time and idle share beside one single-member step's;
11. ``run.eval`` on phase 6's ``run.gan`` datastore (256 circuits: one
   launch after the fake truth), then with ``--params-source npz``;
12. ``analysis.identifiability`` on the round-2 battery and the 24-row one
   (256 circuits, a 4096-sample precision report) with the kernel forward
   and with the plain forward, the Jacobians held to each other, then
   ``analysis.uncertainty`` on phase 6's run;
13. the native CPU baseline (``csrc/ssnode.cpp`` through
   ``tcgan_torch/ops/native.py``) at N=51, S=8, 32 circuits in float64,
   held to the plain lockstep solve in float64, and its circuits/s on the
   host's CPU beside the kernel's;
14. the post-fit analysis CLIs on this machine, which has no jax and no
   matplotlib: ``report``, ``fit_quality``, ``learning_curves``,
   ``compare`` and ``recovery_gate`` (on its exit codes) on phase 6's run,
   ``report`` and ``ensemble_view`` on phase 10's ensemble; each finishes
   and says its figure was skipped;
15. ``--parallel mesh`` (``tcgan_torch/parallel``): (a) ``run.gan`` at the
   round-2 configuration for 3 steps, ``run.moments --fixed-z`` at 64
   circuits for 3 and ``run.forward`` for 2 batches of 512, each on one
   NCCL rank per card and against the unsharded run of the same seed
   (learning rows to rtol 1e-4, the npz bit-equal, the same launches);
   (b) two gloo ranks sharing the card: ``make_sharded_gan_step`` at the
   round-2 shape, each rank launching the kernel on its 128 of 256
   circuits, held to the unsharded step on the same noise (losses to
   rtol 1e-4, generator parameters and first Adam moments to 1e-6), with one
   step's host time, each rank's device busy time and the collectives per
   step; then an 8 x 64 ensemble split 4 + 4 against the unsharded
   ensemble step; (c) ``tcgan_torch.entry.dryrun_multichip(4,
   device="cpu")`` on 4 gloo CPU ranks (a 2 x 2 mesh, W's columns over the
   model axis); (d) the model axis on the card: two gloo ranks sharing it
   as a 1 x 2 (batch x model) mesh: the round-2 generator forward and
   WGAN step on the kernel, where the model group splits the circuits (6
   launches a rank on 128 circuits each; rates, flags and iters bit-equal
   to one unsharded launch; the step within MESH_RTOL / MESH_GRAD_RTOL of
   the unsharded step), the same step with the direct adjoint and a BPTT
   step (seqlen cut to 200, chunk 100; gate MODEL_BPTT_RTOL), both with
   W's 102 columns split 51 a rank, and the paper's N=201 forward at 64
   circuits (a cluster launch a rank on 32, bit-equal), each rank's
   launches, circuits per launch, collectives, host and device-busy ms.

Every phase prints its seconds.

Every path runs the CLI's default schedule, two phases with the
refinement tail, but phase 4's runs with ``--pallas-refine off`` and
``--pallas-two-phase off``; a ``_plain`` comparison runs the plain version
in the schedule of the config it is given. Each path reads the wrapper's
counts where it ran (``_count_launches``; a rank worker returns them) and
checks that every launch of it ran in the path's schedule; the kernels
line sums them by schedule. Each fit path also counts the adjoint
kernel's launches and checks one an unsplit iterative adjoint
(``_adjoint_launches``).

The line before the last is a JSON object describing the solver kernel's
instantiations, one entry each for one phase, two phases with the 3xTF32
tail and two with the refinement tail (route, source, the TPU kernel code
it replaces, launches on the main paths by path, error and times), and
the adjoint kernel (phase 5's error, times and bound by shape); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

from tcgan_torch.tools import ssn_solve_ab as ab
from tcgan_torch.tools.ssn_solve_ab import (ATOL, BANDWIDTHS, CHECK_EVERY,
                                            CONTRAST, RTOL, SLICE_D, SLICE_J,
                                            SLICE_S, SLICE_SSN)
from tcgan_torch.tools.ssn_solve_ab import card as _card
from tcgan_torch.tools.ssn_solve_ab import median_ms as _median_ms
from tcgan_torch.tools.ssn_solve_ab import \
    off_own_trajectory as _off_own_trajectory

# The forward slice's benchmark circuit (``ssn_solve_ab``: N=51 sites per
# population, the 8-bandwidth battery at contrast 10), 512 circuits per
# solve.
BATCH = 512
SEED = 0

# The round-2 GAN fit (BASELINE.md "Round-2 GAN fit"): N=51, 8 bandwidths x
# contrasts (5, 10), 256 circuits per batch, fake truth at TRUE_*, the
# generator started +30% off in J and -30% in D.
GAN_SSN = dict(N=51, max_iter=10000, atol=1e-5, check_every=CHECK_EVERY)
GAN_CONTRASTS = (5.0, 10.0)
GAN_BATCH = 256
TRUE_J, TRUE_D, TRUE_S = SLICE_J, SLICE_D, SLICE_S
START_J = tuple(round(1.3 * v, 6) for v in TRUE_J)
START_D = tuple(round(0.7 * v, 6) for v in TRUE_D)
# Phase 5: kernel-forward gradients against plain-forward gradients under
# the same adjoint, max |dg| / max |g|. The forward rates agree to rtol
# 1e-4 and the adjoint stops at an absolute 1e-6; 1e-2 leaves room for
# the adjoint to amplify the forward difference near criticality.
GRAD_RTOL = 1e-2
# Phase 5: the adjoint kernel against the plain loop on the same inputs,
# W_bar and I_bar to 1e-4 of the largest entry (only the mat-vec's
# summation order differs; the card tests' tolerance), at the fit's shape
# and at 2N=600 (W in device memory, ADJ_WIDE_BATCH circuits).
ADJ_RTOL = 1e-4
ADJ_ATOL, ADJ_MAX_ITER = 1e-6, 20000
ADJ_WIDE_BATCH = 16
DEVICE = "cuda"
# Phase 7: the BPTT gradient on the card (fp32) against float64 on the CPU,
# max |dg| / max |g|: 4000 fp32 steps of a contracting map keep ~1e-5.
BPTT_SEQLEN = 4000
BPTT_CHUNK = 100
BPTT_RTOL = 1e-3
# chunked against unchunked on the card: the same ops, recomputed
CHUNK_RTOL = 1e-5
# the profiled BPTT steps run 400 Euler steps: the profiler records every
# op of the unroll, and the pattern per Euler step does not depend on
# seqlen
PROFILE_SEQLEN = 400
MM_BATCH = 64
# Phase 10: the multi-start ensemble (BASELINE.md:511: 8 members of 64
# circuits, start jitter 0.05).
ENS_K = 8
ENS_BATCH = 64
# member m of one float32 ensemble step on the card against the same step
# run alone: the kernel solves each circuit alone in both (bit-equal
# rates); the critic's batched matmuls and the adjoint's may round
# differently. Max |diff| of log-space generator params (an Adam step moves
# them 1e-4), of critic params (5 steps at lr 1e-3) and rel diff of the
# metrics. A fresh state's first Adam step is about lr * sign(g), so the
# params cannot see a wrong gradient of the right signs: the first moments
# mu (the clipped raw gradients) are held too, as max |d mu| / max |mu| per
# leaf. The generator's passes through the member-folded implicit adjoint
# and its per-member stop rule: on the H100 it read 6.4e-7 (critic 3.6e-7),
# and 2.7e-3 with one stop rule over all members, so 1e-5 tells them apart.
MEMBER_TOL = {"gen_params": 1e-6, "critic_params": 1e-4, "metrics": 1e-3,
              "gen_grad": 1e-5, "critic_grad": 1e-5}
# Phase 12: the Jacobian from the kernel forward against the plain forward,
# max |dJ| / max |J|: 3xTF32 rates agree with fp32 to ~1e-5.
JAC_RTOL = 1e-3
# Phase 13: native float64 against the plain lockstep in float64.
NATIVE_RTOL = 1e-6
# Phase 4b: the paper's circuit, N=201, through run.forward (J and D scaled
# by 51 / 201, so the circuit keeps the slice's regime).
WIDE_FWD_N, WIDE_FWD_BATCH, WIDE_FWD_BATCHES = 201, 64, 4
WIDE_FWD_MIN_CONVERGED = 0.9
# Phase 4c: the same circuit with a battery past a cluster of 8 (32 rows,
# Anderson; the reference's run.gan with these contrasts).
SPLIT_FWD_CONTRASTS = (5.0, 10.0, 13.0, 20.0)
# The most rows of one comparison that a witness (``_compare``,
# ``_batch0_against_plain``) may pass outside rtol/atol: 1-3 of 2048 in 4c
# and of 16384 in phase 3's split battery.
WITNESS_MAX_ROWS = 8
# Phase 4d: circuits past a cluster's shared memory at 8 rows (W read from
# device memory), N=300, through run.forward and run.gan (16 circuits a
# batch, a 128-circuit fake truth; the round-2 battery and flags).
GLOBAL_FWD_N = 300
GLOBAL_GAN_BATCH, GLOBAL_GAN_TRUTH = 16, 128
# Phase 3's split batteries to contrast 20 (``_split_witness``): name ->
# (N, circuits, contrasts, accel).
SPLIT_WITNESS = {
    "2N=402 S=32 B=16 anderson, contrasts 5-20": (
        WIDE_FWD_N, 16, SPLIT_FWD_CONTRASTS, True),
    "2N=102 S=256 B=64, contrasts 0.625-20": (
        SLICE_SSN["N"], 64, tuple(0.625 * k for k in range(1, 33)), False),
}


def _line(*parts):
    print(*parts, flush=True)


def _plain(cfg, W, I, check_every, accel=False, stats=None):
    """The kernel's plain version on the card: in two phases with phase 1
    in one emulated TF32 pass (``ssn_solve.drive_1xtf32``), so that it
    computes what the kernel's phase 1 computes."""
    from tcgan_torch.ops.cuda import ssn_solve

    fast = ssn_solve.drive_1xtf32 if cfg.pallas_two_phase else None
    return ssn_solve.solve_fixed_point_plain(cfg, W, I, check_every, accel,
                                             fast_drive=fast, stats=stats)


@contextlib.contextmanager
def _plain_kernel():
    """The kernel's wrapper replaced by its plain version (``_plain``) while
    the block runs: a path run under it computes in plain torch what the
    kernel computes, and launches nothing. Yields the list of the solves'
    inputs, (cfg, W, I, check_every, accel) per call."""
    from tcgan_torch.ops.cuda import ssn_solve

    real, calls = ssn_solve.solve_fixed_point_cuda, []

    def plain(cfg, W, I, check_every=1, accel=False):
        calls.append((cfg, W, I, check_every, accel))
        return _plain(cfg, W, I, check_every, accel)

    ssn_solve.solve_fixed_point_cuda = plain
    try:
        yield calls
    finally:
        ssn_solve.solve_fixed_point_cuda = real


@contextlib.contextmanager
def _adjoint_launches(where: str):
    """The adjoint kernel's count set to 0 while the block runs, and each
    iterative adjoint in it counted: on the ``cuda`` backend one launch an
    unsplit adjoint and at least one a split one (its chunks and replays),
    none elsewhere; raises otherwise. Yields the list of launches per
    adjoint."""
    import inspect

    from tcgan_torch.ops import ift
    from tcgan_torch.ops.cuda import ift_adjoint

    real, per, bad = ift._adjoint, [], []
    sig = inspect.signature(real)

    def counted(*args, **kw):
        a = sig.bind(*args, **kw).arguments
        n0 = ift_adjoint.launches
        out = real(*args, **kw)
        if a["grad_method"] == "iterative":
            n = ift_adjoint.launches - n0
            per.append(n)
            if a["cfg"].backend != "cuda":
                bad.append(n != 0)
            else:
                bad.append(n != 1 if a.get("split") is None else n < 1)
        return out

    ift_adjoint.launches = 0
    ift._adjoint = counted
    try:
        yield per
    finally:
        ift._adjoint = real
    if any(bad) or ift_adjoint.launches != sum(per):
        raise AssertionError(f"{where}: adjoint-kernel launches per adjoint "
                             f"{per}, {ift_adjoint.launches} in all")


def _compare(name, cfg, W, I, check_every, accel=False, witness=False,
             out=None, stats=None):
    """Kernel against plain (``_plain``) on the same inputs: flags equal,
    rates of rows both converged within RTOL/ATOL, iters within two check
    strides (the mat-vec's summation order differs, so the atol crossing
    can land one chunk apart); with ``witness``, a row outside RTOL/ATOL
    passes on the evidence of ``_witness``, at most WITNESS_MAX_ROWS such
    rows. ``out``: a kernel result already computed
    on these inputs (else one launch); ``stats`` goes to the plain version.
    Returns (the kernel's result, max |dr| on rows both converged)."""
    import torch

    from tcgan_torch.ops.cuda import ssn_solve

    if out is None:
        out = ssn_solve.solve_fixed_point_cuda(cfg, W, I, check_every, accel)
    ref = _plain(cfg, W, I, check_every, accel, stats)
    torch.cuda.synchronize()
    if not torch.isfinite(out.r).all():
        raise AssertionError(f"{name}: non-finite kernel rates")
    n_flag = int((out.converged != ref.converged).sum()
                 + (out.diverged != ref.diverged).sum())
    both = (out.converged & ref.converged)[..., None]
    diff = (out.r - ref.r).abs() * both
    bound = ATOL + RTOL * ref.r.abs()
    bad_rows = ((diff > bound) & both).any(-1)
    n_bad = int(((diff > bound) & both).sum())
    if witness and int(bad_rows.sum()) > WITNESS_MAX_ROWS:
        raise AssertionError(f"{name}: {int(bad_rows.sum())} rows outside "
                             f"rtol/atol, past the witness's "
                             f"{WITNESS_MAX_ROWS}")
    if witness:
        for b, s_ in bad_rows.nonzero().tolist():
            ok = _witness(f"[kernel]   {name}", cfg, W, I, b, s_,
                          check_every, accel, out.r[b, s_],
                          int(out.iters[b, s_]), ref.r[b, s_],
                          int(ref.iters[b, s_]))
            if ok:
                n_bad -= int(((diff[b, s_] > bound[b, s_])).sum())
    max_err = float(diff.max()) if diff.numel() else 0.0
    d_iters = int((out.iters.long() - ref.iters.long()).abs().max())
    n_iters_diff = int((out.iters != ref.iters).sum())
    _line(f"[kernel] {name}: B={W.shape[0]} S={I.shape[0]} 2N={W.shape[-1]} "
          f"conv={float(out.converged.float().mean()):.4f} "
          f"div={float(out.diverged.float().mean()):.4f} "
          f"flag_mismatch={n_flag} max_abs_err={max_err:.3e} "
          f"out_of_tol(rtol={RTOL},atol={ATOL})={n_bad} "
          f"max_d_iters={d_iters}(limit {2 * check_every}) "
          f"rows_iters_differ={n_iters_diff} "
          f"mean_iters={float(out.iters.float().mean()):.1f} "
          f"max_iters={int(out.iters.max())}")
    if n_flag:
        raise AssertionError(f"{name}: {n_flag} flags differ from plain")
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} rates outside rtol {RTOL} "
                             f"atol {ATOL}")
    if d_iters > 2 * check_every:
        raise AssertionError(f"{name}: iters differ by {d_iters}")
    return out, max_err


def phase_environment() -> str:
    import torch

    _line(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = _card()
    _line(f"[env] device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    _line(card)
    return card


def phase_build():
    from tcgan_torch.ops.cuda import build

    res = build.build("ssn_solve")
    _line(f"[build] {res.path.name} in {res.seconds:.2f} s")
    _line(res.log.strip())


def _wide_witness(card: str) -> None:
    """The shared-memory path (2N=224, S=8) at the slice's own J and D, not
    scaled to N=112: a third of the rows diverge and some converge so slowly
    that the chunk at which |delta| crosses atol depends on the order of
    the sums, and a row stopped one chunk later has moved on by more than
    rtol 1e-4. The kernel must give the fp32 plain solve's flags and iters
    within two strides, and every row whose rates differ from it beyond
    rtol/atol must agree with the plain fp32 trajectory run to the kernel's
    own iteration count for that row (atol 0): then the kernel computed
    the trajectory right and stopped it one chunk apart. The float64 plain
    solve's difference from the fp32 one on the same rows is printed
    beside."""
    import torch

    from tcgan_torch.ops import fixed_point
    from tcgan_torch.ops.cuda import ssn_solve

    c, W, I = ab.problem(ab.WIDE_BATCH, (CONTRAST,), {}, N=ab.WIDE_N,
                         seed=SEED, rescale=False)
    out = ssn_solve.solve_fixed_point_cuda(c, W, I, CHECK_EVERY)
    p32 = ssn_solve.solve_fixed_point_plain(c, W, I, CHECK_EVERY)
    p64 = fixed_point.solve_fixed_point(c, W.double(), I.double(),
                                        check_every=CHECK_EVERY)
    torch.cuda.synchronize()
    n_flag = int((out.converged != p32.converged).sum()
                 + (out.diverged != p32.diverged).sum())
    n_flag64 = int((p64.converged != p32.converged).sum()
                   + (p64.diverged != p32.diverged).sum())
    d_iters = int((out.iters.long() - p32.iters.long()).abs().max())
    tol = ATOL + RTOL * p32.r.abs()
    both = out.converged & p32.converged
    bad = both & ((out.r - p32.r).abs() > tol).any(-1)
    _line(f"[kernel] wide 2N=224 S=8 unscaled J, D: B={ab.WIDE_BATCH} "
          f"conv={float(out.converged.float().mean()):.4f} "
          f"div={float(out.diverged.float().mean()):.4f} "
          f"flag_mismatch={n_flag} (f64 plain vs fp32 plain: {n_flag64}) "
          f"max_d_iters={d_iters}(limit {2 * CHECK_EVERY}) "
          f"rows_out_of_tol={int(bad.sum())}")
    unexplained = 0
    for b, s_ in bad.nonzero().tolist():
        it = int(out.iters[b, s_])
        d_same, ok = _off_own_trajectory(out, c, W, I, b, s_, CHECK_EVERY,
                                         False)
        unexplained += not ok
        _line(f"[kernel]   row (circuit {b}, stimulus {s_}): iters kernel "
              f"{it} fp32 {int(p32.iters[b, s_])} f64 "
              f"{int(p64.iters[b, s_])} (f64 converged "
              f"{bool(p64.converged[b, s_])}); max |dr| kernel vs fp32 "
              f"{float((out.r[b, s_] - p32.r[b, s_]).abs().max()):.3e}, "
              f"f64 vs fp32 "
              f"{float((p64.r[b, s_].float() - p32.r[b, s_]).abs().max()):.3e}"
              f", kernel vs fp32 run to {it} substeps {d_same:.3e} "
              f"({'within' if ok else 'OUTSIDE'} rtol {RTOL} atol {ATOL}; "
              f"{card})")
    if n_flag:
        raise AssertionError(f"wide unscaled: {n_flag} flags differ")
    if d_iters > 2 * CHECK_EVERY:
        raise AssertionError(f"wide unscaled: iters differ by {d_iters}")
    if unexplained:
        raise AssertionError(f"wide unscaled: {unexplained} rows differ from "
                             f"the fp32 trajectory at their own iters")


def _chunks_alone(lib, name, cfg, W, I, accel, out, plan) -> None:
    """Each chunk of a split launch against its rows launched alone as the
    battery, one chunk of the same rows per chunk (so the same cluster
    size and layout): rates, flags and iters bit-equal."""
    import torch

    from tcgan_torch.ops.cuda import ssn_solve

    R = plan.rows
    for k in range(plan.chunks):
        rows = I[k * R:(k + 1) * R].contiguous()
        alone, _, _ = ssn_solve.launch(lib, cfg, W, rows, CHECK_EVERY,
                                       accel, rows_per_chunk=R)
        torch.cuda.synchronize()
        if not all(torch.equal(x[:, k * R:(k + 1) * R], y)
                   for x, y in zip(out, alone)):
            raise AssertionError(f"{name}: chunk {k} differs from its rows "
                                 f"launched alone")
    _line(f"[kernel] {name}: each of the {plan.chunks} chunks bit-equal to "
          f"its rows launched alone")


def _split_witness(card: str, lib) -> None:
    """Split batteries to contrast 20 (``SPLIT_WITNESS``): phase 4c's at
    2N=402 with Anderson, and 32 contrasts at N=51. There the chunk at
    which a slow row crosses atol, or passes rate_stop_at, moves with the
    rounding (of the sums, and of Anderson's extrapolation), so the plain
    fp32 and float64 solves stop some rows several strides apart. The
    kernel must give each chunk's bits when its rows are launched alone,
    the fp32 plain solve's flags, and rates of rows both converged within
    RTOL/ATOL or on their own fp32 trajectory; its iters gaps against the
    fp32 solve are printed beside the fp32 solve's against float64, and
    its time beside its bound."""
    import torch

    from tcgan_torch.ops import fixed_point
    from tcgan_torch.ops.cuda import ssn_solve

    for name, (N, batch, contrasts, accel) in SPLIT_WITNESS.items():
        cfg, W, I = ab.problem(batch, contrasts, {}, N=N, seed=SEED)
        plan = ssn_solve.plan(W.shape[-1], I.shape[0], accel)
        out = ssn_solve.solve_fixed_point_cuda(cfg, W, I, CHECK_EVERY, accel)
        _chunks_alone(lib, name, cfg, W, I, accel, out, plan)
        p32 = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                                accel)
        p64 = fixed_point.solve_fixed_point(
            dataclasses.replace(cfg, accel="anderson" if accel else "none"),
            W.double(), I.double(), check_every=CHECK_EVERY)
        torch.cuda.synchronize()
        n_flag = int((out.converged != p32.converged).sum()
                     + (out.diverged != p32.diverged).sum())
        both = out.converged & p32.converged
        bad = both & ((out.r - p32.r).abs()
                      > ATOL + RTOL * p32.r.abs()).any(-1)
        unexplained = sum(
            not _off_own_trajectory(out, cfg, W, I, b, s_, CHECK_EVERY,
                                    accel)[1]
            for b, s_ in bad.nonzero().tolist())
        ms = _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
            cfg, W, I, CHECK_EVERY, accel))
        bound_ms, bound_by = ab.bound(W, I, out.iters)
        gap = lambda a, b: (a.iters.long()  # noqa: E731
                            - b.iters.long()).abs()
        k32, f64 = gap(out, p32), gap(p32, p64)
        lim = 2 * CHECK_EVERY
        _line(f"[kernel] witness {name}: plan {tuple(plan)}; "
              f"flag_mismatch={n_flag} (fp32 plain vs float64: "
              f"{int((p32.converged != p64.converged).sum())}); rows both "
              f"converged outside rtol {RTOL} atol {ATOL}: {int(bad.sum())}, "
              f"off their own fp32 trajectory: {unexplained}; iters gap "
              f"kernel vs fp32 max {int(k32.max())}, rows past {lim}: "
              f"{int((k32 > lim).sum())}; fp32 vs float64 max "
              f"{int(f64.max())}, rows past {lim}: {int((f64 > lim).sum())}; "
              f"kernel {ms:.3f} ms (median of 5), bound {bound_ms:.4f} ms "
              f"({bound_by}), share {bound_ms / ms:.4f}, slowest circuit "
              f"{1e3 * ms / int(out.iters.max()):.3f} us per substep over "
              f"{int(out.iters.max())} iters ({card})")
        for b, s_ in (k32 > lim).nonzero().tolist():
            _line(f"[kernel]   row (circuit {b}, stimulus {s_}): iters "
                  f"kernel {int(out.iters[b, s_])} fp32 "
                  f"{int(p32.iters[b, s_])} float64 {int(p64.iters[b, s_])}"
                  f"; converged {bool(out.converged[b, s_])}, diverged "
                  f"{bool(out.diverged[b, s_])}")
        if n_flag or unexplained:
            raise AssertionError(f"witness {name}: {n_flag} flags differ, "
                                 f"{unexplained} rows off their trajectory")


def _forced_split(lib) -> None:
    """The same battery in one chunk and forced into chunks of 8 rows at
    the same cluster size (2N=102, S=32: one block per chunk either way),
    with and without Anderson: rates, flags and iters bit-equal, since the
    rows are independent and each sees the same arithmetic."""
    import torch

    from tcgan_torch.ops.cuda import ssn_solve

    c, W, I = ab.problem(32, (2.5, 5.0, CONTRAST, 13.0), {}, seed=SEED)
    for accel in (False, True):
        whole = ssn_solve.plan(102, 32, accel)
        split = ssn_solve.plan(102, 32, accel, rows=8)
        if whole != (1, 32, 1, False) or split != (1, 8, 4, False):
            raise AssertionError(f"forced split: plans {whole}, {split}")
        a, _, _ = ssn_solve.launch(lib, c, W, I, CHECK_EVERY, accel)
        b, _, _ = ssn_solve.launch(lib, c, W, I, CHECK_EVERY, accel,
                                   rows_per_chunk=8)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        _line(f"[kernel] forced split 2N=102 S=32 B=32"
              f"{' Anderson' if accel else ''}: 4 chunks of 8 against one "
              f"of 32, (r, converged, diverged, iters) bit-equal {same}, "
              f"conv={float(b.converged.float().mean()):.4f}")
        if not all(same):
            raise AssertionError("forced split: differs from one chunk")


def _forced_global(card: str, lib) -> None:
    """The W-global path forced where W's slab fits shared memory, at the
    same cluster size and rows as the shared-W plan (2N=402: S=8 on
    clusters of 4; S=32 with Anderson, 4 chunks of 8 rows): the k-loop
    reads the same values in the same order, so rates, flags and iters are
    bit-equal; the two launches' times beside each other."""
    import torch

    from tcgan_torch.ops.cuda import ssn_solve

    for contrasts, accel in (((CONTRAST,), False),
                             ((2.5, 5.0, 7.5, CONTRAST), True)):
        c, W, I = ab.problem(16, contrasts, {}, N=WIDE_FWD_N, seed=SEED)
        S = I.shape[0]
        shared = ssn_solve.plan(402, S, accel)
        forced = ssn_solve.plan(402, S, accel, w_global=True)
        if shared.w_global or forced != shared._replace(w_global=True):
            raise AssertionError(f"forced W-global: plans {shared}, {forced}")
        a, _, _ = ssn_solve.launch(lib, c, W, I, CHECK_EVERY, accel)
        b, _, _ = ssn_solve.launch(lib, c, W, I, CHECK_EVERY, accel,
                                   w_global=True)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        ms = [_median_ms(lambda wg=wg: ssn_solve.launch(
            lib, c, W, I, CHECK_EVERY, accel, w_global=wg))
            for wg in (False, True, True, False)]
        _line(f"[kernel] forced W-global 2N=402 S={S} B=16"
              f"{' Anderson' if accel else ''} (plan {tuple(shared)[:3]}): "
              f"against W in shared memory, (r, converged, diverged, iters) "
              f"bit-equal {same}, conv={float(b.converged.float().mean()):.4f}"
              f"; shared W {ms[0]:.3f}, {ms[3]:.3f} ms, W from device memory "
              f"{ms[1]:.3f}, {ms[2]:.3f} ms (in turns, each the median of 5; "
              f"{card})")
        if not all(same):
            raise AssertionError("forced W-global: differs from shared W")


def _two_phase_kernel(card: str) -> list[dict]:
    """The two-phase schedule (the CLI's default) at
    ``ab.TWO_PHASE_SHAPES``, every path of the kernel, with the refinement
    tail (the default) and with the 3xTF32 tail (``--pallas-refine off``):
    each against the plain version in the same schedule, computing the
    kernel's arithmetic (the fast pass in emulated TF32; ``_compare``:
    flags equal, rates within RTOL/ATOL, or for a row that stopped at
    another substep on the evidence of ``_witness``; iters within two
    strides), then the kernel in its three schedules in turns (one phase,
    3xTF32 tail, refinement tail, refinement tail, 3xTF32 tail, one phase;
    each the median of 5), each beside its bound (phase 1 in one TF32 pass;
    phase 2 in three, or per chunk a 3-pass anchor and check_every - 1
    one-pass corrections; from the plain version's substeps per phase) and
    phase 1's share of the substeps. Returns the kernels line's entries for
    the two-phase instantiations, 3xTF32 tail then refinement tail (the
    forward shape's times)."""
    from tcgan_torch.ops.cuda import ssn_solve

    rows, first = [], None
    err = {"two": 0.0, "refine": 0.0}
    for name, (N, batch, contrasts, kw, accel) in ab.TWO_PHASE_SHAPES.items():
        c, W, I = ab.problem(batch, contrasts, kw, N=N, seed=SEED,
                             two_phase=True)
        cfgs = {k: dataclasses.replace(c, **v)
                for k, v in ab.SCHEDULES.items()}
        first = first or (cfgs, W, I)
        outs, steps, plans = {}, {}, {}
        for k in ("refine", "two"):
            stats = {}
            outs[k], e = _compare(f"{k} {name}", cfgs[k], W, I, CHECK_EVERY,
                                  accel, witness=True, stats=stats)
            err[k] = max(err[k], e)
            steps[k] = (stats["phase1_substeps"], stats["phase2_substeps"])
            plans[k] = tuple(ssn_solve.plan(W.shape[-1], I.shape[0], accel,
                                            refine=k == "refine"))
        outs["one"] = _solve(cfgs["one"], W, I, accel)
        order = ("one", "two", "refine", "refine", "two", "one")
        turns = [_median_ms(lambda k=k: _solve(cfgs[k], W, I, accel))
                 for k in order]
        row = {"shape": name, "B": batch, "S": I.shape[0], "2N": W.shape[-1],
               "accel": accel, "plan": plans["two"],
               "refine_plan": plans["refine"], "turns_ms": turns}
        for k, out in outs.items():
            ms = statistics.mean(t for kk, t in zip(order, turns) if kk == k)
            bound_ms, bound_by = ab.bound(W, I, out.iters, steps.get(k),
                                          CHECK_EVERY if k == "refine" else 0)
            row[k] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "mean_iters": float(out.iters.float().mean()),
                      "max_iters": int(out.iters.max())}
            if k in steps:
                p1, p2 = steps[k]
                row[k]["phase1_share_of_substeps"] = float(
                    p1.sum() / (p1.sum() + p2.sum()))
        rows.append(row)
        one, two, ref = row["one"], row["two"], row["refine"]
        _line(f"[refine] ssn_solve {name} (2N={W.shape[-1]}, S="
              f"{I.shape[0]}, atol {c.atol}{', Anderson' if accel else ''}; "
              f"plan {plans['two']}, refinement tail {plans['refine']}): "
              f"refinement tail {ref['ms']:.3f} ms, 3xTF32 tail "
              f"{two['ms']:.3f} ms, one phase {one['ms']:.3f} ms (turns "
              f"{', '.join(order)}: {', '.join(f'{t:.3f}' for t in turns)}; "
              f"each the median of 5); 3xTF32 tail / refinement tail "
              f"{two['ms'] / ref['ms']:.3f}, one / refinement tail "
              f"{one['ms'] / ref['ms']:.3f}; bounds {ref['bound_ms']:.4f} / "
              f"{two['bound_ms']:.4f} / {one['bound_ms']:.4f} ms "
              f"({ref['bound_by']}), shares {ref['bound_ms'] / ref['ms']:.4f}"
              f" / {two['bound_ms'] / two['ms']:.4f} / "
              f"{one['bound_ms'] / one['ms']:.4f}; phase 1's share of the "
              f"substeps {ref['phase1_share_of_substeps']:.4f} / "
              f"{two['phase1_share_of_substeps']:.4f}; max iters "
              f"{ref['max_iters']} / {two['max_iters']} / {one['max_iters']}"
              f", mean iters {ref['mean_iters']:.1f} / {two['mean_iters']:.1f}"
              f" / {one['mean_iters']:.1f} ({card})")
    fwd = rows[0]
    cfgs, W, I = first
    entries = []
    for k, label, sched in (
            ("two", "ssn_solve two-phase", "two phases, the 3xTF32 tail "
             "(--pallas-refine off; _solver_kernel :291-343)"),
            ("refine", "ssn_solve refine", "two phases, the refinement tail "
             "(the default; _solver_kernel :252-273, :339-342)")):
        plain_ms = _median_ms(lambda k=k: _plain(cfgs[k], W, I, CHECK_EVERY),
                              reps=3)
        _line(f"[refine] ssn_solve {fwd['shape']}, {sched}: kernel "
              f"{fwd[k]['ms']:.3f} ms, plain (the fast pass in emulated TF32) "
              f"{plain_ms:.3f} ms (median of 3; {card})")
        entries.append({
            "name": label, "route": "cuda",
            "source": "tcgan_torch/csrc/ssn_solve.cu",
            "replaces": ("tcgan_tpu/ops/pallas/ssn_solve.py:291" if k == "two"
                         else "tcgan_tpu/ops/pallas/ssn_solve.py:252"),
            "schedule": sched, "max_abs_err": err[k], "ms": fwd[k]["ms"],
            "plain_ms": plain_ms, "bound_ms": fwd[k]["bound_ms"],
            "bound_by": fwd[k]["bound_by"], "library_ms": None,
            "shapes": [{kk: v for kk, v in r.items() if kk not in (
                "two" if k == "refine" else "refine",)} for r in rows]})
    return entries


def _reopen_margins(card: str, dcfg, W_bad, I_bad) -> None:
    """The reopen margin in two phases, at margins 0 and 2.0 against the
    plain version (``_compare``): hard divergers (``dcfg``'s 8 x 8, every
    row diverges), and the slice's battery (2N=102, S=8, 64 circuits) with
    half its circuits hard divergers (W = 0.5 |N(0, 1)|: every row passes
    rate_stop_at within two chunks). At margin 2.0 a row pinned above 2
    rate_stop_at keeps its phase-1 flag and iters: the same flags, iters no
    larger on the diverged rows. Then the slice's circuit with J four times
    the slice's, near criticality (about a tenth of the rows diverge, some
    never resolve): printed, not gated, how many flags the kernel and the
    plain version disagree on there, in one phase and in two."""
    import torch

    c, W, I = ab.problem(64, (CONTRAST,), {}, seed=SEED, two_phase=True)
    W[32:] = 0.5 * torch.randn(W[32:].shape, device=W.device,
                               generator=torch.Generator(
                                   W.device).manual_seed(SEED)).abs()
    cases = {"hard divergers 2N=8 S=1 B=32": (
        dataclasses.replace(dcfg, pallas_two_phase=True), W_bad, I_bad),
        "half hard divergers 2N=102 S=8 B=64": (c, W, I)}
    for name, (c, W, I) in cases.items():
        outs = []
        for margin in (0.0, 2.0):
            cm = dataclasses.replace(c, pallas_reopen_margin=margin)
            out, _ = _compare(f"two-phase {name}, margin {margin}", cm, W, I,
                              CHECK_EVERY)
            ms = _median_ms(lambda: _solve(cm, W, I))
            outs.append(out)
            div = out.diverged
            div_iters = out.iters[div].float().mean() if div.any() else 0.0
            _line(f"[two-phase] {name} margin {margin}: kernel {ms:.3f} ms "
                  f"(median of 5), diverged {float(div.float().mean()):.4f}, "
                  f"mean iters of the diverged rows {float(div_iters):.1f}, "
                  f"max iters {int(out.iters.max())} ({card})")
        a, b = outs
        if not (torch.equal(a.diverged, b.diverged)
                and torch.equal(a.converged, b.converged)):
            raise AssertionError(f"{name}: the margin changed flags")
        if (b.iters[b.diverged] > a.iters[a.diverged]).any():
            raise AssertionError(f"{name}: margin 2.0 raised a diverged "
                                 "row's iters")
    c, W, I = ab.problem(64, (CONTRAST,), {}, seed=SEED, two_phase=True,
                         j_factor=4.0)
    flips = {}
    for label, cfg in (("one phase", dataclasses.replace(
            c, pallas_two_phase=False)), ("two phases, refinement tail", c)):
        out, ref = _solve(cfg, W, I), _plain(cfg, W, I, CHECK_EVERY)
        flips[label] = (int((out.converged != ref.converged).sum()
                            + (out.diverged != ref.diverged).sum()),
                        float(ref.diverged.float().mean()),
                        int((out.iters - ref.iters).abs().max()))
    _line(f"[two-phase] near criticality, J x4 2N=102 S=8 B=64 (not gated): "
          f"(flags differing kernel vs plain, diverged share, max iters gap) "
          f"{flips} ({card})")


def _solve(cfg, W, I, accel=False):
    from tcgan_torch.ops.cuda import ssn_solve

    return ssn_solve.solve_fixed_point_cuda(cfg, W, I, CHECK_EVERY, accel)


def phase_kernel(card: str) -> dict:
    import torch

    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.ops.ssn import SSNConfig

    # The main paths' shapes and the shared-memory limit (2N=224, S=8, the
    # slice's circuit with J and D scaled to N=112): agreement with the
    # plain version, then the kernel's time against its bound from this
    # run's iters (3 TF32 passes at the tensor cores' peak; the same
    # arithmetic at the fp32 peak beside it), and the slowest circuit's
    # time per substep (launch time / max iters).
    # Then the shapes past one block (thread-block clusters, up to the
    # paper's N=201 and 2N=512; ab.CLUSTER_SHAPES) and the batteries past a
    # cluster of 8 (row chunks; ab.SPLIT_SHAPES), with J and D scaled to N
    # and a near-critical row held to its own fp32 trajectory; then the
    # circuits past a cluster's shared memory (W read from device memory;
    # ab.GLOBAL_SHAPES).
    shapes = [(name, batch, contrasts, kw, SLICE_SSN["N"], False)
              for name, (batch, contrasts, kw) in ab.SHAPES.items()]
    shapes.append(("wide 2N=224 S=8", ab.WIDE_BATCH, (CONTRAST,), {},
                   ab.WIDE_N, False))
    shapes += [(name, batch, contrasts, kw, N, accel) for name, (
        N, batch, contrasts, kw, accel) in {**ab.CLUSTER_SHAPES,
                                            **ab.SPLIT_SHAPES,
                                            **ab.GLOBAL_SHAPES}.items()]
    lib = ssn_solve._library()
    rows, max_err, fwd, wide, wide600 = [], 0.0, None, None, None
    for name, batch, contrasts, kw, N, accel in shapes:
        c, Wk, Ik = ab.problem(batch, contrasts, kw, N=N, seed=SEED)
        n2, S = Wk.shape[-1], Ik.shape[0]
        plan = ssn_solve.plan(n2, S, accel)
        q = ssn_solve.query(n2, S, accel)
        cluster, at_once = q.plan.cluster, q.chunks_at_once
        if q.plan != plan:
            raise AssertionError(f"{name}: the kernel plans {q.plan}, the "
                                 f"wrapper {plan}")
        if ((name in ab.SPLIT_SHAPES) != (plan.chunks > 1)
                or (name in ab.GLOBAL_SHAPES) != plan.w_global):
            raise AssertionError(f"{name}: plan {plan}")
        out, err = _compare(name, c, Wk, Ik, CHECK_EVERY, accel,
                            witness=cluster > 1 or plan.chunks > 1)
        if plan.chunks > 1:
            _chunks_alone(lib, name, c, Wk, Ik, accel, out, plan)
        fwd = fwd or (c, Wk, Ik, out)
        if name == "2N=402 S=8 B=64":
            wide = (c, Wk, Ik)
        if name == "2N=600 S=8 B=64":
            wide600 = (c, Wk, Ik)
        max_err = max(max_err, err)
        ms = _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
            c, Wk, Ik, CHECK_EVERY, accel))
        bound_ms, bound_by = ab.bound(Wk, Ik, out.iters)
        fp32_ms = 1e3 * ab.matvec_flops(Wk, out.iters) / ab.PEAK_FP32_FLOPS
        max_iters = int(out.iters.max())
        rows.append({"shape": name, "B": batch, "S": S, "2N": n2,
                     "atol": c.atol, "accel": accel, "ms": ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / ms,
                     "fp32_bound_ms": fp32_ms,
                     "max_iters": max_iters,
                     "us_per_substep_slowest": 1e3 * ms / max_iters,
                     "cluster": cluster, "rows_per_chunk": plan.rows,
                     "chunks": plan.chunks, "w_global": plan.w_global,
                     "chunks_at_once": at_once,
                     "circuits_at_once": at_once / plan.chunks,
                     "smem_bytes": ssn_solve.smem_bytes(
                         n2, plan.rows, accel, cluster, plan.w_global),
                     "max_abs_err": err})
        _line(f"[time] ssn_solve {name} (2N={n2}, S={S}, atol {c.atol}"
              f"{', Anderson' if accel else ''}): kernel {ms:.3f} ms (median "
              f"of 5), bound {bound_ms:.4f} ms ({bound_by}: 3xTF32 at "
              f"{ab.PEAK_TF32_FLOPS:.3g} FLOP/s; sum iters "
              f"{int(out.iters.sum())}), share {bound_ms / ms:.4f}; at the "
              f"fp32 peak {ab.PEAK_FP32_FLOPS:.3g} FLOP/s {fp32_ms:.4f} ms, "
              f"share {fp32_ms / ms:.4f}; slowest circuit "
              f"{1e3 * ms / max_iters:.3f} us per substep over {max_iters} "
              f"iters; plan: {plan.chunks} chunk(s) of {plan.rows} rows "
              f"per circuit, {cluster} block(s) per chunk, W in "
              f"{'device' if plan.w_global else 'shared'} memory, "
              f"{rows[-1]['smem_bytes']} B of shared memory per block, "
              f"{at_once} chunks ({at_once / plan.chunks:g} circuits) at "
              f"once ({card})")
    _wide_witness(card)
    _forced_split(lib)
    _forced_global(card, lib)
    _split_witness(card, lib)

    # variants on the forward slice (N=51, S=8); soft bounds under the
    # slice's peak rate, so the saturating branches of asym_tanh and
    # asym_linear are exercised
    cfg, W, I, out = fwd
    soft = float(out.r.max()) / 4
    Ws = W[:32].contiguous()
    variants = {
        "asym_tanh": (dict(io_type="asym_tanh", rate_soft_bound=soft,
                           rate_hard_bound=2 * soft), {}),
        "asym_linear": (dict(io_type="asym_linear", rate_soft_bound=soft),
                        {}),
        "expo": (dict(stepper="expo", dt=2 * cfg.tau_I), {}),
        "feedforward": (dict(init="feedforward"), {}),
        "anderson": ({}, dict(accel=True)),
    }
    for name, (cfg_kw, kw) in variants.items():
        out, _ = _compare(name, dataclasses.replace(cfg, **cfg_kw), Ws, I,
                          CHECK_EVERY, **kw)
        if name.startswith("asym_") and not float(out.r.max()) > soft:
            raise AssertionError(f"{name}: saturating branch not reached")
    _compare("ragged37", cfg, W[:37].contiguous(), I, CHECK_EVERY)

    # Hard divergers, shaped like tests/test_pallas_solver.py's runaway
    # case: all must diverge and stay finite under the ceiling.
    dcfg = SSNConfig(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                     rate_stop_at=200.0, atol=1e-6, pallas_two_phase=False)
    gen = torch.Generator("cuda").manual_seed(SEED)
    W_bad = 8.0 * torch.randn((32, 8, 8), generator=gen,
                              device="cuda").abs()
    I_bad = 50.0 * torch.ones((1, 8), device="cuda")
    out, _ = _compare("diverge", dcfg, W_bad, I_bad, CHECK_EVERY)
    if not bool(out.diverged.all()) or float(out.r.max()) > 10 * 200.0:
        raise AssertionError("diverge: not all diverged under the ceiling")
    two_phase = _two_phase_kernel(card)
    _reopen_margins(card, dcfg, W_bad, I_bad)

    fwd_row = rows[0]
    plain_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_plain(
        cfg, W, I, CHECK_EVERY))
    _line(f"[time] ssn_solve B={W.shape[0]} S={I.shape[0]} N={cfg.N}: "
          f"kernel {fwd_row['ms']:.3f} ms, plain {plain_ms:.3f} ms (median "
          f"of 5; {card})")
    wide_row = next(r for r in rows if r["shape"] == "2N=402 S=8 B=64")
    wide_plain_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_plain(
        *wide, CHECK_EVERY), reps=3)
    _line(f"[time] ssn_solve 2N=402 S=8 B=64: kernel {wide_row['ms']:.3f} "
          f"ms, plain {wide_plain_ms:.3f} ms (median of 3; {card})")
    row600 = next(r for r in rows if r["shape"] == "2N=600 S=8 B=64")
    plain600_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_plain(
        *wide600, CHECK_EVERY), reps=3)
    _line(f"[time] ssn_solve 2N=600 S=8 B=64 (W from device memory): kernel "
          f"{row600['ms']:.3f} ms, plain {plain600_ms:.3f} ms (median of 3; "
          f"{card})")
    return [{"name": "ssn_solve", "route": "cuda",
             "source": "tcgan_torch/csrc/ssn_solve.cu",
             "replaces": "tcgan_tpu/ops/pallas/ssn_solve.py:82",
             "schedule": "one phase (--pallas-two-phase off)",
             "max_abs_err": max_err, "ms": fwd_row["ms"],
             "plain_ms": plain_ms, "bound_ms": fwd_row["bound_ms"],
             "bound_by": fwd_row["bound_by"],
             "library_ms": None, "plain_ms_2N402": wide_plain_ms,
             "plain_ms_2N600": plain600_ms,
             "shapes": rows}, *two_phase]


def _forward_argv(datastore, contrasts, total, N=SLICE_SSN["N"],
                  batch=BATCH, backend="cuda", accel=False):
    """``run.forward`` on the slice's circuit at width N, J and D scaled by
    51 / N as ``ab.problem`` scales them; Anderson(1) with ``accel``."""
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    scale = lambda v: [str(SLICE_SSN["N"] / N * x) for x in v]  # noqa: E731
    return [
        "--device", "cuda", "--solver-backend", backend,
        "--datastore", str(datastore), "--seed", str(SEED),
        "--N", str(N), "--k", str(SLICE_SSN["k"]),
        "--n", str(SLICE_SSN["n"]), "--dt", str(SLICE_SSN["dt"]),
        "--max-iter", str(SLICE_SSN["max_iter"]),
        "--atol", str(SLICE_SSN["atol"]),
        "--check-every", str(CHECK_EVERY),
        "--J", *scale(SLICE_J), "--D", *scale(SLICE_D), "--S", *flat(SLICE_S),
        "--bandwidths", *flat(BANDWIDTHS), "--contrasts", *flat(contrasts),
        "--batch-size", str(batch), "--total-samples", str(total),
        "--accel", "anderson" if accel else "none",
    ]


def _witness(head, cfg, W, I, b, s, check_every, accel, r, it, r_ref,
             it_ref) -> bool:
    """Whether row (b, s), whose kernel rates ``r`` (stopped at substep
    ``it``) lie outside RTOL/ATOL of the plain version's ``r_ref`` (at
    ``it_ref``), is still the right trajectory: it stopped at another
    substep, and the plain version run to the kernel's own iters for the
    row (``ab.own_trajectory``; in two phases the circuit's whole battery,
    its tile-mates deciding when phase 1 ends) agrees with it within
    RTOL/ATOL. Prints its evidence."""
    own = ab.own_trajectory(cfg, W, I, b, s, it, check_every, accel)
    d_own = (r - own).abs()
    ok = it != it_ref and bool((d_own <= ATOL + RTOL * own.abs()).all())
    _line(f"{head} row (circuit {b}, stimulus {s}): iters kernel {it} "
          f"plain {it_ref}, max |dr| {float((r - r_ref).abs().max()):.3e}; "
          f"against the plain version run to the kernel's iters "
          f"{float(d_own.max()):.3e} ({'within' if ok else 'OUTSIDE'} rtol "
          f"{RTOL} atol {ATOL})")
    return ok


def _batch0_against_plain(tag, argv, data, witness=False):
    """The first batch of a ``run.forward`` run again, through the kernel's
    plain version (``_plain_kernel``, in the run's schedule) from the same
    seed: the same flags, and the tuning curves of the rows both converged
    within RTOL/ATOL. With ``witness`` (4c: Anderson and contrasts past
    10, where the substep at which a slow row crosses atol is not stable
    under rounding; PERF.md §6), a row outside them passes on
    the evidence of ``_witness`` (its rates from the run's npz), at most
    WITNESS_MAX_ROWS such rows."""
    import numpy as np
    import torch

    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.run import common, forward

    args = forward.make_parser().parse_args(argv)
    cfg = common.generator_config_from_args(args, solver="ift")
    params = gen_lib.init_params(cfg, common.as22(args.J),
                                 common.as22(args.D), common.as22(args.S),
                                 device="cuda")
    gen = torch.Generator("cuda").manual_seed(SEED)
    with torch.no_grad(), _plain_kernel() as calls:
        ref = gen_lib.sample_tuning_curves(cfg, params, args.batch_size,
                                           generator=gen)
    n = args.batch_size
    ref_tc, ref_conv = ref.tc.cpu().numpy(), ref.converged.cpu().numpy()
    if not np.array_equal(data["converged"][:n], ref_conv):
        raise AssertionError(f"{tag}: flags differ from the plain solve")
    ok = data["converged"][:n] & ref_conv
    diff = np.abs(data["tuning_curves"][:n] - ref_tc) * ok
    off = diff > ATOL + RTOL * np.abs(ref_tc)
    _line(f"[{tag}] batch 0 against plain solve: flags equal, max |dtc| "
          f"{diff.max() if diff.size else 0.0:.3e} on {int(ok.sum())} "
          f"converged rows; outside rtol {RTOL} atol {ATOL}: "
          f"{int(off.sum())}")
    if not off.any():
        return
    if not witness or int(off.sum()) > WITNESS_MAX_ROWS:
        raise AssertionError(f"{tag}: {int(off.sum())} tuning curves differ "
                             f"from the plain solve, by up to "
                             f"{diff[off].max():.3e}")
    # the default readout, one tuning-curve column per stimulus row: row
    # (b, s)'s curve is its rates at the probe
    if diff.shape != data["iters"][:n].shape or len(calls) != 1:
        raise AssertionError(f"{tag}: one solve and a tuning curve per "
                             f"stimulus row expected; got {len(calls)} and "
                             f"{diff.shape}")
    c, W, I, check_every, accel = calls[0]
    for b, s in zip(*off.nonzero()):
        b, s = int(b), int(s)
        r = torch.as_tensor(data["rates"][b, s], device=W.device)
        if not _witness(f"[{tag}]   |dtc| {diff[b, s]:.3e},", c, W, I, b, s,
                        check_every, accel, r, int(data["iters"][b, s]),
                        ref.rates[b, s], int(ref.iters[b, s])):
            raise AssertionError(f"{tag}: row ({b}, {s}) differs from the "
                                 "plain solve")


def _count_launches():
    """Set the wrapper's counts to 0; the returned function reads them:
    (launches, of which in two phases, of which in the refinement tail)."""
    from tcgan_torch.ops.cuda import ssn_solve

    ssn_solve.launches = ssn_solve.launches_two_phase = 0
    ssn_solve.launches_refine = 0
    return lambda: (ssn_solve.launches, ssn_solve.launches_two_phase,
                    ssn_solve.launches_refine)


def _default_launches(where, counts) -> int:
    """The launches that a ``_count_launches()`` reader (or its triple)
    counts on a path run in the CLI's default schedule, two phases with the
    refinement tail; raises where one of them ran in another schedule."""
    launches, two, refine = counts() if callable(counts) else counts
    if not launches == two == refine:
        raise AssertionError(f"{where}: of {launches} launches "
                             f"{launches - two} in one phase, {two - refine} "
                             "in two with the 3xTF32 tail")
    return launches


def phase_main_path() -> tuple[int, int, int]:
    """``run.forward`` at the slice's shape in the CLI's default schedule
    (two phases, the refinement tail), 8 batches; then 2 batches with
    ``--pallas-refine off`` (two phases, the 3xTF32 tail) and 2 with
    ``--pallas-two-phase off`` (one phase), their circuits/s beside each
    other. Returns the launches of each."""
    import numpy as np

    from tcgan_torch.run import forward

    total = 8 * BATCH
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "fwd"
        argv = _forward_argv(store, (CONTRAST,), total)
        counts = _count_launches()
        rc = forward.main(argv)
        launches = _default_launches("run.forward", counts)
        if rc != 0:
            raise AssertionError(f"forward.main returned {rc}")
        if launches != total // BATCH:
            raise AssertionError(f"kernel launched {launches} times on the "
                                 f"main path; expected {total // BATCH}")
        info = json.loads((store / "info.json").read_text())
        summary = info["summary"]
        data = np.load(store / "tuning_curves.npz")
        tc = data["tuning_curves"]
        if tc.shape != (total, len(BANDWIDTHS)):
            raise AssertionError(f"tuning_curves shape {tc.shape}")
        if data["rates"].shape != (total, len(BANDWIDTHS), 2 * 51):
            raise AssertionError(f"rates shape {data['rates'].shape}")
        if not np.isfinite(data["rates"]).all():
            raise AssertionError("non-finite rates on the main path")
        if not all(np.isfinite(v) for v in summary.values()
                   if isinstance(v, (int, float))):
            raise AssertionError(f"non-finite summary {summary}")
        if summary["frac_converged"] <= 0.99:
            raise AssertionError(f"frac_converged {summary['frac_converged']}")
        if summary["kernel_launches"] != launches:
            raise AssertionError("summary kernel_launches disagrees")
        _line(f"[main] {json.dumps(summary)}")

        _batch0_against_plain("main", argv, data)

        # the other schedules, 2 batches each: (launches, two phases,
        # refinement tail) as each must count them
        others = {"--pallas-refine": (2, 2, 0), "--pallas-two-phase": (2, 0, 0)}
        off_launches = []
        for flag, want in others.items():
            off = Path(tmp) / flag.strip("-")
            argv = _forward_argv(off, (CONTRAST,), 2 * BATCH) + [flag, "off"]
            counts = _count_launches()
            rc = forward.main(argv)
            got = counts()
            s1 = json.loads((off / "info.json").read_text())["summary"]
            _line(f"[main] {flag} off, 2 batches: launches {got[0]} ({got[1]} "
                  f"in two phases, {got[2]} in the refinement tail), "
                  f"frac_converged {s1['frac_converged']} mean_iters "
                  f"{s1['mean_iters']:.1f} circuits_per_sec "
                  f"{s1['circuits_per_sec']:.1f}; the default (8 batches): "
                  f"mean_iters {summary['mean_iters']:.1f} circuits_per_sec "
                  f"{summary['circuits_per_sec']:.1f}")
            if rc != 0 or got != want:
                raise AssertionError(f"forward {flag} off: rc {rc}, (launches, "
                                     f"two phases, refinement tail) {got}, "
                                     f"not {want}")
            _batch0_against_plain(f"main {flag} off", argv,
                                  np.load(off / "tuning_curves.npz"))
            off_launches.append(got[0])

        store24 = Path(tmp) / "fwd24"
        counts = _count_launches()
        rc = forward.main(_forward_argv(store24, (5.0, 10.0, 13.0), 0))
        launches += _default_launches("run.forward, 24 rows", counts)
        if rc != 0:
            raise AssertionError(f"24-row forward.main returned {rc}")
        s24 = json.loads((store24 / "info.json").read_text())["summary"]
        _line(f"[main] 24-row battery: frac_converged "
              f"{s24['frac_converged']} frac_diverged "
              f"{s24['frac_diverged']} circuits_per_sec "
              f"{s24['circuits_per_sec']:.1f}")
    return (launches, *off_launches)


def _wide_forward(card, tag, store, n_batches, backend="cuda",
                  contrasts=(CONTRAST,), accel=False, N=WIDE_FWD_N,
                  witness=False) -> int:
    """``run.forward --N 201`` (J and D scaled by 51 / N; another N where
    given) for ``n_batches`` batches of WIDE_FWD_BATCH circuits: one launch
    per batch, the rates' shape, finite values, convergence and, on the
    CUDA backend, batch 0 against the plain solve (``witness``: see
    ``_batch0_against_plain``). Returns the launches."""
    import numpy as np

    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.run import forward

    total = n_batches * WIDE_FWD_BATCH
    argv = _forward_argv(store, contrasts, total, N=N,
                         batch=WIDE_FWD_BATCH, backend=backend, accel=accel)
    plan = ssn_solve.plan(2 * N, len(BANDWIDTHS) * len(contrasts), accel)
    counts = _count_launches()
    t0 = time.perf_counter()
    rc = forward.main(argv)
    n, two, refine = counts()
    info = json.loads((store / "info.json").read_text())
    summary = info["summary"]
    data = np.load(store / "tuning_curves.npz")
    _line(f"[{tag}] run.forward --N {N} --contrasts "
          f"{' '.join(f'{c:g}' for c in contrasts)} --accel "
          f"{'anderson' if accel else 'none'} --solver-backend {backend}: "
          f"rc {rc} in {time.perf_counter() - t0:.1f} s; kernel launches {n} "
          f"for {n_batches} batches of {WIDE_FWD_BATCH} (plan: "
          f"{plan.chunks} chunk(s) of {plan.rows} rows on {plan.cluster} "
          f"block(s), W in {'device' if plan.w_global else 'shared'} "
          f"memory); recorded backend {info['config']['solver_backend']}; "
          f"frac_converged {summary['frac_converged']} frac_diverged "
          f"{summary['frac_diverged']} mean_iters "
          f"{summary['mean_iters']:.1f} circuits_per_sec "
          f"{summary['circuits_per_sec']:.1f} ({card})")
    if (rc != 0 or n != n_batches or summary["kernel_launches"] != n
            or not n == two == refine):
        raise AssertionError(f"{tag} forward {backend}: rc {rc}, launches "
                             f"{n}, {two} in two phases, {refine} in the "
                             "refinement tail")
    if info["config"]["solver_backend"] != "cuda":
        raise AssertionError(f"{tag} forward: backend not stored as cuda")
    if data["rates"].shape != (total, len(BANDWIDTHS) * len(contrasts),
                               2 * N) or not np.isfinite(
                                   data["rates"]).all():
        raise AssertionError(f"{tag} forward: rates wrong or non-finite")
    if summary["frac_converged"] <= WIDE_FWD_MIN_CONVERGED:
        raise AssertionError(f"{tag} forward: frac_converged "
                             f"{summary['frac_converged']}")
    if backend == "cuda":
        _batch0_against_plain(tag, argv, data, witness)
    return n


def phase_wide_forward(card: str) -> int:
    """The paper's circuit, N=201 (2N=402: clusters of blocks), through
    ``run.forward``: WIDE_FWD_BATCHES batches on the 8-bandwidth battery at
    contrast 10, then the same command line with the reference's
    ``--solver-backend pallas`` for 2."""
    with tempfile.TemporaryDirectory() as tmp:
        return sum(_wide_forward(card, "wide", Path(tmp) / backend, batches,
                                 backend)
                   for backend, batches in (("cuda", WIDE_FWD_BATCHES),
                                            ("pallas", 2)))


def phase_split_forward(card: str) -> int:
    """N=201 with the 32-row battery (contrasts 5, 10, 13, 20) and
    Anderson through ``run.forward``: past a cluster of 8, so each
    circuit's rows are solved in chunks (4 of 8 rows), still one launch
    per batch; 2 batches."""
    with tempfile.TemporaryDirectory() as tmp:
        return _wide_forward(card, "split", Path(tmp) / "split", 2,
                             contrasts=SPLIT_FWD_CONTRASTS, accel=True,
                             witness=True)


def phase_global_forward(card: str) -> int:
    """N=300 (2N=600: W read from device memory) through ``run.forward``,
    2 batches on the 8-bandwidth battery at contrast 10 and the same
    command line with ``--solver-backend pallas`` for 2, then ``run.gan
    --N 300`` for 2 steps at the round-2 battery, its first solve (the fake
    truth's first batch, 64 circuits) kept and held to the plain solve
    after the run."""
    from tcgan_torch.ops.cuda import ssn_solve

    first = []
    solve = ssn_solve.solve_fixed_point_cuda

    def keep_first(cfg, W, I_ext, check_every=1, accel=False):
        out = solve(cfg, W, I_ext, check_every, accel)
        if not first:
            first.append((cfg, W, I_ext, check_every, accel, out))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        n = sum(_wide_forward(card, "global", Path(tmp) / backend, 2,
                              backend, N=GLOBAL_FWD_N)
                for backend in ("cuda", "pallas"))
        store = Path(tmp) / "gan"
        ssn_solve.solve_fixed_point_cuda = keep_first
        try:
            launches, rows = _run_gan(
                store, 2, 0, "--truth-samples", str(GLOBAL_GAN_TRUTH),
                argv_kw=dict(N=GLOBAL_FWD_N, batch=GLOBAL_GAN_BATCH))
        finally:
            ssn_solve.solve_fixed_point_cuda = solve
        _check_learning(rows, 2, f"gan --N {GLOBAL_FWD_N}")
        cfg, W, I, check_every, accel, out = first[0]
        plan = ssn_solve.plan(W.shape[-1], I.shape[0], accel)
        if not plan.w_global:
            raise AssertionError(f"gan --N {GLOBAL_FWD_N}: plan {plan}")
        _compare(f"gan --N {GLOBAL_FWD_N} first solve (plan "
                 f"{tuple(plan)})", cfg, W, I, check_every, accel,
                 witness=True, out=out)
        _line(f"[global] run.gan --N {GLOBAL_FWD_N} --batch-size "
              f"{GLOBAL_GAN_BATCH}: frac_converged "
              f"{[float(r['frac_converged']) for r in rows]}, train_time "
              f"{[round(float(r['train_time']), 3) for r in rows]} s "
              f"({card})")
    return n + launches


def _gan_problem(batch, ssn_kw, contrasts, seed=SEED, **gen_kw):
    """Log-space (J, D, S) leaves at the fake truth and one z draw."""
    import torch

    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.ops import weights
    from tcgan_torch.ops.ssn import SSNConfig

    dev = torch.device(DEVICE)
    cfg = gen_lib.GeneratorConfig(
        ssn=SSNConfig(**ssn_kw), bandwidths=BANDWIDTHS, contrasts=contrasts,
        **gen_kw)
    as22 = lambda v: ((v[0], v[1]), (v[2], v[3]))  # noqa: E731
    params = gen_lib.init_params(cfg, as22(TRUE_J), as22(TRUE_D),
                                 as22(TRUE_S), device=dev)
    z = weights.sample_z(torch.Generator(dev).manual_seed(seed), (batch,),
                         cfg.ssn.N, device=dev)
    return cfg, params, z


def _adjoint_kernel(card: str, cfg, W, I, res) -> dict:
    """The iterative adjoint at the fixed point ``res`` of (W, I) with a
    random cotangent, through the adjoint kernel and through the plain loop
    (the ``torch`` backend) on the same inputs: W_bar and I_bar within
    ``ADJ_RTOL`` of the largest entry, the iterations equal, one kernel
    launch and none; then the kernel alone, the whole adjoint through it and
    the plain loop, timed. Returns the shape's row of the kernels line."""
    import torch

    from tcgan_torch.ops import ift
    from tcgan_torch.ops.cuda import ift_adjoint
    from tcgan_torch.ops.ssn import recurrent_drive

    B, S, n2 = W.shape[0], I.shape[0], W.shape[-1]
    g = 1e-3 * torch.randn(res.r.shape, device=W.device,
                           generator=torch.Generator(W.device).manual_seed(
                               SEED + 2))
    saved = (W, I, res.r, res.converged)
    bwd = {b: (lambda c=dataclasses.replace(cfg, backend=b): ift._bwd(
        c, "iterative", ADJ_MAX_ITER, ADJ_ATOL, saved, g))
        for b in ("cuda", "torch")}
    out, iters, launched = {}, {}, {}
    for b, fn in bwd.items():
        ift.adjoint_iterations = ift_adjoint.launches = 0
        out[b] = fn()
        torch.cuda.synchronize()
        iters[b], launched[b] = ift.adjoint_iterations, ift_adjoint.launches
    err = max(float((k - p).abs().max() / p.abs().max())
              for k, p in zip(out["cuda"], out["torch"]))
    # the kernel alone, on the operands the adjoint hands it
    ok = res.converged[..., None]
    phi = torch.where(ok, cfg.io_deriv()(recurrent_drive(W, res.r, I)), 0.0)
    alpha = cfg.step_gain(device=W.device)
    kernel = lambda: ift_adjoint.solve(  # noqa: E731
        W, phi, torch.where(ok, g, 0.0), alpha, ADJ_ATOL, ADJ_MAX_ITER)
    n = int(kernel()[2])
    ms = _median_ms(kernel)
    adj_ms, plain_ms = (_median_ms(fn, reps=3) for fn in bwd.values())
    bound_ms = 1e3 * 2 * S * n2 * n2 * B * n / ab.PEAK_FP32_FLOPS
    plan = ift_adjoint.query(B, S, n2, device=W.device)
    shape = (f"2N={n2} S={S} B={B}, W in "
             f"{'shared' if plan.w_shared else 'device'} memory")
    _line(f"[ift] adjoint {shape}: kernel against plain loop W_bar, I_bar "
          f"max |diff| / max |plain| {err:.3e} (tolerance {ADJ_RTOL}), "
          f"iterations {iters['cuda']} / {iters['torch']}, kernel launches "
          f"{launched['cuda']} / {launched['torch']}; the kernel alone "
          f"{ms:.3f} ms for {n} iterations ({1e3 * ms / n:.2f} us an "
          f"iteration; median of 5), bound {bound_ms:.4f} ms (2 S (2N)^2 "
          f"FLOP a circuit an iteration at {ab.PEAK_FP32_FLOPS / 1e12:.0f} "
          f"TFLOP/s fp32), share {bound_ms / ms:.4f}; the whole adjoint "
          f"{adj_ms:.3f} ms through the kernel, {plain_ms:.3f} ms through "
          f"the plain loop (median of 3; {card})")
    if not (err <= ADJ_RTOL and iters["cuda"] == iters["torch"] == n
            and launched == {"cuda": 1, "torch": 0}):
        raise AssertionError(f"ift: the adjoint kernel at {shape} differs "
                             "from the plain loop")
    return {"shape": shape, "iterations": n, "max_rel_err": err, "ms": ms,
            "adjoint_ms": adj_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations (fp32 FFMA)"}


def phase_ift(card: str) -> dict:
    import torch

    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.ops import ift, weights
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.utils import profiling

    cfg, params, z = _gan_problem(GAN_BATCH, GAN_SSN, GAN_CONTRASTS)

    def grads(backend):
        c = dataclasses.replace(
            cfg, ssn=dataclasses.replace(cfg.ssn, backend=backend))
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        out = gen_lib.sample_tuning_curves(c, leaves, GAN_BATCH, z=z)
        ift.adjoint_iterations = 0
        # the stop test's syncs are counted while a profiler runs
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            g = torch.autograd.grad(out.tc.mean(), list(leaves.values()))
            torch.cuda.synchronize()
        return (out, torch.cat([t.reshape(-1) for t in g]),
                (ift.adjoint_iterations, profiling.counters().get(
                    "host_syncs.ift.stop_test", 0)))

    out_k, g_k, (iters_k, syncs_k) = grads("cuda")
    with _plain_kernel():
        out_p, g_p, (iters_p, syncs_p) = grads("cuda")
    if not torch.isfinite(g_k).all():
        raise AssertionError("ift: non-finite gradient through the kernel")
    if not torch.equal(out_k.converged, out_p.converged):
        raise AssertionError("ift: kernel and plain forward flags differ")
    rel = float((g_k - g_p).abs().max() / g_p.abs().max())
    _line(f"[ift] B={GAN_BATCH} S={cfg.n_stim} N={cfg.ssn.N}: "
          f"frac_converged {float(out_k.converged.float().mean()):.4f}, "
          f"d(mean probe rate)/d(log J, D, S) kernel-forward vs "
          f"plain-forward max rel err {rel:.3e} (tolerance {GRAD_RTOL}); "
          f"adjoint iterations {iters_k} / {iters_p}, host syncs "
          f"{syncs_k} / {syncs_p} (stride {ift.DEFAULT_CHECK_STRIDE})")
    _line(f"[ift] grad kernel-forward {g_k.tolist()}")
    if not rel <= GRAD_RTOL:
        raise AssertionError(f"ift: gradient rel err {rel} > {GRAD_RTOL}")

    # the forward kernel's time; then the adjoint kernel against the plain
    # loop at the fit's shape and with W in device memory
    c, dev = cfg.ssn, z.device
    with torch.no_grad():
        W = weights.build_weight(*gen_lib.param_values(cfg, params), z,
                                 c.site_pos(device=dev))
        I = cfg.stimulus_battery(dev)
        res = ssn_solve.solve_fixed_point_cuda(c, W, I, CHECK_EVERY)
    fwd_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
        c, W, I, CHECK_EVERY), reps=3)
    _line(f"[ift] forward kernel {fwd_ms:.3f} ms (median of 3; "
          f"B={GAN_BATCH} S={cfg.n_stim}; {card})")
    wide = ab.problem(ADJ_WIDE_BATCH, GAN_CONTRASTS, N=GLOBAL_FWD_N,
                      ssn_overrides={k: v for k, v in GAN_SSN.items()
                                     if k != "N"}, two_phase=True)
    shapes = [_adjoint_kernel(card, c, W, I, res)]
    with torch.no_grad():
        res = ssn_solve.solve_fixed_point_cuda(*wide, CHECK_EVERY)
    shapes.append(_adjoint_kernel(card, *wide, res))
    fit = shapes[0]
    entry = {"name": "ift_adjoint", "route": "cuda",
             "source": "tcgan_torch/csrc/ift_adjoint.cu",
             "replaces": None, "reference": "tcgan_tpu/ops/ift.py:132 "
             "(_bwd, a lax.while_loop in plain XLA)",
             **{k: fit[k] for k in ("max_rel_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
             "library_ms": None, "shapes": shapes}

    # Waves at the GAN battery, read from the card: the runtime's blocks
    # per SM, then copies of one circuit (every block the same work) at
    # one block per SM, at the predicted one-wave capacity and one past it.
    # A second wave shows as a jump of about one block's time.
    n2, S = W.shape[-1], I.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    refine = ssn_solve.schedule(c).refine
    per_sm = ssn_solve.query(n2, S, refine=refine, device=dev).blocks_per_sm
    cap = per_sm * sms

    def copies_ms(b):
        Wb = W[:1].expand(b, -1, -1).contiguous()
        return _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
            c, Wb, I, CHECK_EVERY), reps=3)

    t_one, t_cap, t_over = copies_ms(sms), copies_ms(cap), copies_ms(cap + 1)
    _line(f"[ift] occupancy at 2N={n2} S={S}: "
          f"{ssn_solve.smem_bytes(n2, S, False, refine=refine)} B of shared "
          f"memory per "
          f"block, {per_sm} blocks per SM (CUDA occupancy API), {sms} SMs: "
          f"{GAN_BATCH} circuits in {math.ceil(GAN_BATCH / cap)} wave(s); "
          f"copies of one circuit {t_one:.3f} ms at {sms}, {t_cap:.3f} ms at "
          f"{cap}, {t_over:.3f} ms at {cap + 1} (median of 3; {card})")
    return entry


def _gan_argv(datastore, n_steps, *extra, N=GAN_SSN["N"], batch=GAN_BATCH):
    """The round-2 ``run.gan`` command line; at another N, J and D (truth
    and start) scaled by 51 / N as ``ab.problem`` scales them."""
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    scaled = lambda v: flat(GAN_SSN["N"] / N * x for x in v)  # noqa: E731
    return [
        "--device", DEVICE, "--solver-backend", "cuda",
        "--datastore", str(datastore), "--seed", str(SEED),
        "--N", str(N), "--bandwidths", *flat(BANDWIDTHS),
        "--contrasts", *flat(GAN_CONTRASTS),
        "--batch-size", str(batch), "--normalize-input",
        "--clip-grad", "1.0",
        "--true-J", *scaled(TRUE_J), "--true-D", *scaled(TRUE_D),
        "--true-S", *flat(TRUE_S),
        "--J", *scaled(START_J), "--D", *scaled(START_D), "--S", *flat(TRUE_S),
        "--n-steps", str(n_steps), *extra,
    ]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _run_entry(entry, argv, store, steps, schedule):
    """An entry point's ``main`` once, with the kernel's count set to 0 just
    before and read just after: the launches after the fake truth must be
    ``schedule(args, steps)`` on the ift solver and none on bptt. Returns
    (launches, learning rows, info.json)."""
    args = entry.make_parser().parse_args(argv)
    counts = _count_launches()
    t0 = time.perf_counter()
    with _adjoint_launches(f"{entry.__name__} {store.name}") as adjoints:
        rc = entry.main(argv)
    launches = _default_launches(entry.__name__, counts)
    if rc != 0:
        raise AssertionError(f"{entry.__name__}.main returned {rc}")
    info = json.loads((store / "info.json").read_text())
    truth = info["kernel_launches_fake_truth"]
    solver = info["config"]["solver"]
    min_truth = math.ceil(args.truth_samples / args.truth_batch)
    expected = schedule(args, steps) if solver == "ift" else 0
    _line(f"[run] {entry.__name__} {store.name} (solver {solver}): "
          f"{len(steps)} steps from {steps[0]} in "
          f"{time.perf_counter() - t0:.1f} s; kernel launches {launches} = "
          f"fake truth {truth} + training {launches - truth} (schedule "
          f"implies {expected}); iterative adjoints {len(adjoints)}, "
          f"adjoint-kernel launches {sum(adjoints)}; status "
          f"{info.get('status')}")
    if launches - truth != expected or truth < min_truth:
        raise AssertionError(f"{entry.__name__}: kernel launches do not "
                             "match the step schedule")
    if info.get("status") != "finished":
        raise AssertionError(f"{entry.__name__}: status "
                             f"{info.get('status')}")
    return launches, _read_csv(store / "learning.csv"), info


def _run_gan(store, n_steps, steps_before, *extra, anchor_updates=0,
             entry=None, argv_kw=None):
    """A WGAN-family entry point (``run.gan`` by default) once: n_critic
    (n_critic0 in the warm-up) + 1 solves per step, + the anchor updates,
    + 1 per ``tc_mean`` snapshot; ``argv_kw`` goes to ``_gan_argv``.
    Returns (launches, learning rows)."""
    from tcgan_torch.run import gan
    from tcgan_torch.train.driver import DriverConfig

    def schedule(args, steps):
        warmup = DriverConfig().n_critic0_steps
        return (sum((args.n_critic0 if s < warmup else args.n_critic) + 1
                    + anchor_updates for s in steps)
                + sum(1 for s in steps if s % args.tc_mean_every == 0))

    launches, rows, _ = _run_entry(
        entry or gan, _gan_argv(store, n_steps, *extra, **(argv_kw or {})),
        store,
        range(steps_before, steps_before + n_steps), schedule)
    return launches, rows


def _check_learning(rows, n_rows, name, min_converged=0.99,
                    losses=("d_loss", "g_loss", "wasserstein", "gp",
                            "rate_penalty")):
    steps = [int(r["step"]) for r in rows]
    if steps != list(range(n_rows)):
        raise AssertionError(f"{name}: learning.csv steps {steps}")
    for r in rows:
        for k in losses:
            if not math.isfinite(float(r[k])):
                raise AssertionError(f"{name}: step {r['step']} {k}={r[k]}")
        if float(r["frac_converged"]) < min_converged:
            raise AssertionError(f"{name}: step {r['step']} frac_converged "
                                 f"{r['frac_converged']}")


def phase_gan(card: str, work: Path) -> int:
    """``run.gan``; its datastore stays in ``work`` for phases 11 and 12."""
    import numpy as np

    launches = 0
    store = work / "gan"
    with tempfile.TemporaryDirectory() as tmp:
        n, rows = _run_gan(store, 6, 0, "--checkpoint-every", "3")
        launches += n
        _check_learning(rows, 6, "gan")
        first = _read_csv(store / "generator.csv")[0]
        start = dict(zip(("J", "D", "S"), (START_J, START_D, TRUE_S)))
        for name, vals in start.items():
            got = [float(first[f"{name}_{a}{b}"]) for a in "EI" for b in "EI"]
            # one Adam step at lr 1e-4 in log space moves a value by
            # about 1e-4 of itself
            if not np.allclose(got, vals, rtol=2e-3):
                raise AssertionError(f"gan: generator.csv row 0 {name} {got} "
                                     f"is not the start point {vals}")
        if not (store / "ckpt" / "6.pt").exists() or \
                not (store / "ckpt" / "3.pt").exists():
            raise AssertionError("gan: checkpoints 3 and 6 missing")
        export = np.load(store / "disc_params.npz")
        if int(export["step"]) != 6 or not all(
                np.isfinite(export[k]).all() for k in export.files):
            raise AssertionError("gan: disc_params.npz wrong or non-finite")
        train_ms = [1e3 * float(r["train_time"]) for r in rows[1:]]
        n, rows = _run_gan(store, 2, 6, "--resume")
        launches += n
        _check_learning(rows, 8, "gan --resume")
        _line(f"[gan] steps 1-5 train_time {statistics.median(train_ms):.1f} "
              f"ms median (B={GAN_BATCH}, 16 conditions, n_critic 5; {card})")
        n, rows = _run_gan(Path(tmp) / "anchor", 2, 0, "--moment-anchor",
                           "1e-3", "--anchor-updates", "2",
                           anchor_updates=2)
        launches += n
        _check_learning(rows, 2, "gan anchor")
        with open(Path(tmp) / "anchor" / "learning.jsonl") as f:
            res = [json.loads(line)["anchor_residual"] for line in f]
        if not all(isinstance(v, float) and math.isfinite(v) for v in res):
            raise AssertionError(f"gan anchor: anchor_residual {res}")
    phase_wgan_step(card)
    return launches


def _step_setup(batch, ssn_kw, contrasts, gen_kw=None, **wgan_kw):
    """A WGAN state at the fake truth on the card, with real data
    1 + 0.1 N(0, 1) as ``bench.py::_wgan_step_ms`` makes it."""
    import torch

    from tcgan_torch.models import wgan

    dev = torch.device(DEVICE)
    cfg, params, _ = _gan_problem(batch, dict(ssn_kw, backend="cuda"),
                                  contrasts, **(gen_kw or {}))
    wcfg = wgan.WGANConfig(gen=cfg, batch_size=batch, n_critic=5,
                           n_critic0=5, **wgan_kw)
    gen = torch.Generator(dev).manual_seed(SEED)
    state = wgan.init_state(wcfg, generator=gen, gen_init=params)
    real = 1.0 + 0.1 * torch.randn(
        (wcfg.n_critic, wcfg.critic_batch, cfg.tc_dim), generator=gen,
        device=dev)
    return wcfg, state, real, gen


def _time_steps(name, card, wcfg, state, real, gen):
    """Marginal time of warm steps, (t9 - t3) / 6 as in
    ``bench.py::_wgan_step_ms`` (median of three), then the device-time
    split of 3 more steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tcgan_torch.models import wgan
    from tcgan_torch.ops import ift
    from tcgan_torch.utils import profiling

    def run(reps):
        nonlocal state
        t0 = time.perf_counter()
        m = None
        for _ in range(reps):
            state, m = wgan.train_step(wcfg, wcfg.n_critic, state, real,
                                       generator=gen)
        _ = float(m.d_loss)
        return time.perf_counter() - t0

    run(1)  # warm-up
    ift.adjoint_iterations = 0
    reps = []
    for _ in range(3):  # the host clock spreads: three measurements
        t3, t9 = run(3), run(9)
        reps.append((t9 - t3) / 6 * 1e3)
    step_ms = statistics.median(reps)
    g = wcfg.gen
    _line(f"[wgan] {name}: {step_ms:.3f} ms per step, median of "
          f"{', '.join(f'{r:.3f}' for r in reps)} (each the marginal of "
          f"warm steps, (t9 - t3) / 6; B={wcfg.batch_size}, S={g.n_stim}, "
          f"N={g.ssn.N}, atol {g.ssn.atol}, n_critic {wcfg.n_critic}; "
          f"{card}); adjoint {ift.adjoint_iterations / 36:.1f} iterations "
          "per step")
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            state, m = wgan.train_step(wcfg, wcfg.n_critic, state, real,
                                       generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    split = _device_split(prof, wcfg.n_critic + 1, n_prof)
    split["idle_vs_step"] = round(step_ms - split["device_busy"], 3)
    split["idle_share_vs_step"] = round(1 - split["device_busy"] / step_ms, 4)
    split["profiled_step_wall"] = round(wall_ms, 3)
    counts = profiling.counters()
    split["host_syncs"] = sum(v for k, v in counts.items()
                              if k.startswith("host_syncs.")) / n_prof
    _line(f"[wgan] {name} device-time split per step (ms; torch.profiler "
          f"over {n_prof} warm steps; {card}): {json.dumps(split)}")
    return step_ms


def phase_wgan_step(card: str):
    # bench.py::_wgan_step_ms: N=51, 8 bandwidths at contrast 10, atol
    # 1e-4, max_iter 8000, 32 circuits, n_critic 5, critic (128, 128)
    step_ms = _time_steps("wgan_step_ms", card, *_step_setup(
        32, dict(SLICE_SSN, check_every=CHECK_EVERY), (CONTRAST,)))
    # the round-2 fit's shapes: 16 conditions, 256 circuits, atol 1e-5; in
    # the default schedule (two phases, reopen margin 0), at the reference's
    # validated margin 2.0, and in one phase
    for name, kw in (("round-2 GAN step", {}),
                     ("round-2 GAN step, --pallas-reopen-margin 2.0",
                      dict(pallas_reopen_margin=2.0)),
                     ("round-2 GAN step, --pallas-two-phase off",
                      dict(pallas_two_phase=False))):
        _time_steps(name, card, *_step_setup(
            GAN_BATCH, dict(GAN_SSN, **kw), GAN_CONTRASTS, clip_grad=1.0))
    return step_ms


def _device_split(prof, solves_per_step, n_steps):
    """Device time per step by phase: the solver kernel's launches split by
    their place in the step (critic-phase solves, then the generator
    forward), other device activity by the phase annotation
    (``wgan.*``, ``ift.adjoint``) whose host time span holds the op that
    launched it (the adjoint's span first: it runs inside the generator's
    backward). One stream, so device activities do not overlap and their
    sum is the device's busy time."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = {}
    for e in events:
        # host spans only: the profiler also mirrors each annotation on
        # the device timeline, where it lags the host
        if e.device_type == DeviceType.CPU and (
                e.name.startswith("wgan.") or e.name == "ift.adjoint"):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))

    def phase_of(t):
        for name in ("ift.adjoint",) + tuple(
                n for n in spans if n != "ift.adjoint"):
            if any(a <= t <= b for a, b in spans.get(name, ())):
                return name
        return "other"

    us = {}
    solver = []
    for e in events:
        for k in e.kernels:
            if "ssn_solve" in k.name:
                solver.append((e.time_range.start, k.duration))
            else:
                key = phase_of(e.time_range.start)
                us[key] = us.get(key, 0.0) + k.duration
    device_solver = sorted((e.time_range.start,
                            e.time_range.end - e.time_range.start)
                           for e in events if e.device_type == DeviceType.CUDA
                           and "ssn_solve" in e.name)
    if len(device_solver) > len(solver):
        solver = device_solver  # launches the host ops did not claim
    solver.sort()
    for i, (_, dur) in enumerate(solver):
        key = ("solve.critic" if i % solves_per_step < solves_per_step - 1
               else "solve.gen_forward")
        us[key] = us.get(key, 0.0) + dur
    busy = sum(us.values())
    out = {k: round(v / n_steps / 1e3, 3) for k, v in sorted(us.items())}
    out["device_busy"] = round(busy / n_steps / 1e3, 3)
    out["solver_launches"] = len(solver)
    out["solver_ms_each"] = [round(d / 1e3, 3) for _, d in solver]
    return out


def _profile_step(name, card, step, solves_per_step, reps=3, warm=False):
    """One warm step's host time unprofiled (median of ``reps``, each
    ending in a synchronize), then the device-time split of one more step
    under ``torch.profiler`` (``_device_split``); the idle share is 1 -
    device busy / unprofiled step time. ``warm``: the caller has just run
    the step, so no warm-up step runs first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        step()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = _device_split(prof, solves_per_step, 1)
    split["step_ms_unprofiled"] = round(step_ms, 3)
    split["step_ms_each"] = [round(t, 3) for t in times]
    split["idle_share"] = round(1 - split["device_busy"] / step_ms, 4)
    split["profiled_step_wall"] = round(wall_ms, 3)
    _line(f"[profile] {name} (ms; torch.profiler over 1 warm step; "
          f"{card}): {json.dumps(split)}")
    return split


def _bptt_grad(cfg, params, z, batch):
    """(output, d(mean probe rate)/d(log J, D, S)) through the Euler
    unroll."""
    import torch

    from tcgan_torch.models import generator as gen_lib

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    out = gen_lib.sample_tuning_curves(cfg, leaves, batch, z=z)
    g = torch.autograd.grad(out.tc.mean(), [leaves[k] for k in sorted(leaves)])
    return out, torch.cat([t.reshape(-1) for t in g])


def phase_bptt(card: str) -> int:
    import torch

    from tcgan_torch.models import wgan
    from tcgan_torch.run import bptt_wgan

    ssn_kw = dict(GAN_SSN, seqlen=BPTT_SEQLEN)
    # the gradient on the card (fp32, unchunked) against float64 on the CPU
    cfg, params, z = _gan_problem(8, ssn_kw, GAN_CONTRASTS, solver="bptt")
    t0 = time.perf_counter()
    out_g, g_g = _bptt_grad(cfg, params, z, 8)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64,
                                bptt_checkpoint_chunk=BPTT_CHUNK)
    t0 = time.perf_counter()
    out_c, g_c = _bptt_grad(
        cfg64, {k: v.detach().double().cpu() for k, v in params.items()},
        z.double().cpu(), 8)
    cpu_s = time.perf_counter() - t0
    g_g = g_g.double().cpu()
    rel = float((g_g - g_c).abs().max() / g_c.abs().max())
    r_rel = float((out_g.rates.detach().double().cpu() - out_c.rates.detach())
                  .abs().max() / out_c.rates.detach().abs().max())
    n_conv = int((out_g.converged.cpu() != out_c.converged).sum())
    n_div = int((out_g.diverged.cpu() != out_c.diverged).sum())
    _line(f"[bptt] B=8 S={cfg.n_stim} N={cfg.ssn.N} seqlen {BPTT_SEQLEN}: "
          f"d(mean probe rate)/d(log J, D, S) card fp32 vs CPU float64 max "
          f"rel err {rel:.3e} (tolerance {BPTT_RTOL}); rates max rel err "
          f"{r_rel:.3e}; frac_converged card "
          f"{float(out_g.converged.float().mean()):.4f} cpu "
          f"{float(out_c.converged.float().mean()):.4f}, flags differing: "
          f"converged {n_conv}, diverged {n_div}; forward + backward "
          f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU ({card})")
    _line(f"[bptt] grad card {g_g.tolist()}")
    if not torch.isfinite(g_g).all() or not rel <= BPTT_RTOL:
        raise AssertionError(f"bptt: gradient rel err {rel} > {BPTT_RTOL}")
    if n_div:
        raise AssertionError(f"bptt: {n_div} diverged flags differ")

    # chunked against unchunked at 32 circuits: gradient and peak memory
    cfg32, params32, z32 = _gan_problem(32, ssn_kw, GAN_CONTRASTS,
                                        solver="bptt")
    runs = {}
    for chunk in (0, BPTT_CHUNK):
        c = dataclasses.replace(cfg32, bptt_checkpoint_chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, g = _bptt_grad(c, params32, z32, 32)
        torch.cuda.synchronize()
        runs[chunk] = (g, torch.cuda.max_memory_allocated() - base,
                       time.perf_counter() - t0)
    (g0, mem0, s0), (g1, mem1, s1) = runs[0], runs[BPTT_CHUNK]
    d_chunk = float((g1 - g0).abs().max() / g0.abs().max())
    _line(f"[bptt] B=32 chunk {BPTT_CHUNK} vs unchunked: max rel grad diff "
          f"{d_chunk:.3e} (tolerance {CHUNK_RTOL}); peak device memory "
          f"above the inputs {mem1 / 2**20:.1f} MiB chunked, "
          f"{mem0 / 2**20:.1f} MiB unchunked; forward + backward "
          f"{s1:.2f} s chunked, {s0:.2f} s unchunked ({card})")
    if not d_chunk <= CHUNK_RTOL or not mem1 < mem0:
        raise AssertionError("bptt: chunked gradient or memory wrong")

    # the C3 entry point at 256 circuits; the kernel solves the fake truth
    # only
    launches = 0
    extra = ("--seqlen", str(BPTT_SEQLEN), "--bptt-checkpoint-chunk",
             str(BPTT_CHUNK), "--WGAN_n_critic0", "5")
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "bptt"
        n, rows = _run_gan(store, 2, 0, *extra, "--checkpoint-every", "2",
                           entry=bptt_wgan)
        launches += n
        _check_learning(rows, 2, "bptt_wgan", min_converged=0.5)
        n, rows = _run_gan(store, 1, 2, *extra, "--resume", entry=bptt_wgan)
        launches += n
        _check_learning(rows, 3, "bptt_wgan --resume", min_converged=0.5)
        if not all((store / "ckpt" / f"{k}.pt").exists() for k in (2, 3)):
            raise AssertionError("bptt_wgan: checkpoints 2 and 3 missing")
        train_ms = [1e3 * float(r["train_time"]) for r in rows[1:]]
        _line(f"[bptt] run.bptt_wgan B={GAN_BATCH} seqlen {BPTT_SEQLEN} "
              f"chunk {BPTT_CHUNK}: train_time steps 1-2 "
              f"{', '.join(f'{t:.1f}' for t in train_ms)} ms, median "
              f"{statistics.median(train_ms):.1f} ms; frac_converged "
              f"{[float(r['frac_converged']) for r in rows]} ({card})")

    # the step's device-time split, at PROFILE_SEQLEN Euler steps
    wcfg, state, real, gen = _step_setup(
        GAN_BATCH, dict(GAN_SSN, seqlen=PROFILE_SEQLEN), GAN_CONTRASTS,
        gen_kw=dict(solver="bptt", bptt_checkpoint_chunk=BPTT_CHUNK),
        clip_grad=1.0)

    def step():
        nonlocal state
        state, _ = wgan.train_step(wcfg, wcfg.n_critic, state, real,
                                   generator=gen)

    _profile_step(f"bptt WGAN step B={GAN_BATCH} S=16 seqlen "
                  f"{PROFILE_SEQLEN} chunk {BPTT_CHUNK} n_critic 5", card,
                  step, wcfg.n_critic + 1)
    return launches


def phase_cwgan(card: str) -> int:
    import torch

    from tcgan_torch.models import cwgan
    from tcgan_torch.run import bptt_cwgan

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "cwgan"
        for n_steps, before, extra in ((4, 0, ()), (2, 4, ("--resume",))):
            n, rows = _run_gan(store, n_steps, before, "--solver", "ift",
                               *extra, entry=bptt_cwgan)
            launches += n
            _check_learning(rows, before + n_steps, "bptt_cwgan --solver ift")
        train_ms = [1e3 * float(r["train_time"]) for r in rows[1:]]
        _line(f"[cwgan] run.bptt_cwgan --solver ift B={GAN_BATCH}: "
              f"train_time steps 1-5 median {statistics.median(train_ms):.1f}"
              f" ms ({card})")
        store = Path(tmp) / "cwgan_bptt"
        n, rows = _run_gan(
            store, 1, 0, "--solver", "bptt", "--batch-size", "32",
            "--WGAN_n_critic0", "5", "--bptt-checkpoint-chunk",
            str(BPTT_CHUNK), entry=bptt_cwgan)
        launches += n
        _check_learning(rows, 1, "bptt_cwgan --solver bptt",
                        min_converged=0.5)
        _line(f"[cwgan] run.bptt_cwgan --solver bptt B=32 seqlen "
              f"{BPTT_SEQLEN}: train_time "
              f"{1e3 * float(rows[0]['train_time']):.1f} ms (warm-up step, "
              f"5 critic updates; {card})")

    # the conditional step's device-time split (round-2 shapes, ift)
    dev = torch.device(DEVICE)
    cfg, params, _ = _gan_problem(GAN_BATCH, dict(GAN_SSN, backend="cuda"),
                                  GAN_CONTRASTS)
    ccfg = cwgan.CWGANConfig(gen=cfg, batch_size=GAN_BATCH, n_critic=5,
                             n_critic0=5, clip_grad=1.0)
    gen = torch.Generator(dev).manual_seed(SEED)
    state = cwgan.init_state(ccfg, generator=gen, gen_init=params)
    raw = 1.0 + 0.1 * torch.randn((ccfg.n_critic * GAN_BATCH, cfg.n_stim,
                                   cfg.n_probe), generator=gen, device=dev)
    real = cwgan.tag_with_conditions(ccfg, raw).reshape(
        ccfg.n_critic, ccfg.critic_batch, -1)

    def step():
        nonlocal state
        state, _ = cwgan.train_step(ccfg, ccfg.n_critic, state, real,
                                    generator=gen)

    _profile_step(f"conditional WGAN step (ift) B={GAN_BATCH} S=16 "
                  "n_critic 5", card, step, ccfg.n_critic + 1)
    return launches


def _mm_argv(datastore, n_steps, *extra):
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    return [
        "--device", DEVICE, "--solver-backend", "cuda",
        "--datastore", str(datastore), "--seed", str(SEED),
        "--N", str(GAN_SSN["N"]), "--bandwidths", *flat(BANDWIDTHS),
        "--contrasts", *flat(GAN_CONTRASTS),
        "--true-J", *flat(TRUE_J), "--true-D", *flat(TRUE_D),
        "--true-S", *flat(TRUE_S),
        "--J", *flat(START_J), "--D", *flat(START_D), "--S", *flat(TRUE_S),
        "--n-steps", str(n_steps), *extra,
    ]


def _run_mm(entry, store, n_steps, steps_before, *extra):
    """A moment-matching entry point once: one solve per step. Returns
    (launches, learning rows)."""
    launches, rows, info = _run_entry(
        entry, _mm_argv(store, n_steps, *extra), store,
        range(steps_before, steps_before + n_steps),
        lambda args, steps: len(steps))
    _check_learning(rows, steps_before + n_steps, entry.__name__,
                    min_converged=(0.99 if info["config"]["solver"] == "ift"
                                   else 0.5),
                    losses=("loss", "mean_err", "cov_err", "rate_penalty"))
    return launches, rows


def phase_moments(card: str) -> int:
    import torch

    from tcgan_torch.models import moments
    from tcgan_torch.run import bptt_moments
    from tcgan_torch.run import moments as run_moments

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "mm"
        extra = ("--moment-ema", "0.99", "--fixed-z")
        n, _ = _run_mm(run_moments, store, 6, 0, *extra)
        launches += n
        z_before = torch.load(store / "ckpt" / "6.pt",
                              weights_only=True)["fixed_z"]
        n, rows = _run_mm(run_moments, store, 2, 6, *extra, "--resume")
        launches += n
        after = torch.load(store / "ckpt" / "8.pt", weights_only=True)
        if after["step"] != 8 or not torch.equal(after["fixed_z"], z_before):
            raise AssertionError("moments: the fixed z-set changed across "
                                 "--resume")
        train_ms = [1e3 * float(r["train_time"]) for r in rows[1:]]
        _line(f"[moments] run.moments B={MM_BATCH} --fixed-z: z-set "
              f"{tuple(z_before.shape)} equal before and after --resume; "
              f"train_time steps 1-7 median {statistics.median(train_ms):.1f}"
              f" ms ({card})")
        n, rows = _run_mm(bptt_moments, Path(tmp) / "bptt_mm", 1, 0)
        launches += n
        _line(f"[moments] run.bptt_moments B={MM_BATCH} seqlen "
              f"{BPTT_SEQLEN}: train_time "
              f"{1e3 * float(rows[0]['train_time']):.1f} ms ({card})")

    # the moment-matching step's device-time split (ift, EMA, fixed z)
    cfg, params, _ = _gan_problem(MM_BATCH, dict(GAN_SSN, backend="cuda"),
                                  GAN_CONTRASTS)
    mcfg = moments.MomentMatchingConfig(gen=cfg, batch_size=MM_BATCH,
                                        moment_ema=0.99, fixed_z=True)
    state = moments.init_state(mcfg, gen_init=params)
    dm = torch.full((cfg.tc_dim,), 5.0, device=DEVICE)
    ds = dm[:, None] * dm[None, :]

    def step():
        nonlocal state
        state, _ = moments.train_step(mcfg, state, dm, ds)

    _profile_step(f"moment-matching step (ift) B={MM_BATCH} S=16", card,
                  step, 1)
    return launches


def _ens_argv(datastore, n_steps, k, *extra):
    return _gan_argv(datastore, n_steps, "--batch-size", str(ENS_BATCH),
                     "--ensemble", str(k), "--record-every", "1", *extra)


def _run_ensemble(argv, store, steps, per_step):
    """``run.ensemble`` once, the kernel's count set to 0 just before and
    read just after: the launches after the fake truth must be
    ``per_step(args, step)`` summed over ``steps``, whatever the member
    count.
    Returns (launches, ensemble.csv rows, args)."""
    from tcgan_torch.run import ensemble

    args = ensemble.make_parser().parse_args(argv)
    counts = _count_launches()
    t0 = time.perf_counter()
    with _adjoint_launches(f"run.ensemble {store.name}") as adjoints:
        rc = ensemble.main(argv)
    launches = _default_launches(f"run.ensemble {store.name}", counts)
    info = json.loads((store / "info.json").read_text())
    truth = info["kernel_launches_fake_truth"]
    expected = sum(per_step(args, s) for s in steps)
    _line(f"[ensemble] {store.name}: K={args.ensemble} B={args.batch_size} "
          f"{len(steps)} steps from {steps[0]} in "
          f"{time.perf_counter() - t0:.1f} s; kernel launches {launches} = "
          f"fake truth {truth} + training {launches - truth} (one fit's "
          f"schedule implies {expected}); iterative adjoints "
          f"{len(adjoints)}, adjoint-kernel launches {sum(adjoints)}; "
          f"status {info.get('status')}")
    if rc != 0 or info.get("status") != "finished":
        raise AssertionError(f"run.ensemble {store.name}: rc {rc}, status "
                             f"{info.get('status')}")
    if launches - truth != expected:
        raise AssertionError(f"run.ensemble {store.name}: launches do not "
                             "match one fit's step schedule")
    return launches, _read_csv(store / "ensemble.csv"), args


def _check_ensemble(rows, args, n_steps, name, losses):
    K = args.ensemble
    want = [(s, m) for s in range(n_steps) for m in range(K)]
    got = [(int(r["step"]), int(r["member"])) for r in rows]
    if got != want:
        raise AssertionError(f"{name}: ensemble.csv (step, member) {got}")
    for r in rows:
        for k in losses:
            if not math.isfinite(float(r[k])):
                raise AssertionError(f"{name}: step {r['step']} member "
                                     f"{r['member']} {k}={r[k]}")
        if float(r["frac_converged"]) < 0.99:
            raise AssertionError(f"{name}: step {r['step']} member "
                                 f"{r['member']} frac_converged "
                                 f"{r['frac_converged']}")
    first = rows[0]  # member 0 after one step: one Adam step off its start
    start = dict(zip(("J", "D", "S"), (args.J, args.D, args.S)))
    for blk, vals in start.items():
        got = [float(first[f"{blk}_{a}{b}"]) for a in "EI" for b in "EI"]
        if not all(math.isclose(g, v, rel_tol=2e-3)
                   for g, v in zip(got, vals)):
            raise AssertionError(f"{name}: member 0 row 0 {blk} {got} is "
                                 f"not the start {vals}")


def _mu_rel(mu, solo_mu, k) -> float:
    """Max over leaves of max |mu[leaf][k] - solo_mu[leaf]| / max
    |solo_mu[leaf]|: member k's first Adam moment against its solo step's."""
    return max(float((mu[n][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
               for n, v in solo_mu.items())


def _ensemble_vs_solo(card: str) -> None:
    """Member m of one ensemble step (K=8, B=64, round-2 battery, float32,
    start jitter 0.05) against ``wgan.train_step_impl`` run alone on
    member m's state, real batches and noise; launches per step; then the
    ensemble step's and one single-member step's host and device time."""
    import torch

    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan
    from tcgan_torch.ops import ift

    dev = torch.device(DEVICE)
    cfg, _, _ = _gan_problem(ENS_BATCH, dict(GAN_SSN, backend="cuda"),
                             GAN_CONTRASTS)
    as22 = lambda v: ((v[0], v[1]), (v[2], v[3]))  # noqa: E731
    gen_init = gen_lib.init_params(cfg, as22(START_J), as22(START_D),
                                   as22(TRUE_S), device=dev)
    wcfg = wgan.WGANConfig(gen=cfg, batch_size=ENS_BATCH, n_critic=5,
                           n_critic0=5, clip_grad=1.0)
    gen = torch.Generator(dev).manual_seed(SEED)
    states = ens_lib.init_ensemble(wcfg, ENS_K, generator=gen,
                                   gen_init=gen_init, start_jitter=0.05)
    for k, v in gen_init.items():
        if not torch.equal(states.gen_params[k][0], v):
            raise AssertionError(f"ensemble: member 0 {k} is not the start")
    n_c, n2 = wcfg.n_critic, 2 * cfg.ssn.N
    real = 1.0 + 0.1 * torch.randn(
        (ENS_K, n_c, wcfg.critic_batch, cfg.tc_dim), generator=gen,
        device=dev)
    zs = lambda: torch.randn((ENS_K, ENS_BATCH, n2, n2),  # noqa: E731
                             generator=gen, device=dev)
    noise = wgan.StepNoise(
        critic_z=[zs() for _ in range(n_c)],
        gp_eps=[torch.rand((ENS_K, wcfg.critic_batch, 1), generator=gen,
                           device=dev) for _ in range(n_c)],
        gen_z=zs())
    counts = _count_launches()
    new, m = ens_lib.ensemble_train_step(wcfg, n_c, states, real,
                                         noise=noise)
    torch.cuda.synchronize()
    ens_launches = _default_launches("ensemble step", counts)
    worst = dict.fromkeys(MEMBER_TOL, 0.0)
    solos = []
    for k in range(ENS_K):
        nk = wgan.StepNoise([z[k] for z in noise.critic_z],
                            [e[k] for e in noise.gp_eps], noise.gen_z[k])
        solo, ms = wgan.train_step_impl(
            wcfg, n_c, ens_lib.member_state(states, k), real[k], noise=nk)
        solos.append(solo)
        for field in ("gen_params", "critic_params"):
            for name, v in getattr(solo, field).items():
                d = float((getattr(new, field)[name][k] - v).abs().max())
                worst[field] = max(worst[field], d)
        for field, opt in (("gen_grad", "gen_opt"),
                           ("critic_grad", "critic_opt")):
            worst[field] = max(worst[field], _mu_rel(
                getattr(new, opt).mu, getattr(solo, opt).mu, k))
        for name in ("d_loss", "g_loss", "wasserstein", "gp",
                     "frac_converged", "mean_iters"):
            a, b = float(getattr(m, name)[k]), float(getattr(ms, name))
            worst["metrics"] = max(worst["metrics"],
                                   abs(a - b) / max(abs(b), 1e-6))
    # what the gradient check can see: the same step with one stop rule
    # over all members' adjoints (the fault the per-member rule repairs)
    solve = ift.solve_fixed_point_implicit
    ift.solve_fixed_point_implicit = (
        lambda *a, group_axes=0, **kw: solve(*a, **kw))  # noqa: E731
    try:
        glob, _ = ens_lib.ensemble_train_step(wcfg, n_c, states, real,
                                              noise=noise)
    finally:
        ift.solve_fixed_point_implicit = solve
    glob_dev = max(_mu_rel(glob.gen_opt.mu, solos[k].gen_opt.mu, k)
                   for k in range(ENS_K))
    _line(f"[ensemble] one step of K={ENS_K} members (B={ENS_BATCH}, "
          f"S={cfg.n_stim}, "
          f"float32) against each member's step run alone: max |d gen "
          f"param| {worst['gen_params']:.3e} (tolerance "
          f"{MEMBER_TOL['gen_params']}), max |d critic param| "
          f"{worst['critic_params']:.3e} ({MEMBER_TOL['critic_params']}), "
          f"max rel d metric {worst['metrics']:.3e} "
          f"({MEMBER_TOL['metrics']}), max |d mu| / max |mu| generator "
          f"{worst['gen_grad']:.3e} ({MEMBER_TOL['gen_grad']}; with one "
          f"stop rule over all members {glob_dev:.3e}), critic "
          f"{worst['critic_grad']:.3e} ({MEMBER_TOL['critic_grad']}); "
          f"kernel launches in the ensemble step "
          f"{ens_launches} (one fit's schedule: {n_c + 1}); "
          f"frac_converged per member {[round(float(v), 4) for v in m.frac_converged]}")
    if ens_launches != n_c + 1:
        raise AssertionError(f"ensemble step launched {ens_launches} times")
    bad = [k for k, v in worst.items() if not v <= MEMBER_TOL[k]]
    if bad:
        raise AssertionError(f"ensemble members differ from solo steps: "
                             f"{bad} {worst}")

    # host time, device busy time and idle share: the ensemble step, one
    # single-member step of the same shape, and K times that
    single = ens_lib.member_state(states, 0)

    def ens_step():
        nonlocal states
        states, _ = ens_lib.ensemble_train_step(wcfg, n_c, states, real,
                                                generator=gen)

    def solo_step():
        nonlocal single
        single, _ = wgan.train_step(wcfg, n_c, single, real[0],
                                    generator=gen)

    ens = _profile_step(f"ensemble WGAN step K={ENS_K} B={ENS_BATCH} S=16 "
                        "n_critic 5", card, ens_step, n_c + 1)
    one = _profile_step(f"single-member WGAN step B={ENS_BATCH} S=16 "
                        "n_critic 5", card, solo_step, n_c + 1)
    _line(f"[ensemble] step host time {ens['step_ms_unprofiled']:.3f} ms for "
          f"{ENS_K} members, device busy {ens['device_busy']:.3f} ms, idle "
          f"{ens['idle_share']:.4f}; one member alone "
          f"{one['step_ms_unprofiled']:.3f} ms (busy "
          f"{one['device_busy']:.3f}, idle {one['idle_share']:.4f}), "
          f"{ENS_K} x that {ENS_K * one['step_ms_unprofiled']:.3f} ms "
          f"({card})")


def phase_ensemble(card: str, work: Path) -> int:
    """``run.ensemble``; the WGAN ensemble's datastore stays in ``work``
    for phase 14."""
    import numpy as np

    launches = 0
    wgan_losses = ("d_loss", "g_loss", "wasserstein", "d_accuracy")
    # one fit's schedule: n_critic0 critic solves at step 0, n_critic after,
    # and the generator's forward
    gan_step = lambda a, s: (a.n_critic0 if s == 0  # noqa: E731
                             else a.n_critic) + 1
    flags = ("--start-jitter", "0.05", "--WGAN_n_critic0", "5")

    with tempfile.TemporaryDirectory() as tmp:
        store = work / "ens"
        n, rows, args = _run_ensemble(
            _ens_argv(store, 3, ENS_K, *flags, "--checkpoint-every", "3"),
            store, range(3), gan_step)
        launches += n
        _check_ensemble(rows, args, 3, "ensemble wgan", wgan_losses)
        n, rows, _ = _run_ensemble(
            _ens_argv(store, 1, ENS_K, *flags, "--resume"), store,
            range(3, 4), gan_step)
        launches += n
        _check_ensemble(rows, args, 4, "ensemble wgan --resume",
                        wgan_losses)
        npz = np.load(store / "ensemble_params.npz")
        for k in ("J", "D", "S"):
            if npz[k].shape != (ENS_K, 2, 2) or not np.isfinite(
                    npz[k]).all():
                raise AssertionError(f"ensemble_params.npz {k} "
                                     f"{npz[k].shape}")
        summary = json.loads((store / "ensemble_summary.json").read_text())
        train_ms = [1e3 * float(r["train_time"]) for r in rows
                    if r["member"] == "0"][1:]
        _line(f"[ensemble] wgan K={ENS_K} B={ENS_BATCH}: train_time steps "
              f"1-3 {', '.join(f'{t:.1f}' for t in train_ms)} ms; "
              f"across-member std J {summary['std']['J']} ({card})")

        store = Path(tmp) / "cens"
        n, rows, args = _run_ensemble(
            _ens_argv(store, 2, 4, "--estimator", "cwgan", *flags), store,
            range(2), gan_step)
        launches += n
        _check_ensemble(rows, args, 2, "ensemble cwgan", wgan_losses)

        store = Path(tmp) / "ensmm"
        argv = _mm_argv(store, 3) + [
            "--estimator", "mm", "--ensemble", str(ENS_K), "--batch-size",
            str(ENS_BATCH), "--fixed-z", "--moment-ema", "0.99",
            "--data-seed-per-member", "--start-jitter", "0.05",
            "--record-every", "1"]
        n, rows, args = _run_ensemble(argv, store, range(3),
                                      lambda a, s: 1)
        launches += n
        _check_ensemble(rows, args, 3, "ensemble mm",
                        ("loss", "mean_err", "cov_err", "rate_penalty"))
    _ensemble_vs_solo(card)
    return launches


def phase_eval(card: str, gan_store: Path) -> int:
    """``run.eval`` on phase 6's ``run.gan`` datastore: one forward solve
    of 256 circuits after the fake truth; then ``--params-source npz``."""
    from tcgan_torch.run import eval as run_eval

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for source in ("csv", "npz"):
            out = Path(tmp) / source
            argv = ["--run", str(gan_store), "--datastore", str(out),
                    "--eval-samples", "256", "--params-source", source,
                    "--device", DEVICE, "--solver-backend", "cuda"]
            counts = _count_launches()
            t0 = time.perf_counter()
            rc = run_eval.main(argv)
            n = _default_launches(f"eval {source}", counts)
            info = json.loads((out / "info.json").read_text())
            res, truth = info["result"], info["kernel_launches_fake_truth"]
            _line(f"[eval] --params-source {source}: rc {rc} in "
                  f"{time.perf_counter() - t0:.1f} s; launches {n} = fake "
                  f"truth {truth} + {n - truth}; n_gen {res['n_gen']} tc_w1 "
                  f"{res['tc_w1']:.6g} sliced_w1 {res['sliced_w1']:.6g} "
                  f"recovery {res.get('param_recovery_error')} plots "
                  f"{res.get('plots', 'written')} ({card})")
            if rc != 0 or n != 1 + truth or not res["n_gen"] > 0:
                raise AssertionError(f"eval {source}: rc {rc}, launches {n}")
            if not (math.isfinite(res["tc_w1"])
                    and math.isfinite(res["sliced_w1"])
                    and "param_recovery_error" in res
                    and len(res["per_condition_w1"])
                    == len(BANDWIDTHS) * len(GAN_CONTRASTS)):
                raise AssertionError(f"eval {source}: result {res}")
            launches += n
    return launches


def phase_analyses(card: str, gan_store: Path) -> int:
    """``analysis.identifiability`` with the kernel forward and the plain
    forward (Jacobians held to each other), then
    ``analysis.uncertainty`` on phase 6's run."""
    import numpy as np

    from tcgan_torch.analysis import identifiability, uncertainty

    flat = lambda v: [str(x) for x in v]  # noqa: E731
    launches = 0
    reports, jacs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("cuda", "torch"):
            out, jac = Path(tmp) / f"{backend}.json", Path(tmp) / backend
            argv = ["--device", DEVICE, "--solver-backend", backend,
                    "--N", str(GAN_SSN["N"]), "--bandwidths",
                    *flat(BANDWIDTHS), "--J", *flat(TRUE_J), "--D",
                    *flat(TRUE_D), "--S", *flat(TRUE_S), "--max-iter",
                    str(GAN_SSN["max_iter"]), "--atol", str(GAN_SSN["atol"]),
                    "--check-every", str(CHECK_EVERY), "--n-circuits", "256",
                    "--data-samples", "4096", "--contrast-sets",
                    "5,10;5,10,13", "--output", str(out),
                    "--save-jacobian", str(jac) + ".npz"]
            counts = _count_launches()
            t0 = time.perf_counter()
            rc = identifiability.main(argv)
            seconds = time.perf_counter() - t0
            n = _default_launches(f"identifiability {backend}", counts)
            rep = json.loads(out.read_text())
            reports[backend] = rep
            jacs[backend] = np.load(str(jac) + ".npz")["jacobian"]
            # per battery: the Jacobian's forward and the convergence draw;
            # the first battery's precision report draws once more
            want = 5 if backend == "cuda" else 0
            _line(f"[identifiability] --solver-backend {backend}: rc {rc} "
                  f"in {seconds:.2f} s; launches {n} (expected {want}); "
                  + "; ".join(
                      f"contrasts {b['contrasts']}: sigma_min "
                      f"{b['sigma_min']:.4e} cond "
                      f"{b['condition_number']:.4g} yield "
                      f"{b['circuit_yield']:.4f}"
                      for b in rep["batteries"]) + f" ({card})")
            if rc != 0 or n != want:
                raise AssertionError(f"identifiability {backend}: rc {rc}, "
                                     f"launches {n}")
            for b in rep["batteries"]:
                if not all(math.isfinite(b[k]) for k in
                           ("sigma_min", "condition_number",
                            "circuit_yield")):
                    raise AssertionError(f"identifiability {backend}: {b}")
            launches += n
        jk, jp = jacs["cuda"], jacs["torch"]
        rel = float(np.abs(jk - jp).max() / np.abs(jp).max())
        _line(f"[identifiability] Jacobian {jk.shape} kernel forward vs "
              f"plain forward: max |dJ| / max |J| {rel:.3e} (tolerance "
              f"{JAC_RTOL}); sigma_min {reports['cuda']['batteries'][0]['sigma_min']:.6e} "
              f"/ {reports['torch']['batteries'][0]['sigma_min']:.6e}")
        if not rel <= JAC_RTOL:
            raise AssertionError(f"identifiability: Jacobians differ by "
                                 f"{rel}")

        out = Path(tmp) / "uncertainty.json"
        counts = _count_launches()
        t0 = time.perf_counter()
        rc = uncertainty.main(["--run", str(gan_store), "--device", DEVICE,
                               "--solver-backend", "cuda", "-o", str(out)])
        n = _default_launches("uncertainty", counts)
        rep = json.loads(out.read_text())
        cal = rep.get("calibration", {})
        _line(f"[uncertainty] rc {rc} in {time.perf_counter() - t0:.2f} s; "
              f"launches {n}; n_data {rep['n_data']}, surviving circuits "
              f"{rep['n_surviving_circuits']}, constrained directions "
              f"{rep['expected_precision']['n_constrained_directions']}, "
              f"max |z| {cal.get('max_abs_z_constrained')}: "
              f"{cal.get('verdict')} ({card})")
        if rc != 0 or n != 2 or "expected_precision" not in rep:
            raise AssertionError(f"uncertainty: rc {rc}, launches {n}")
        launches += n
    return launches


def phase_native(card: str) -> None:
    """The native CPU baseline at the bench circuit (N=51, S=8, 32
    circuits) in float64 against the plain lockstep solve in float64 on the
    CPU; its circuits/s beside the kernel's on the same circuits."""
    import numpy as np

    from tcgan_torch.ops import fixed_point, native
    from tcgan_torch.ops.cuda import ssn_solve

    c, W, I = ab.problem(32, (CONTRAST,), {}, N=SLICE_SSN["N"], seed=SEED)
    W64, I64 = W.double().cpu(), I.double().cpu()
    t0 = time.perf_counter()
    built = native.build()
    build_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = native.solve_fixed_point_native(c, W64, I64)
        times.append(time.perf_counter() - t0)
    ref = fixed_point.solve_fixed_point(c, W64, I64, check_every=1)
    ok = res.converged & ref.converged.numpy()
    rel = float((np.abs(res.r - ref.r.numpy()) / np.maximum(
        np.abs(ref.r.numpy()), 1e-12))[ok].max())
    flags = bool(np.array_equal(res.converged, ref.converged.numpy())
                 and np.array_equal(res.diverged, ref.diverged.numpy()))
    kernel_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
        c, W, I, CHECK_EVERY))
    native_s = statistics.median(times)
    _line(f"[native] {built.path.name} built by {built.compiler} (OpenMP) "
          f"in {build_s:.2f} s; B=32 S=8 N=51 "
          f"float64: {native_s * 1e3:.3f} ms (median of 3: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), "
          f"{32 / native_s:.1f} circuits/s on {native.num_threads()} "
          f"threads of {native.cpu_model()}; flags equal to the plain "
          f"float64 lockstep {flags}, max rel dr {rel:.3e} (tolerance "
          f"{NATIVE_RTOL}), frac_converged {float(res.converged.mean())}; "
          f"kernel {kernel_ms:.3f} ms, {32e3 / kernel_ms:.1f} circuits/s "
          f"({card})")
    if not flags or not rel <= NATIVE_RTOL:
        raise AssertionError(f"native: flags {flags}, rel {rel}")


def _cli_json(main, argv):
    """(exit code, the last line ``main`` printed, as JSON where it is)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    last = (buf.getvalue().strip().splitlines() or [""])[-1]
    try:
        return rc, json.loads(last)
    except json.JSONDecodeError:
        return rc, last


def phase_reports(card: str, gan_store: Path, ens_store: Path) -> None:
    """The post-fit analysis CLIs on this machine (no jax; no matplotlib,
    so every figure must say it was skipped): ``report`` on phase 6's run
    and phase 10's ensemble, ``fit_quality``, ``learning_curves`` and
    ``compare`` (the run against itself) on phase 6's run,
    ``recovery_gate`` on its exit codes, ``ensemble_view`` on phase 10's
    ensemble."""
    from tcgan_torch.analysis import (compare, ensemble_view, fit_quality,
                                      learning_curves, recovery_gate, report)
    from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib

    gan, ens = str(gan_store), str(ens_store)
    with tempfile.TemporaryDirectory() as tmp:
        out = lambda name: str(Path(tmp) / name)  # noqa: E731
        runs = {
            "report run": (report.main, [gan, "-o", out("run.md")], 0),
            "report ensemble": (report.main, [ens, "-o", out("ens.md")], 0),
            "fit_quality": (fit_quality.main, [gan, "-o", out("fq.png")], 0),
            "learning_curves": (learning_curves.main,
                                [gan, "-o", out("lc.png")], 0),
            "compare": (compare.main, [gan, gan, "--labels", "a", "b", "-o",
                                       out("cmp.png")], 0),
            # 8 steps: the gate cannot clear before --min-step 15000 (1),
            # and clears at a gate no fit misses (0)
            "recovery_gate": (recovery_gate.main, [gan], 1),
            "recovery_gate --gate 100": (recovery_gate.main, [
                gan, "--min-step", "0", "--window", "1", "--gate", "100"], 0),
            "ensemble_view": (ensemble_view.main,
                              [ens, "-o", out("ens.png")], 0),
        }
        for name, (main, argv, want) in runs.items():
            t0 = time.perf_counter()
            rc, res = _cli_json(main, argv)
            plot = res.get("plot") if isinstance(res, dict) else None
            _line(f"[reports] {name}: rc {rc} (expected {want}) in "
                  f"{time.perf_counter() - t0:.2f} s; "
                  f"{json.dumps(res)[:300]}")
            if rc != want:
                raise AssertionError(f"{name}: exit code {rc}")
            if plot is not None and plot != PLOTS_SKIPPED and \
                    not have_matplotlib():
                raise AssertionError(f"{name}: plot {plot}")
        text = Path(out("run.md")).read_text()
        if "## Parameter recovery" not in text or "| J_EE |" not in text:
            raise AssertionError("report: no recovery table")
        if "Members recovered" not in Path(out("ens.md")).read_text():
            raise AssertionError("report: no ensemble member table")
    _line(f"[reports] matplotlib installed: {have_matplotlib()} ({card})")


# Phase 15: a sharded run or step against the unsharded one of the same
# seed, to the reference's rtol 1e-4 (tests/test_parallel.py:57-65). The
# adjoint's stop test spans every rank's circuits, so the sharded gradient
# is the unsharded one up to float32 roundoff: the sharded step's generator
# parameters and first Adam moments are held to MESH_GRAD_RTOL, which a
# per-rank stop test misses (9.640e-05 on the moments, against 1.161e-07
# with the batch's stop test, on an H100). The forward path's kernel solves
# each circuit alone, so its npz is bit-equal.
MESH_RTOL = 1e-4
MESH_GRAD_RTOL = 1e-6
MESH_STEPS = 3
CLOCK_COLUMNS = {"train_time", "SSsolve_time", "gradient_time"}
# Phase 15(d): a model axis of 2 (a 1 x 2 mesh). The kernel and
# direct-adjoint steps are held to MESH_RTOL / MESH_GRAD_RTOL: the kernel
# solves each circuit alone and the model group splits the circuits, so
# the forward is bit-equal and only the gradient's sum over the ranks
# rounds differently; the direct adjoint gathers W's columns and solves
# the same dense systems. The BPTT step
# (depth cut from 4000 Euler steps to 200, chunk 100, for the smoke's
# time) sums each step's drive as two 51-term partial sums: in float32
# that moves a drive by about sqrt(102) * 2^-24 ~ 6e-7 of its absolute
# terms, up to ~1e-5 of the drive where E and I inputs cancel, and 200
# contracting steps carry that into the rates and gradients at 1e-6 to
# 1e-5; the gate on its losses, parameters and first Adam moments is 10x
# the top of that, 1e-4 (a dropped or doubled cotangent term is O(1)).
MODEL_BPTT_SEQLEN, MODEL_BPTT_CHUNK = 200, 100
MODEL_BPTT_RTOL = 1e-4
MODEL_WIDE_BATCH = 64


def _rel(a, b) -> float:
    """max |a - b| / max |b| over tensors (or dicts of them)."""
    import torch

    if isinstance(b, dict):
        return max(_rel(a[k], v) for k, v in b.items())
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _rows_rel(mesh_rows, plain_rows) -> float:
    """The largest relative difference of two runs' learning rows, the
    columns of a rank's clock aside."""
    if [r["step"] for r in mesh_rows] != [r["step"] for r in plain_rows]:
        raise AssertionError("mesh: the runs' steps differ")
    worst = 0.0
    for a, b in zip(mesh_rows, plain_rows):
        for k in a.keys() - CLOCK_COLUMNS:
            x, y = float(a[k]), float(b[k])
            if x != y:
                worst = max(worst, abs(x - y) / max(abs(y), 1e-12))
    return worst


def _mesh_cli(card: str, work: Path) -> dict:
    """Phase 15(a): each entry point with and without ``--parallel mesh``
    (one NCCL rank per card; on one card, the rank is this process)."""
    import numpy as np
    import torch

    from tcgan_torch.run import forward, moments

    world = torch.cuda.device_count()
    if world != 1:
        raise AssertionError(f"phase 15(a) counts the launches of one rank "
                             f"in this process; {world} cards are visible "
                             "(set CUDA_VISIBLE_DEVICES to one)")
    mesh = ("--parallel", "mesh")
    by_path = {}
    t0 = time.perf_counter()
    n_plain, plain = _run_gan(work / "gan_plain", MESH_STEPS, 0)
    t1 = time.perf_counter()
    n_mesh, rows = _run_gan(work / "gan_mesh", MESH_STEPS, 0, *mesh)
    t2 = time.perf_counter()
    rel = _rows_rel(rows, plain)
    _line(f"[mesh] run.gan --parallel mesh, round-2, {MESH_STEPS} steps on "
          f"{world} NCCL rank(s): launches {n_mesh} (unsharded {n_plain}), "
          f"max rel d learning row {rel:.3e} (rtol {MESH_RTOL}), "
          f"{t2 - t1:.1f} s (unsharded {t1 - t0:.1f} s; {card})")
    if n_mesh != n_plain or not rel <= MESH_RTOL:
        raise AssertionError("mesh: run.gan differs from the unsharded run")
    by_path["run.gan --parallel mesh"] = n_mesh

    extra = ("--batch-size", str(MM_BATCH), "--fixed-z")
    t0 = time.perf_counter()
    n_plain, plain = _run_mm(moments, work / "mm_plain", MESH_STEPS, 0,
                             *extra)
    t1 = time.perf_counter()
    n_mesh, rows = _run_mm(moments, work / "mm_mesh", MESH_STEPS, 0, *extra,
                           *mesh)
    t2 = time.perf_counter()
    rel = _rows_rel(rows, plain)
    _line(f"[mesh] run.moments --parallel mesh --fixed-z, B={MM_BATCH}, "
          f"{MESH_STEPS} steps: launches {n_mesh} (unsharded {n_plain}), "
          f"max rel d learning row {rel:.3e} (rtol {MESH_RTOL}), "
          f"{t2 - t1:.1f} s (unsharded {t1 - t0:.1f} s; {card})")
    if n_mesh != n_plain or not rel <= MESH_RTOL:
        raise AssertionError("mesh: run.moments differs from the unsharded "
                             "run")
    by_path["run.moments --parallel mesh"] = n_mesh

    data, launches, summary = {}, {}, {}
    for name, more in (("plain", ()), ("mesh", mesh)):
        store = work / f"fwd_{name}"
        counts = _count_launches()
        if forward.main(_forward_argv(store, (CONTRAST,), 2 * BATCH)
                        + list(more)) != 0:
            raise AssertionError(f"mesh: run.forward ({name}) failed")
        launches[name] = _default_launches(f"mesh: run.forward ({name})",
                                             counts)
        data[name] = np.load(store / "tuning_curves.npz")
        summary[name] = json.loads((store / "info.json").read_text())[
            "summary"]
    equal = all(np.array_equal(data["mesh"][k], data["plain"][k])
                for k in data["plain"].files)
    _line(f"[mesh] run.forward --parallel mesh, 2 batches of {BATCH}: "
          f"launches {launches['mesh']} (unsharded {launches['plain']}), "
          f"npz bit-equal {equal}, n_devices "
          f"{summary['mesh']['n_devices']}, circuits/s "
          f"{summary['mesh']['circuits_per_sec']:.1f} (unsharded "
          f"{summary['plain']['circuits_per_sec']:.1f}; {card})")
    if not equal or launches["mesh"] != launches["plain"] or \
            summary["mesh"]["n_devices"] != world:
        raise AssertionError("mesh: run.forward differs from the unsharded "
                             "run")
    by_path["run.forward --parallel mesh"] = launches["mesh"]
    return by_path


def _mesh_rank(card: str) -> dict:
    """Phase 15(b), one of two gloo ranks sharing the card: the sharded
    round-2 WGAN step and the 8 x 64 ensemble step split 4 + 4, each with
    the kernel's launches and circuits per launch in this rank; rank 0
    also runs the unsharded steps on the same noise and returns the
    differences."""
    import torch
    import torch.distributed as dist

    from tcgan_torch import parallel as par
    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.models import wgan
    from tcgan_torch.ops.cuda import ssn_solve

    rank = dist.get_rank()
    mesh = par.make_mesh()
    circuits = []
    solve = ssn_solve.solve_fixed_point_cuda

    def counted(cfg, W, *args, **kw):
        circuits.append(int(W.shape[0]))
        return solve(cfg, W, *args, **kw)

    ssn_solve.solve_fixed_point_cuda = counted

    def run(fn):
        """fn() once with the counts at 0: (result, (launches, of which in
        two phases), circuits per launch, collectives)."""
        counts = _count_launches()
        circuits.clear()
        mesh.counts.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, counts(), list(circuits), dict(mesh.counts)

    wcfg, state, real, gen = _step_setup(GAN_BATCH, GAN_SSN, GAN_CONTRASTS,
                                         clip_grad=1.0)
    n_c = wcfg.n_critic
    noise = wgan.draw_step_noise(wcfg, n_c, real, gen)
    scfg = dataclasses.replace(wcfg, gen=par.with_mesh_axes(wcfg.gen))
    step = par.make_sharded_gan_step(wgan.train_step_impl, mesh)
    (new, m), (launches, two, refine), per, counts = run(
        lambda: step(scfg, n_c, state, real, noise=noise))
    out = {"rank": rank, "gan": dict(launches=launches, two_phase=two,
                                     refine=refine,
                                     circuits=per, collectives=counts)}
    if rank == 0:
        ref, rm = wgan.train_step_impl(wcfg, n_c, state, real, noise=noise)
        out["gan"]["rel"] = {
            "d_loss": _rel(m.d_loss, rm.d_loss),
            "g_loss": _rel(m.g_loss, rm.g_loss),
            "gen_params": _rel(new.gen_params, ref.gen_params),
            "gen_mu": _rel(new.gen_opt.mu, ref.gen_opt.mu)}
    prof = _profile_step(f"sharded round-2 WGAN step, rank {rank} of 2 "
                         "sharing the card over gloo", card,
                         lambda: step(scfg, n_c, state, real, noise=noise),
                         n_c + 1)
    out["gan"].update(step_ms=prof["step_ms_unprofiled"],
                      device_busy=prof["device_busy"],
                      idle_share=prof["idle_share"])
    if rank == 0:  # the same step unsharded, while rank 1 waits
        prof = _profile_step(
            "unsharded round-2 WGAN step, rank 0 alone on the card", card,
            lambda: wgan.train_step_impl(wcfg, n_c, state, real,
                                         noise=noise), n_c + 1)
        out["gan"].update(unsharded_ms=prof["step_ms_unprofiled"],
                          unsharded_busy=prof["device_busy"])

    ecfg = dataclasses.replace(wcfg, batch_size=ENS_BATCH)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    states = ens_lib.init_ensemble(ecfg, ENS_K, generator=gen,
                                   gen_init=state.gen_params,
                                   start_jitter=0.05)
    real = 1.0 + 0.1 * torch.randn(
        (ENS_K, n_c, ecfg.critic_batch, ecfg.gen.tc_dim), generator=gen,
        device=DEVICE)
    noise = wgan.draw_step_noise(ecfg, n_c, real.transpose(0, 1), gen)
    estep = par.make_sharded_ensemble_step(ens_lib.ensemble_train_step,
                                           mesh)
    (new, m), (launches, two, refine), per, counts = run(
        lambda: mesh.gather_members(estep(ecfg, n_c,
                                          mesh.member_shard(states), real,
                                          noise=noise)))
    out["ensemble"] = dict(launches=launches, two_phase=two, refine=refine,
                           circuits=per,
                           collectives=counts)
    if rank == 0:
        ref, rm = ens_lib.ensemble_train_step(ecfg, n_c, states, real,
                                              noise=noise)
        out["ensemble"]["rel"] = {
            "d_loss": _rel(m.d_loss, rm.d_loss),
            "g_loss": _rel(m.g_loss, rm.g_loss),
            "gen_params": _rel(new.gen_params, ref.gen_params),
            "gen_mu": _rel(new.gen_opt.mu, ref.gen_opt.mu)}
    return out


def _model_rank(card: str) -> dict:
    """Phase 15(d), one of two gloo ranks sharing the card as a 1 x 2
    (batch x model) mesh: (i) the generator forward and the round-2 WGAN
    step on the kernel (the model group splits the circuits), (ii) the
    same step with the direct adjoint and (iii) a BPTT step (W's columns
    split over the model axis), (iv) the paper's N=201 forward. Each with this rank's kernel launches, circuits per
    launch, collectives by kind and host and device-busy ms; the forwards
    against the unsharded forward (both ranks), the steps against the
    unsharded step on the same noise (rank 0)."""
    import torch
    import torch.distributed as dist

    from tcgan_torch import parallel as par
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan
    from tcgan_torch.ops import weights
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.ops.ssn import SSNConfig

    rank = dist.get_rank()
    mesh = par.make_mesh(n_batch=1, n_model=2)
    circuits = []
    solve = ssn_solve.solve_fixed_point_cuda

    def counted(cfg, W, *args, **kw):
        circuits.append(int(W.shape[0]))
        return solve(cfg, W, *args, **kw)

    ssn_solve.solve_fixed_point_cuda = counted

    def run(fn):
        """fn() on the mesh once, with the counts at 0: (result, this
        rank's launches, circuits per launch, collectives and host ms)."""
        counts = _count_launches()
        circuits.clear()
        mesh.counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with par.set_mesh(mesh):
            out = fn()
        torch.cuda.synchronize()
        launches, two, refine = counts()
        return out, dict(launches=launches, two_phase=two, refine=refine,
                         circuits=list(circuits),
                         collectives=dict(mesh.counts),
                         host_ms=(time.perf_counter() - t0) * 1e3)

    def forward(cfg, params, z):
        """The sharded generator forward against the unsharded one:
        max |dr| and whether the flags and iters are equal."""
        model_cfg = par.with_mesh_axes(cfg, model=True)
        with torch.no_grad():
            got, info = run(lambda: gen_lib.sample_tuning_curves(
                model_cfg, params, z.shape[0], z=z))
            ref = gen_lib.sample_tuning_curves(cfg, params, z.shape[0], z=z)
        info["max_dr"] = float((got.rates - ref.rates).abs().max())
        info["flags_equal"] = all(torch.equal(a, b) for a, b in zip(
            got[2:], ref[2:]))
        return info

    wcfg, state, real, gen = _step_setup(GAN_BATCH, GAN_SSN, GAN_CONTRASTS,
                                         clip_grad=1.0)
    n_c = wcfg.n_critic
    noise = wgan.draw_step_noise(wcfg, n_c, real, gen)
    out = {"rank": rank,
           "forward": forward(wcfg.gen, state.gen_params, noise.gen_z)}
    step = par.make_sharded_gan_step(wgan.train_step_impl, mesh)
    bptt_ssn = dataclasses.replace(wcfg.gen.ssn, seqlen=MODEL_BPTT_SEQLEN)
    for name, gen_kw in (
            ("kernel", {}), ("direct", dict(grad_method="direct")),
            ("bptt", dict(solver="bptt", ssn=bptt_ssn,
                          bptt_checkpoint_chunk=MODEL_BPTT_CHUNK))):
        cfg = dataclasses.replace(wcfg, gen=dataclasses.replace(wcfg.gen,
                                                                **gen_kw))
        scfg = dataclasses.replace(cfg, gen=par.with_mesh_axes(cfg.gen,
                                                               model=True))
        (new, m), info = run(lambda: step(scfg, n_c, state, real,
                                          noise=noise))
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, rm = wgan.train_step_impl(cfg, n_c, state, real,
                                           noise=noise)
            torch.cuda.synchronize()
            info["unsharded_ms"] = (time.perf_counter() - t0) * 1e3
            info["rel"] = {
                "d_loss": _rel(m.d_loss, rm.d_loss),
                "g_loss": _rel(m.g_loss, rm.g_loss),
                "gen_params": _rel(new.gen_params, ref.gen_params),
                "gen_mu": _rel(new.gen_opt.mu, ref.gen_opt.mu)}
        prof = _profile_step(
            f"model-axis {name} WGAN step, rank {rank} of 2 sharing the card "
            "over gloo", card,
            lambda: step(scfg, n_c, state, real, noise=noise), n_c + 1,
            reps=1 if name == "bptt" else 3, warm=True)
        info.update(step_ms=prof["step_ms_unprofiled"],
                    device_busy=prof["device_busy"],
                    idle_share=prof["idle_share"])
        out[name] = info

    as22 = lambda v: ((v[0], v[1]), (v[2], v[3]))  # noqa: E731
    scale = lambda v: as22([SLICE_SSN["N"] / WIDE_FWD_N * x  # noqa: E731
                            for x in v])
    wide = gen_lib.GeneratorConfig(
        ssn=SSNConfig(**dict(SLICE_SSN, N=WIDE_FWD_N),
                      check_every=CHECK_EVERY, backend="cuda"),
        bandwidths=BANDWIDTHS, contrasts=(CONTRAST,))
    dev = torch.device(DEVICE)
    params = gen_lib.init_params(wide, scale(SLICE_J), scale(SLICE_D),
                                 as22(SLICE_S), device=dev)
    z = weights.sample_z(torch.Generator(dev).manual_seed(SEED),
                         (MODEL_WIDE_BATCH,), WIDE_FWD_N, device=dev)
    out["wide"] = forward(wide, params, z)
    return out


def _model_axis(card: str) -> int:
    """Phase 15(d) (``_model_rank`` on two gloo ranks sharing the card):
    each check raises; returns the kernel's launches on the model-axis
    paths over both ranks."""
    from tcgan_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch.spawn(_model_rank, 2, (card,), backend="gloo",
                         devices=[DEVICE + ":0"] * 2, timeout=600,
                         deadline=900)
    seconds = time.perf_counter() - t0
    n_c = 5
    want = {"forward": [GAN_BATCH // 2], "kernel": [GAN_BATCH // 2] * (
        n_c + 1), "direct": [GAN_BATCH // 2] * (n_c + 1), "bptt": [],
        "wide": [MODEL_WIDE_BATCH // 2]}
    gates = {"kernel": (MESH_RTOL, MESH_GRAD_RTOL),
             "direct": (MESH_RTOL, MESH_GRAD_RTOL),
             "bptt": (MESH_RTOL, MODEL_BPTT_RTOL)}
    launches = 0
    for r in ranks:
        for kind, circuits in want.items():
            got = r[kind]
            busy = (f", device busy {got['device_busy']:.3f} ms, idle "
                    f"{got['idle_share']:.4f}, profiled host "
                    f"{got['step_ms']:.3f} ms" if "step_ms" in got else "")
            _line(f"[model] {kind}, rank {r['rank']} of 2 (1 x 2 mesh, a "
                  f"model axis of 2): kernel launches "
                  f"{got['launches']} on {got['circuits']} circuits, "
                  f"collectives {json.dumps(got['collectives'])}, host "
                  f"{got['host_ms']:.3f} ms{busy} ({card})")
            if got["circuits"] != circuits or got["launches"] != len(
                    circuits):
                raise AssertionError(f"model axis: {kind} rank {r['rank']} "
                                     f"launched on {got['circuits']}, not "
                                     f"{circuits}")
            launches += _default_launches(
                f"model axis: {kind} rank {r['rank']}",
                (got["launches"], got["two_phase"], got["refine"]))
            if "max_dr" in got:
                _line(f"[model] {kind}, rank {r['rank']}: the generator's "
                      f"outputs against one unsharded launch: max |dr| "
                      f"{got['max_dr']}, flags and iters equal "
                      f"{got['flags_equal']}")
                if got["max_dr"] != 0.0 or not got["flags_equal"]:
                    raise AssertionError(f"model axis: the {kind} forward "
                                         "differs from the unsharded one")
    for kind, (loss_rtol, grad_rtol) in gates.items():
        got = ranks[0][kind]
        rtol = {k: grad_rtol if k.startswith("gen_") else loss_rtol
                for k in got["rel"]}
        _line(f"[model] {kind} step over the model axis against the "
              f"unsharded step on the same noise: {json.dumps(got['rel'])} "
              f"(rtol {json.dumps(rtol)}); unsharded host "
              f"{got['unsharded_ms']:.3f} ms ({card})")
        if not all(v <= rtol[k] for k, v in got["rel"].items()):
            raise AssertionError(f"model axis: the {kind} step differs from "
                                 "the unsharded step")
    _line(f"[model] the two ranks took {seconds:.1f} s, process start "
          "included")
    return launches


def phase_mesh(card: str) -> dict:
    """Phase 15 (a)-(d); returns the kernel's launches by mesh path."""
    from tcgan_torch.entry import dryrun_multichip
    from tcgan_torch.parallel import launch

    with tempfile.TemporaryDirectory() as work:
        by_path = _mesh_cli(card, Path(work))

    t0 = time.perf_counter()
    ranks = launch.spawn(_mesh_rank, 2, (card,), backend="gloo",
                         devices=[DEVICE + ":0"] * 2, timeout=600,
                         deadline=900)
    seconds = time.perf_counter() - t0
    n_c = 5
    for kind, batch in (("gan", GAN_BATCH), ("ensemble", ENS_K * ENS_BATCH)):
        for r in ranks:
            got = r[kind]
            _line(f"[mesh] {kind}, rank {r['rank']} of 2 on one card over "
                  f"gloo: kernel launches {got['launches']} on "
                  f"{got['circuits']} circuits each, collectives per step "
                  f"{json.dumps(got['collectives'])}")
            if got["circuits"] != [batch // 2] * (n_c + 1):
                raise AssertionError(f"mesh: {kind} rank {r['rank']} "
                                     f"launched on {got['circuits']}")
        rel = ranks[0][kind]["rel"]
        rtol = {k: MESH_GRAD_RTOL if k.startswith("gen_") else MESH_RTOL
                for k in rel}
        _line(f"[mesh] {kind} sharded over 2 ranks against the unsharded "
              f"step on the same noise: {json.dumps(rel)} (rtol "
              f"{json.dumps(rtol)})")
        if not all(v <= rtol[k] for k, v in rel.items()):
            raise AssertionError(f"mesh: {kind} differs from the unsharded "
                                 "step")
    for r in ranks:
        g = r["gan"]
        _line(f"[mesh] sharded round-2 WGAN step, rank {r['rank']} of 2: "
              f"host {g['step_ms']:.3f} ms, device busy "
              f"{g['device_busy']:.3f} ms, idle {g['idle_share']:.4f} "
              f"({card})")
    g = ranks[0]["gan"]
    _line(f"[mesh] the same step unsharded in rank 0's process: host "
          f"{g['unsharded_ms']:.3f} ms, device busy "
          f"{g['unsharded_busy']:.3f} ms ({card})")
    _line(f"[mesh] the two ranks took {seconds:.1f} s, process start "
          "included")
    by_path["make_sharded_gan_step + ensemble, 2 ranks sharing the card"] = \
        sum(_default_launches(f"mesh: {k} rank {r['rank']}",
                                (r[k]["launches"], r[k]["two_phase"],
                                 r[k]["refine"]))
            for r in ranks for k in ("gan", "ensemble"))

    t0 = time.perf_counter()
    out = dryrun_multichip(4, device="cpu")
    _line(f"[mesh] dryrun_multichip(4, device='cpu'): gloo ranks: collectives "
          f"{json.dumps(out['collectives'])}, {time.perf_counter() - t0:.1f}"
          " s")
    by_path["model axis, 2 ranks sharing the card"] = _model_axis(card)
    return by_path


def _timed(number, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    _line(f"[smoke] phase {number} ({fn.__name__}) took "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    card = _timed(1, phase_environment)
    _timed(2, phase_build)
    kernels = _timed(3, phase_kernel, card)
    # launches by path and schedule, each count read where the path ran,
    # every launch of it checked there to be in the path's schedule
    refine, two, one = _timed(4, phase_main_path)
    by_path = {"run.forward": refine}
    two_by_path = {"run.forward --pallas-refine off": two}
    one_by_path = {"run.forward --pallas-two-phase off": one}
    by_path["run.forward --N 201"] = _timed("4b", phase_wide_forward, card)
    by_path["run.forward --N 201, 32 rows, Anderson"] = _timed(
        "4c", phase_split_forward, card)
    by_path["run.forward + run.gan --N 300, W from device memory"] = _timed(
        "4d", phase_global_forward, card)
    adjoint = _timed(5, phase_ift, card)
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        by_path["run.gan"] = _timed(6, phase_gan, card, work)
        by_path["run.bptt_wgan (fake truth)"] = _timed(7, phase_bptt, card)
        by_path["run.bptt_cwgan"] = _timed(8, phase_cwgan, card)
        by_path["run.moments + run.bptt_moments"] = _timed(
            9, phase_moments, card)
        by_path["run.ensemble"] = _timed(10, phase_ensemble, card, work)
        by_path["run.eval"] = _timed(11, phase_eval, card, work / "gan")
        by_path["analysis.identifiability + uncertainty"] = _timed(
            12, phase_analyses, card, work / "gan")
        _timed(14, phase_reports, card, work / "gan", work / "ens")
    _timed(13, phase_native, card)
    by_path.update(_timed(15, phase_mesh, card))
    for entry, paths in zip(kernels, (one_by_path, two_by_path, by_path)):
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
    kernels.append(adjoint)
    _line(f"[smoke] all phases took {time.perf_counter() - t_start:.1f} s")
    import torch

    _line(json.dumps({"kernels": kernels}))
    _line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
