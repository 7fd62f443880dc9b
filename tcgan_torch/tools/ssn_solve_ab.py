"""The SSN solver kernel's benchmark circuit, its bound, and the kernel against
another build of its source, in turns.

:data:`SHAPES`, :data:`CLUSTER_SHAPES`, :data:`SPLIT_SHAPES`,
:data:`GLOBAL_SHAPES`, :data:`TWO_PHASE_SHAPES`, :func:`problem`,
:func:`bound`,
:func:`off_own_trajectory`, :func:`own_trajectory`,
:func:`median_ms` and :func:`card` are what
``chip_smoke.py`` and the card tests use. Run as a script on a machine
with one CUDA device, from the repository root:

    python -m tcgan_torch.tools.ssn_solve_ab --baseline OLD/ssn_solve.cu \\
        [--out runs/ssn_solve_ab.json]

``OLD/ssn_solve.cu`` is another version of ``tcgan_torch/csrc/
ssn_solve.cu`` with the same C interface (one launch entry,
``ssn_solve_run``, beside ``ssn_solve_query``: a source from the one that
introduced that entry on; for example unpacked from git into a git-ignored
directory); it is compiled with the flags of
``tcgan_torch/ops/cuda/build.py``. At each shape of :data:`SHAPES`,
:data:`CLUSTER_SHAPES`, :data:`SPLIT_SHAPES` and :data:`GLOBAL_SHAPES`
both kernels solve the same inputs in turns: baseline, this, this,
baseline, each turn the median of ``--reps`` launches timed with CUDA
events; these shapes run one phase, as they did before the two-phase
schedule. At :data:`TWO_PHASE_SHAPES` this kernel alone runs in its three
schedules, in turns (one phase, two with the 3xTF32 tail, two with the
refinement tail, and back), and the baseline's two-phase launch is held
bit for bit to this one's with the 3xTF32 tail and timed against it in
turns.
Printed per shape and kernel:
the time, the bound from the run's own ``iters`` and its share, the
slowest circuit's time per substep (launch time / max iters) and the plan
of its C entry points (cluster size, rows per chunk), with the card's name
and power limit; per kernel: registers and spills (ptxas), blocks per SM
at 2N=102 with S=8 and 16 (the CUDA occupancy API), and the count of
``HMMA`` instructions in its SASS (cuobjdump); per function of both builds,
whether the two SASS listings are the same instructions. The two kernels'
flags, iters and rates are compared with each other and with the
fp32 plain solve (rows outside rtol/atol listed) on every shape, and on
2N=224 with the slice's J and D unscaled, where near-critical rows stop at
a chunk that depends on the order of the sums.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from tcgan_torch.ops import stimulus, weights
from tcgan_torch.ops.cuda import build, ssn_solve
from tcgan_torch.ops.ssn import SSNConfig

# Published H100 SXM peaks at 700 W, dense: TF32 on the tensor cores, fp32
# outside them, HBM3. The kernel runs each fp32 product as 3 TF32 products
# (3xTF32), the least that keeps its results fp32-accurate; phase 1 of the
# two-phase schedule as one.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3

# The forward slice's circuit (BASELINE.md, bench.py's forward config): N=51,
# J/D/S below, 8 bandwidths at contrast 10; check stride 32.
SLICE_SSN = dict(N=51, k=0.01, n=2.2, dt=5e-4, max_iter=8000, atol=1e-4)
SLICE_J = (0.045, 0.04, 0.05, 0.035)
SLICE_D = (0.1, 0.08, 0.1, 0.08)
SLICE_S = (0.25, 0.1, 0.25, 0.1)
BANDWIDTHS = (0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0)
CONTRAST = 10.0
CHECK_EVERY = 32
# Kernel against its plain version: flags equal; rates of converged rows
# within the kernel-vs-reference tolerance of tests/test_pallas_solver.py;
# iters within two check strides.
RTOL, ATOL = 1e-4, 1e-5

# The shapes the main paths give the kernel: name -> (circuits, contrasts,
# SSNConfig overrides). run.forward's batch; the round-2 GAN battery at
# atol 1e-5; the GAN step of bench.py's wgan_step_ms.
SHAPES = {
    "forward B=512 S=8": (512, (CONTRAST,), {}),
    "gan B=256 S=16": (256, (5.0, CONTRAST), dict(atol=1e-5, max_iter=10000)),
    "bench_step B=32 S=8": (32, (CONTRAST,), {}),
}
# The shared-memory limit of one block at S=8: 2N=224, 64 circuits.
WIDE_N, WIDE_BATCH = 112, 64
# Beyond one block: thread-block clusters, up to the paper's N=201 and
# 2N=512. name -> (N, circuits, contrasts, SSNConfig overrides, accel); J and
# D scaled by 51 / N (``problem``).
CLUSTER_SHAPES = {
    "2N=240 S=8 B=64": (120, 64, (CONTRAST,), {}, False),
    "2N=402 S=8 B=64": (201, 64, (CONTRAST,), {}, False),
    "2N=402 S=16 B=32 anderson": (201, 32, (5.0, CONTRAST),
                                  dict(atol=1e-5, max_iter=10000), True),
    "2N=402 S=24 B=16": (201, 16, (5.0, CONTRAST, 13.0), {}, False),
    "2N=512 S=16 B=16": (256, 16, (5.0, CONTRAST), {}, False),
}
# Batteries past a cluster of 8, solved in chunks of rows (the plan beside
# each: cluster size, rows per chunk, chunks): the paper's N=201 with four
# and six contrasts, 2N=512 with three, N=51 with 32. Same key layout. With
# Anderson, and over 16k rows at N=51, contrasts to 10: past it the chunk
# at which a slow row stops moves with the rounding, the plain fp32 and
# float64 solves stopping some rows several strides apart
# (``chip_smoke.py::_split_witness`` runs those batteries to contrast 20).
SPLIT_SHAPES = {
    "2N=402 S=32 B=16 anderson": (201, 16, (2.5, 5.0, 7.5, CONTRAST), {},
                                  True),  # 4, 8, 4
    "2N=402 S=48 B=16": (201, 16, (2.5, 5.0, 7.5, CONTRAST, 13.0, 20.0), {},
                         False),  # 4, 8, 6
    "2N=512 S=24 B=16": (256, 16, (5.0, CONTRAST, 13.0), {},
                         False),  # 8, 16, 2
    "2N=102 S=256 B=64": (51, 64, tuple(0.3125 * k for k in range(1, 33)),
                          {}, False),  # 1, 128, 2
}
# Circuits whose W slab leaves no room for 8 rows in a cluster of 8, W read
# from device memory (the plan beside each: cluster size, rows per chunk,
# chunks): 2N=600 with the forward battery, the round-2 GAN's battery at its
# atol (``run.gan --N 300``), 24 rows, and four contrasts with Anderson,
# 2N=1024, and the widest admitted, 2N=2048: 1 to 4 row tiles. Same key
# layout; contrasts to 10.
GLOBAL_SHAPES = {
    "2N=600 S=8 B=64": (300, 64, (CONTRAST,), {}, False),  # 4, 8, 1
    "2N=600 S=16 B=16 gan": (300, 16, (5.0, CONTRAST),
                             dict(atol=1e-5, max_iter=10000),
                             False),  # 4, 16, 1
    "2N=600 S=24 B=16": (300, 16, (2.5, 5.0, CONTRAST), {}, False),  # 4, 24, 1
    "2N=600 S=32 B=16 anderson": (300, 16, (2.5, 5.0, 7.5, CONTRAST), {},
                                  True),  # 8, 32, 1
    "2N=1024 S=8 B=16": (512, 16, (CONTRAST,), {}, False),  # 4, 8, 1
    "2N=2048 S=8 B=4": (1024, 4, (CONTRAST,), {}, False),  # 8, 8, 1
}
# The two-phase schedule (the CLI's default) on every path of the kernel: the
# register path (N=51: run.forward's batch, the round-2 GAN battery, the
# bench step, and 3 and 4 row tiles, where the two-phase instantiations
# spill), one block with W in fp32 (2N=224), clusters (2N=402), row
# chunks (2N=402, S=32 with Anderson: 4 chunks of 8 rows) and W from device
# memory (2N=600). Same key layout as CLUSTER_SHAPES.
TWO_PHASE_SHAPES = {
    "forward B=512 S=8": (51, 512, (CONTRAST,), {}, False),
    "gan B=256 S=16": (51, 256, (5.0, CONTRAST),
                       dict(atol=1e-5, max_iter=10000), False),
    "bench_step B=32 S=8": (51, 32, (CONTRAST,), {}, False),
    "S=24 B=256": (51, 256, (2.5, 5.0, CONTRAST), {}, False),
    "S=32 B=256": (51, 256, (2.5, 5.0, 7.5, CONTRAST), {}, False),
    "2N=224 S=8 B=64": (WIDE_N, 64, (CONTRAST,), {}, False),
    "2N=402 S=8 B=64": (201, 64, (CONTRAST,), {}, False),
    "2N=402 S=32 B=16 anderson": (201, 16, (2.5, 5.0, 7.5, CONTRAST), {},
                                  True),
    "2N=600 S=8 B=64": (300, 64, (CONTRAST,), {}, False),
}


def problem(batch: int, contrasts=(CONTRAST,), ssn_overrides=None,
            N: int = 51, seed: int = 0, device: str = "cuda",
            rescale: bool = True, two_phase: bool = False,
            j_factor: float = 1.0):
    """(cfg, W (B, 2N, 2N), I (8 * len(contrasts), 2N)) of the slice's
    circuit at width N, z drawn on ``device`` from ``seed``. Away from N=51
    and with ``rescale``, J and D are scaled by 51 / N, so that a neuron's
    summed input (N sites on the same interval) and the circuit's regime
    stay those of the slice; without it the circuit is stronger than the
    slice's and many rows diverge or sit near criticality; ``j_factor``
    scales J further. The config runs one phase unless ``two_phase`` (the
    shapes' history is one phase)."""
    cfg = SSNConfig(**{**SLICE_SSN, "N": N, "pallas_two_phase": two_phase,
                       **(ssn_overrides or {})})
    dev = torch.device(device)
    scale = SLICE_SSN["N"] / N if rescale else 1.0
    as22 = lambda v, c=1.0: c * torch.tensor(  # noqa: E731
        v, device=dev).reshape(2, 2)
    z = weights.sample_z(torch.Generator(dev).manual_seed(seed), (batch,), N,
                         device=dev)
    x = cfg.site_pos(device=dev)
    W = weights.build_weight(as22(SLICE_J, scale * j_factor),
                             as22(SLICE_D, scale),
                             as22(SLICE_S), z, x)
    I = stimulus.stimulus_battery(BANDWIDTHS, contrasts, x, cfg.smoothness)
    return cfg, W, I


def matvec_flops(W: torch.Tensor, iters: torch.Tensor) -> float:
    """The solve's arithmetic: 2 (2N)^2 FLOP per row per substep, over the
    substeps each row needed (``iters``)."""
    n2 = W.shape[-1]
    return 2.0 * n2 * n2 * float(iters.double().sum())


def bound(W: torch.Tensor, I: torch.Tensor, iters: torch.Tensor,
          phase_substeps=None, refine_every: int = 0) -> tuple[float, str]:
    """Least time (ms) the card could take for this solve and what sets it:
    the mat-vec as 3 TF32 passes at the tensor cores' TF32 peak, against W,
    I and alpha read once and r and the flags written once at the HBM
    rate. In two phases, ``phase_substeps`` (the substeps each row ran in
    phase 1 and in phase 2, ``solve_fixed_point_plain(stats=)``) in place
    of ``iters``: phase 1 in one TF32 pass, phase 2 in three; with
    ``refine_every`` (the check stride) phase 2 in the refinement tail, per
    chunk of that many substeps one 3-pass anchor and ``refine_every`` - 1
    one-pass corrections."""
    B, n2, S = W.shape[0], W.shape[-1], I.shape[0]
    nbytes = 4 * (B * n2 * n2 + S * n2 + n2) + B * S * (4 * n2 + 2 + 4)
    if phase_substeps is None:
        flops = TF32_PASSES * matvec_flops(W, iters)
    else:
        p1, p2 = phase_substeps
        passes2 = (TF32_PASSES if not refine_every else
                   (TF32_PASSES + refine_every - 1) / refine_every)
        flops = matvec_flops(W, p1) + passes2 * matvec_flops(W, p2)
    t_op = flops / PEAK_TF32_FLOPS
    t_mem = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem
                                     else "bytes")


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of ``fn``, each timed with CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def own_trajectory(cfg, W, I, b, s, it, check_every, accel) -> torch.Tensor:
    """The rates (2N,) of row (b, s) in the kernel's plain version run to
    the substep ``it`` at which a launch stopped that row. In one phase the
    row alone, at atol 0 and max_iter ``it``. In two, where a row's
    trajectory depends on when its tile-mates end phase 1, circuit b's
    whole battery with phase 1 in emulated TF32 (``ssn_solve.drive_1xtf32``,
    the kernel's phase-1 arithmetic), row s stopped at ``it`` in phase 2
    (``stop_at``) and its tile-mates left to their own tests."""
    if not cfg.pallas_two_phase:
        return ssn_solve.solve_fixed_point_plain(
            dataclasses.replace(cfg, atol=0.0, max_iter=it), W[b:b + 1],
            I[s:s + 1], check_every, accel).r[0, 0]
    stop = torch.zeros((1, I.shape[0]), dtype=torch.int32, device=W.device)
    stop[0, s] = it
    return ssn_solve.solve_fixed_point_plain(
        cfg, W[b:b + 1], I, check_every, accel,
        fast_drive=ssn_solve.drive_1xtf32, stop_at=stop).r[0, s]


def off_own_trajectory(out, cfg, W, I, b, s, check_every, accel
                       ) -> tuple[float, bool]:
    """Max |dr| of row (b, s) of the kernel's rates from the plain solve of
    that row run to the kernel's own iters for it (:func:`own_trajectory`),
    and whether it lies within RTOL/ATOL: a row whose atol crossing lands a
    chunk or more apart from the plain solve's (near criticality, where the
    order of the sums decides it) must still be the right trajectory."""
    rerun = own_trajectory(cfg, W, I, b, s, int(out.iters[b, s]),
                           check_every, accel)
    d = (out.r[b, s] - rerun).abs()
    return float(d.max()), bool((d <= ATOL + RTOL * rerun.abs()).all())


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _kernel_name(fn: str) -> str:
    """A mangled function name without its anonymous namespace, which
    carries the source file's name and a hash, so that two builds' names
    compare; an instantiation whose trailing template arguments are false
    (``kWGlobal``, ``kTwoPhase``: arguments that earlier sources lack)
    under the name of the same instantiation in those sources."""
    fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", fn)
    return re.sub(r"(ssn_solve_kernelILi\d+ELb[01]ELb[01]E(?:Lb[01]E)*?)"
                  r"(?:Lb0E)+(?=E)", r"\1", fn)


def _ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each entry function in nvcc's
    ``-Xptxas=-v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            fn = _kernel_name(m.group(1))
            out.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def _sass_report(lib_path: Path) -> dict | None:
    """Per function of the library's SASS: its instructions, its ``HMMA``
    instructions and a digest of the listing without addresses and
    encodings (equal digests: the same instructions); None where the
    toolkit has no cuobjdump."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    listing, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            listing[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\* 0x", line)
        if fn and m:
            listing[fn].append(m.group(1))
    return {fn: dict(instructions=len(ins),
                     hmma=sum("HMMA" in i for i in ins),
                     digest=hashlib.sha256("\n".join(ins).encode()
                                           ).hexdigest()[:16])
            for fn, ins in listing.items()}


def _build_baseline(src: Path) -> tuple[Path, str]:
    """Compile another ssn_solve.cu with build.py's flags, unless a
    library of the same source is built already; (library, nvcc's
    output)."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libssn_solve_baseline-{key}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return out, log.read_text()
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    return out, proc.stdout + proc.stderr


def _rows_off_plain(out, plain) -> list[dict]:
    """Rows that both converged where ``out``'s rates leave rtol/atol of the
    plain solve's: (circuit, stimulus), both iters, max |dr|."""
    tol = ATOL + RTOL * plain.r.abs()
    off = (out.converged & plain.converged) & (
        (out.r - plain.r).abs() > tol).any(-1)
    return [dict(row=(b, s), iters=int(out.iters[b, s]),
                 plain_iters=int(plain.iters[b, s]),
                 max_abs_dr=float((out.r[b, s] - plain.r[b, s]).abs().max()))
            for b, s in off.nonzero().tolist()]


# The kernel's schedules: one phase, two with the 3xTF32 tail, two with the
# refinement tail (the default).
SCHEDULES = {"one": dict(pallas_two_phase=False),
             "two": dict(pallas_two_phase=True, pallas_refine=False),
             "refine": dict(pallas_two_phase=True, pallas_refine=True)}


def _schedules(lib, shape, spec, reps, name, baseline) -> dict:
    """This kernel at one of :data:`TWO_PHASE_SHAPES` in its three
    schedules (:data:`SCHEDULES`), in turns (one, two, refine, refine, two,
    one): each one's time, bound and share, iters, the share of the
    two-phase substeps run in phase 1 (from the plain version on the same
    inputs, in each schedule), and the flags and rates of each against one
    phase; and ``baseline``'s (another build's library) two-phase launch
    against this one's with the 3xTF32 tail: bit-equal, and their times in
    turns."""
    N, batch, contrasts, overrides, accel = spec
    cfg, W, I = problem(batch, contrasts, overrides, N=N, two_phase=True)
    cfgs = {k: dataclasses.replace(cfg, **kw) for k, kw in SCHEDULES.items()}
    solve = {k: (lambda c=c: ssn_solve.launch(lib, c, W, I, CHECK_EVERY,
                                              accel))
             for k, c in cfgs.items()}
    outs = {k: fn()[0] for k, fn in solve.items()}
    steps = {}
    for k in ("two", "refine"):
        stats = {}
        ssn_solve.solve_fixed_point_plain(cfgs[k], W, I, CHECK_EVERY, accel,
                                          fast_drive=ssn_solve.drive_1xtf32,
                                          stats=stats)
        steps[k] = (stats["phase1_substeps"], stats["phase2_substeps"])
    torch.cuda.synchronize()
    turns = [(k, median_ms(solve[k], reps))
             for k in ("one", "two", "refine", "refine", "two", "one")]
    rows = {}
    for k, out in outs.items():
        ms = statistics.median(t for kk, t in turns if kk == k)
        bound_ms, by = bound(W, I, out.iters, steps.get(k),
                             CHECK_EVERY if k == "refine" else 0)
        rows[k] = dict(turns_ms=[t for kk, t in turns if kk == k], ms=ms,
                       bound_ms=bound_ms, bound_by=by, share=bound_ms / ms,
                       mean_iters=float(out.iters.float().mean()),
                       max_iters=int(out.iters.max()))
        if k in steps:
            p1, p2 = steps[k]
            rows[k]["phase1_share_of_substeps"] = float(
                p1.sum() / (p1.sum() + p2.sum()))
        a, b = outs["one"], out
        both = a.converged & b.converged
        rows[k]["flags_differ_from_one"] = int(
            (a.converged != b.converged).sum()
            + (a.diverged != b.diverged).sum())
        rows[k]["max_abs_dr_from_one"] = float((a.r - b.r).abs()[both].max())
    print(f"[ab] schedules {shape}: " + "; ".join(
        f"{k} {v['ms']:.3f} ms (turns "
        f"{', '.join(f'{t:.3f}' for t in v['turns_ms'])}), bound "
        f"{v['bound_ms']:.4f} ({v['bound_by']}), mean iters "
        f"{v['mean_iters']:.1f}, max iters {v['max_iters']}"
        + (f", phase 1's share of the substeps "
           f"{v['phase1_share_of_substeps']:.4f}" if k in steps else "")
        + f", flags differing from one phase {v['flags_differ_from_one']}, "
        f"max |dr| {v['max_abs_dr_from_one']:.3e}"
        for k, v in rows.items())
        + f"; two / refine {rows['two']['ms'] / rows['refine']['ms']:.3f}, "
        f"one / refine {rows['one']['ms'] / rows['refine']['ms']:.3f}; "
        f"{name}", flush=True)
    two = cfgs["two"]
    old, _, _ = ssn_solve.launch(baseline, two, W, I, CHECK_EVERY, accel)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(old, outs["two"]))
    bt = [median_ms(lambda b=b: ssn_solve.launch(b, two, W, I,
                                                 CHECK_EVERY, accel),
                    reps) for b in (baseline, lib, lib, baseline)]
    rows["baseline_two"] = dict(bit_equal=same, turns_ms=bt,
                                speedup=(bt[0] + bt[3]) / (bt[1] + bt[2]))
    print(f"[ab] schedules {shape}: the baseline's two phases against "
          f"this build's 3xTF32 tail: (r, flags, iters) bit-equal "
          f"{same}; turns baseline, this, this, baseline "
          f"{', '.join(f'{t:.3f}' for t in bt)} ms, baseline / this "
          f"{rows['baseline_two']['speedup']:.3f}; {name}", flush=True)
    return rows


# The substep's cost in each arithmetic (``_substep_costs``): name ->
# (N, circuits, contrasts, accel, substeps), the register path at 1-4 row
# tiles, one block past it, a cluster, the N=201 fit's solve (clusters of
# 8), W from device memory.
SUBSTEP_SHAPES = {
    "S=8 B=32": (51, 32, (CONTRAST,), False, 1024),
    "S=8 B=512": (51, 512, (CONTRAST,), False, 1024),
    "S=16 B=256": (51, 256, (5.0, CONTRAST), False, 1024),
    "S=24 B=256": (51, 256, (2.5, 5.0, CONTRAST), False, 1024),
    "S=32 B=256": (51, 256, (2.5, 5.0, 7.5, CONTRAST), False, 1024),
    "2N=240 S=8 B=64": (120, 64, (CONTRAST,), False, 512),
    "2N=402 S=8 B=64": (201, 64, (CONTRAST,), False, 512),
    "2N=402 S=16 B=256": (201, 256, (5.0, CONTRAST), False, 512),
    "2N=600 S=8 B=64": (300, 64, (CONTRAST,), False, 256),
}


def _substep_costs(lib, shape, spec, reps, name) -> dict:
    """Each arithmetic's time per substep at a fixed count of substeps
    (atol 0: no row converges, so every block runs them all): one phase
    (3xTF32), and in the two-phase kernel and the refinement tail's kernel
    all substeps in phase 1 (one TF32 pass; coarse 0, phase 1's budget the
    whole count) or all in phase 2 (budget 0): the 3xTF32 tail, the
    refinement tail. Times in turns; per substep = median launch time /
    substeps (every circuit of the launch runs them, in its waves)."""
    N, batch, contrasts, accel, n_sub = spec
    cfg, W, I = problem(batch, contrasts, dict(atol=0.0, max_iter=n_sub),
                        N=N, two_phase=True)
    s = ssn_solve.Schedule
    modes = {"one phase (3xTF32)": s(False, 0.0, 0, 0.0, False),
             "phase 1 (1xTF32), two-phase kernel": s(True, 0.0, n_sub, 0.0,
                                                      False),
             "phase 1 (1xTF32), refine kernel": s(True, 0.0, n_sub, 0.0, True),
             "phase 2, 3xTF32 tail": s(True, 0.0, 0, 0.0, False),
             "phase 2, refinement tail": s(True, 0.0, 0, 0.0, True)}
    run = {k: (lambda m=m: ssn_solve.launch(lib, cfg, W, I, CHECK_EVERY,
                                            accel, sched=m))
           for k, m in modes.items()}
    for fn in run.values():
        fn()
    torch.cuda.synchronize()
    order = list(modes) + list(modes)[::-1]
    turns = [(k, median_ms(run[k], reps)) for k in order]
    us = {k: 1e3 * statistics.mean(t for kk, t in turns if kk == k) / n_sub
          for k in modes}
    base = us["one phase (3xTF32)"]
    print(f"[ab] substep {shape} ({n_sub} substeps, atol 0): " + "; ".join(
        f"{k} {v:.3f} us ({v / base:.3f})" for k, v in us.items())
        + f"; {name}", flush=True)
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="another ssn_solve.cu with the same C interface")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssn_solve_ab: needs a CUDA device")
    name = card()
    this = build.build("ssn_solve")
    kernels = {}
    for label, (path, log) in (("baseline", _build_baseline(args.baseline)),
                               ("this", (this.path, this.log))):
        lib = ssn_solve.bind(path)
        kernels[label] = dict(
            lib=lib, ptxas=_ptxas_report(log), sass=_sass_report(path),
            blocks_per_sm={f"2N=102 S={S}": ssn_solve.query(
                102, S, lib=lib).blocks_per_sm for S in (8, 16)})
        print(f"[ab] {label}: ptxas {kernels[label]['ptxas']}; SASS "
              f"{kernels[label]['sass']}; blocks per SM "
              f"{kernels[label]['blocks_per_sm']}; {name}", flush=True)
    old, new = kernels["baseline"]["sass"], kernels["this"]["sass"]
    for fn in sorted(set(old or {}) & set(new or {})):
        same = old[fn]["digest"] == new[fn]["digest"]
        print(f"[ab] SASS {fn}: {'the same' if same else 'differs'} "
              f"({old[fn]['instructions']} -> {new[fn]['instructions']} "
              f"instructions)", flush=True)

    report = {"card": name, "reps": args.reps, "shapes": {}, "kernels": {
        k: {kk: vv for kk, vv in v.items() if kk != "lib"}
        for k, v in kernels.items()}}
    cases = {k: (b, c, kw, {}, False) for k, (b, c, kw) in SHAPES.items()}
    cases["wide 2N=224 S=8, J and D unscaled"] = (
        WIDE_BATCH, (CONTRAST,), {}, dict(N=WIDE_N, rescale=False), False)
    for k, (N, b, c, kw, accel) in {**CLUSTER_SHAPES, **SPLIT_SHAPES,
                                    **GLOBAL_SHAPES}.items():
        cases[k] = (b, c, kw, dict(N=N), accel)
    for shape, (batch, contrasts, overrides, kw, accel) in cases.items():
        cfg, W, I = problem(batch, contrasts, overrides, **kw)
        solve = {k: (lambda lib=v["lib"]: ssn_solve.launch(
            lib, cfg, W, I, CHECK_EVERY, accel)) for k, v in kernels.items()}
        outs = {k: fn()[0] for k, fn in solve.items()}
        plain = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                                  accel)
        torch.cuda.synchronize()
        turns = [(k, median_ms(solve[k], args.reps))
                 for k in ("baseline", "this", "this", "baseline")]
        rows = {}
        for k, out in outs.items():
            ms = statistics.median(t for kk, t in turns if kk == k)
            bound_ms, by = bound(W, I, out.iters)
            max_iters = int(out.iters.max())
            rows[k] = dict(
                turns_ms=[t for kk, t in turns if kk == k], ms=ms,
                bound_ms=bound_ms, bound_by=by, share=bound_ms / ms,
                mean_iters=float(out.iters.float().mean()),
                max_iters=max_iters, us_per_substep=1e3 * ms / max_iters,
                rows_off_plain=_rows_off_plain(out, plain))
            print(f"[ab] {shape} {k}: {ms:.3f} ms (turns "
                  f"{', '.join(f'{t:.3f}' for t in rows[k]['turns_ms'])}), "
                  f"bound {bound_ms:.4f} ms ({by}), share "
                  f"{rows[k]['share']:.4f}, slowest circuit "
                  f"{rows[k]['us_per_substep']:.3f} us per substep over "
                  f"{max_iters} iters; rows both converged outside rtol "
                  f"{RTOL} atol {ATOL} of the fp32 plain solve: "
                  f"{rows[k]['rows_off_plain']}; {name}", flush=True)
        n2, S = W.shape[-1], I.shape[0]
        n = ssn_solve.query(n2, S, accel).chunks_at_once
        rows["plan"] = ssn_solve.plan(n2, S, accel)
        rows["active_clusters"] = n
        # each build's own plan (cluster size, rows per chunk)
        rows["kernel_plans"] = {
            k: tuple(ssn_solve.query(n2, S, accel, lib=v["lib"]).plan[:2])
            for k, v in kernels.items()}
        print(f"[ab] {shape}: plan {rows['plan']}, {n} chunks at once; "
              f"the builds' C plans {rows['kernel_plans']}", flush=True)
        a, b = outs["baseline"], outs["this"]
        both = a.converged & b.converged
        rows["flag_mismatch"] = int((a.converged != b.converged).sum()
                                    + (a.diverged != b.diverged).sum())
        rows["rows_iters_differ"] = int((a.iters != b.iters).sum())
        rows["max_abs_dr"] = float((a.r - b.r).abs()[both].max())
        rows["bit_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
        plans = rows["kernel_plans"]
        rows["same_plan"] = plans["baseline"] == plans["this"]
        rows["speedup"] = rows["baseline"]["ms"] / rows["this"]["ms"]
        print(f"[ab] {shape}: baseline / this = {rows['speedup']:.3f}; "
              f"between the two: flags differing {rows['flag_mismatch']}, "
              f"rows whose iters differ {rows['rows_iters_differ']}, max "
              f"|dr| on rows both converged {rows['max_abs_dr']:.3e}, "
              f"(r, flags, iters) bit-equal {rows['bit_equal']}, the same "
              f"plan {rows['same_plan']}", flush=True)
        report["shapes"][shape] = rows
    report["schedules"] = {
        shape: _schedules(kernels["this"]["lib"], shape, spec, args.reps, name,
                          kernels["baseline"]["lib"])
        for shape, spec in TWO_PHASE_SHAPES.items()}
    report["substeps"] = {
        label: {shape: _substep_costs(v["lib"], shape, spec, args.reps, name)
                for shape, spec in SUBSTEP_SHAPES.items()}
        for label, v in kernels.items()}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
