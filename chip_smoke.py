"""Drive the PyTorch/CUDA port once on one GPU and check its kernel.

Run from the repository root, with one CUDA device visible:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build the SSN solver kernel (``tcgan_torch/csrc/ssn_solve.cu``) with nvcc;
3. kernel against its plain PyTorch version on the card, at the forward
   slice's full width (N=51, 8-stimulus battery, 512 circuits), then at 32
   circuits for each io type, the expo stepper, feedforward init,
   Anderson(1), a ragged batch and a batch of hard divergers; median times
   of the kernel and the plain version at 512 circuits;
4. the main path: ``python -m tcgan_torch.run.forward`` (through its
   ``main``) with the CUDA backend, 8 batches of 512 circuits, checked for
   launches, shapes, convergence and agreement with the plain solver; then
   one batch on the 24-stimulus battery.

The line before the last is a JSON object describing the kernel (route,
source, the TPU kernel it replaces, launches on the main path, error and
times); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

# The forward slice's benchmark circuit: N=51 sites per population, the
# 8-bandwidth battery at contrast 10, 512 circuits per solve.
SLICE_SSN = dict(N=51, k=0.01, n=2.2, dt=5e-4, max_iter=8000, atol=1e-4)
SLICE_J = (0.045, 0.04, 0.05, 0.035)
SLICE_D = (0.1, 0.08, 0.1, 0.08)
SLICE_S = (0.25, 0.1, 0.25, 0.1)
BANDWIDTHS = (0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0)
CONTRAST = 10.0
BATCH = 512
CHECK_EVERY = 32
SEED = 0
# Kernel against plain version: flags equal; rates of converged rows within
# the kernel-vs-reference tolerance of tests/test_pallas_solver.py; iters
# within two check strides (the summation order of the mat-vec differs, so
# the atol crossing can land one chunk apart).
RTOL, ATOL = 1e-4, 1e-5


def _line(*parts):
    print(*parts, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _median_ms(fn, reps: int = 5) -> float:
    import torch

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


def _slice_problem(batch, cfg, contrasts=(CONTRAST,)):
    import torch

    from tcgan_torch.ops import stimulus, weights

    dev = torch.device("cuda")
    as22 = lambda v: torch.tensor(v, device=dev).reshape(2, 2)  # noqa: E731
    gen = torch.Generator(dev).manual_seed(SEED)
    z = weights.sample_z(gen, (batch,), cfg.N, device=dev)
    x = cfg.site_pos(device=dev)
    W = weights.build_weight(as22(SLICE_J), as22(SLICE_D), as22(SLICE_S),
                             z, x)
    I = stimulus.stimulus_battery(BANDWIDTHS, contrasts, x, cfg.smoothness)
    return W, I


def _compare(name, cfg, W, I, check_every, accel=False):
    """Kernel against plain on the same inputs; returns max |dr| on rows
    both converged."""
    import torch

    from tcgan_torch.ops.cuda import ssn_solve

    out = ssn_solve.solve_fixed_point_cuda(cfg, W, I, check_every, accel)
    ref = ssn_solve.solve_fixed_point_plain(cfg, W, I, check_every, accel)
    torch.cuda.synchronize()
    if not torch.isfinite(out.r).all():
        raise AssertionError(f"{name}: non-finite kernel rates")
    n_flag = int((out.converged != ref.converged).sum()
                 + (out.diverged != ref.diverged).sum())
    both = (out.converged & ref.converged)[..., None]
    diff = (out.r - ref.r).abs() * both
    bound = ATOL + RTOL * ref.r.abs()
    n_bad = int(((diff > bound) & both).sum())
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


def phase_kernel(card: str) -> dict:
    import torch

    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.ops.ssn import SSNConfig

    cfg = SSNConfig(**SLICE_SSN)
    W, I = _slice_problem(BATCH, cfg)
    out, max_err = _compare("slice", cfg, W, I, CHECK_EVERY)

    # soft bounds under the slice's peak rate, so the saturating branches
    # of asym_tanh and asym_linear are exercised
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
                     rate_stop_at=200.0, atol=1e-6)
    gen = torch.Generator("cuda").manual_seed(SEED)
    W_bad = 8.0 * torch.randn((32, 8, 8), generator=gen,
                              device="cuda").abs()
    I_bad = 50.0 * torch.ones((1, 8), device="cuda")
    out, _ = _compare("diverge", dcfg, W_bad, I_bad, CHECK_EVERY)
    if not bool(out.diverged.all()) or float(out.r.max()) > 10 * 200.0:
        raise AssertionError("diverge: not all diverged under the ceiling")

    ms = _median_ms(lambda: ssn_solve.solve_fixed_point_cuda(
        cfg, W, I, CHECK_EVERY))
    plain_ms = _median_ms(lambda: ssn_solve.solve_fixed_point_plain(
        cfg, W, I, CHECK_EVERY))
    _line(f"[time] ssn_solve B={BATCH} S={I.shape[0]} N={cfg.N}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5; {card})")
    return {"name": "ssn_solve", "route": "cuda",
            "source": "tcgan_torch/csrc/ssn_solve.cu",
            "replaces": "tcgan_tpu/ops/pallas/ssn_solve.py:82",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _forward_argv(datastore, contrasts, total):
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    return [
        "--device", "cuda", "--solver-backend", "cuda",
        "--datastore", str(datastore), "--seed", str(SEED),
        "--N", str(SLICE_SSN["N"]), "--k", str(SLICE_SSN["k"]),
        "--n", str(SLICE_SSN["n"]), "--dt", str(SLICE_SSN["dt"]),
        "--max-iter", str(SLICE_SSN["max_iter"]),
        "--atol", str(SLICE_SSN["atol"]),
        "--check-every", str(CHECK_EVERY),
        "--J", *flat(SLICE_J), "--D", *flat(SLICE_D), "--S", *flat(SLICE_S),
        "--bandwidths", *flat(BANDWIDTHS), "--contrasts", *flat(contrasts),
        "--batch-size", str(BATCH), "--total-samples", str(total),
    ]


def phase_main_path() -> int:
    import numpy as np
    import torch

    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.run import common, forward

    total = 8 * BATCH
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "fwd"
        argv = _forward_argv(store, (CONTRAST,), total)
        ssn_solve.launches = 0
        rc = forward.main(argv)
        launches = ssn_solve.launches
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

        # The first batch again, through the plain solver from the same
        # seed: the tuning curves must agree on the rows both converged.
        args = forward.make_parser().parse_args(argv)
        cfg = common.generator_config_from_args(args, solver="ift")
        cfg = dataclasses.replace(
            cfg, ssn=dataclasses.replace(cfg.ssn, backend="torch"))
        params = gen_lib.init_params(cfg, common.as22(args.J),
                                     common.as22(args.D), common.as22(args.S),
                                     device="cuda")
        gen = torch.Generator("cuda").manual_seed(SEED)
        with torch.no_grad():
            ref = gen_lib.sample_tuning_curves(cfg, params, BATCH,
                                               generator=gen)
        ref_tc = ref.tc.cpu().numpy()
        ok = data["converged"][:BATCH] & ref.converged.cpu().numpy()
        if not np.array_equal(data["converged"][:BATCH],
                              ref.converged.cpu().numpy()):
            raise AssertionError("main path flags differ from plain solve")
        err = np.abs(tc[:BATCH] - ref_tc)[ok]
        bound = ATOL + RTOL * np.abs(ref_tc)[ok]
        if (err > bound).any():
            raise AssertionError(f"main path tuning curves differ from the "
                                 f"plain solve by up to {err.max():.3e}")
        _line(f"[main] batch 0 against plain solve: max |dtc| "
              f"{err.max():.3e} on {int(ok.sum())} converged rows")

        store24 = Path(tmp) / "fwd24"
        rc = forward.main(_forward_argv(store24, (5.0, 10.0, 13.0), 0))
        if rc != 0:
            raise AssertionError(f"24-row forward.main returned {rc}")
        s24 = json.loads((store24 / "info.json").read_text())["summary"]
        _line(f"[main] 24-row battery: frac_converged "
              f"{s24['frac_converged']} frac_diverged "
              f"{s24['frac_diverged']} circuits_per_sec "
              f"{s24['circuits_per_sec']:.1f}")
    return launches


def main() -> int:
    card = phase_environment()
    phase_build()
    kernel = phase_kernel(card)
    kernel["launches"] = phase_main_path()
    import torch

    _line(json.dumps({"kernels": [kernel]}))
    _line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
