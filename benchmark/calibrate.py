"""The readings the limits of ``correct`` are set from, for one cell, in one
process on the card (``limits/<cell>.json`` holds the limits; PERF.md the
readings):

    python3 -m benchmark.calibrate --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--fault-seeds 31 32 33 --faults half_batch
        answer_altered] [--seconds 2] [--sync-steps 20] [--out FILE]

- sound runs: the cell as the benchmark runs it, with a short window, on
  each of ``--seeds``;
- the control: the reference put in the program's place and computed in
  TF32 (:mod:`benchmark.reference.ssn`), the precision just below the
  configuration's float32, judged as the program is, on each of
  ``--control-seeds``;
- faults (:mod:`benchmark.faults`) planted in the program, on each of
  ``--fault-seeds``;
- ``--sync-steps`` (fit cells on one card): that many steps with the
  per-step sync against as many with one sync after the last, to show what
  the sync costs.

Each reading is printed as one JSON line and, with ``--out``, kept in that
file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import torch

from benchmark import faults, fit, forward, harness, inputs
from benchmark.reference import ssn


class _Out(NamedTuple):
    rates: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    tc: torch.Tensor


def forward_control(cell, seed, device, n: int) -> dict:
    """The forward readings of the reference in TF32 in the program's place,
    over the first ``n`` window batches."""
    config, traffic = cell.config, cell.traffic
    draws = inputs.Draws(seed, device)
    kept = []
    with torch.no_grad():
        for i in range(n):
            z = draws.circuit_z(traffic["batch"], config["circuit"]["N"],
                                "window", i)
            W, I = ssn.circuit_inputs(config["circuit"], *(
                config["truth"][k] for k in ("J", "D", "S")), z,
                traffic["contrasts"])
            r, conv, div, _ = ssn.solve(
                config["circuit"], W, I, atol=traffic["atol"],
                max_iter=traffic["max_iter"],
                check_every=config["circuit"]["check_every"],
                precision="tf32")
            kept.append((i, _Out(r, conv, div,
                                 ssn.tuning_curves(config["circuit"], r))))
            del W, I
    return forward.check(config, traffic, seed, device, kept)


def fit_control(cell, seed, device) -> dict:
    """The fit readings of the reference in TF32 in the program's place."""
    config, traffic = cell.config, cell.traffic
    tc = fit.truth_data(config, traffic, device)[0]
    critic0 = inputs.Draws(traffic["critic_seed"], device).critic_init(
        fit._dims(config, traffic))
    sides = [fit.reference_side(*fit.reference_steps(
        config, traffic, seed, device, tc, critic0, precision))
        for precision in ("tf32", "fp32")]
    return fit.compare(*sides, traffic["n_critic"] + 1)


def sync_cost(cell, seed, device, steps: int) -> dict:
    """ms a step with a device sync after each step, and with one sync
    after the last, in turns."""
    from benchmark import program as program_lib
    from tcgan_torch.models import wgan

    config, traffic = cell.config, cell.traffic
    tc = fit.truth_data(config, traffic, device)[0]
    draws = inputs.Draws(seed, device)
    cfg, state = program_lib.fit(
        config, traffic, device, tc, inputs.Draws(
            traffic["critic_seed"], device).critic_init(
            fit._dims(config, traffic)))
    tc_dev = torch.as_tensor(tc, device=device)
    N, t = config["circuit"]["N"], 0
    out = {"each": [], "once": []}
    for turn in ("once", "each", "each", "once", "once", "each"):
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        for _ in range(steps):
            real, cz, eps, gz = draws.step(t, traffic, N, tc_dev)
            state, _ = wgan.train_step(cfg, traffic["n_critic"], state, real,
                                       noise=wgan.StepNoise(cz, eps, gz))
            t += 1
            if turn == "each":
                torch.cuda.synchronize(device)
        torch.cuda.synchronize(device)
        out[turn].append(1e3 * (time.perf_counter() - start) / steps)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sync-steps", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from benchmark.run import measure

    cell = harness.Cell(args.workload)
    device = torch.device("cuda", 0)
    lines = []

    def emit(kind, seed, **kw):
        line = {"cell": cell.name, "kind": kind, "seed": seed, **kw}
        lines.append(line)
        print(json.dumps(line), flush=True)

    def sound(seed, plant=None):
        t0 = time.perf_counter()
        line, readings = measure(cell, seed, args.seconds, False, device,
                                 t0=t0, plant=plant)
        return readings, {
            k: v["value"] for k, v in line["metrics"].items()}, line[
            "attempted"]

    for seed in args.seeds:
        readings, metrics, n = sound(seed)
        emit("sound", seed, readings=readings, metrics=metrics, attempted=n)
    for seed in args.control_seeds:
        if cell.traffic["kind"] == "forward":
            readings = forward_control(cell, seed, device,
                                       cell.traffic["checked_batches"])
        else:
            readings = fit_control(cell, seed, device)
        emit("control", seed, readings=readings)
    for name in args.faults:
        for seed in args.fault_seeds:
            readings, _, _ = sound(seed, faults.PLANTS[name])
            emit(f"fault:{name}", seed, readings=readings)
    if args.sync_steps:
        emit("sync_cost", None, ms=sync_cost(cell, 7, device,
                                             args.sync_steps))
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
