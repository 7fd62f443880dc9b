"""Run one cell of the port's benchmark once, in this process:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads and warms up the cell's own shapes
(set-up), measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics read from a profiled slice),
``device``, ``breakdown`` (traced runs) and ``checks`` (each compared
number beside its limit). It exits non-zero, printing no result, where
the cards the cell asks for are not there, or where JAX or the JAX package
is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it (None
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return [float(x) for x in out.stdout.split()]
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed, seconds, traced, device, t0=T0, plant=None):
    """(the run's result line, every reading the check made; the line
    compares those the cell's limits name). ``plant``: a fault from
    :mod:`benchmark.faults`, for the benchmark's tests."""
    from benchmark import fit, forward

    kind = cell.traffic["kind"]
    driver = {"forward": forward.run, "fit": fit.run}[kind]
    e2e, per_layer, readings, attempted, peak = driver(
        cell, seed, seconds, traced, device, t0, plant=plant)
    print(f"[bench] {cell.name}: {attempted} in the window; checked and "
          f"counted by {time.perf_counter() - t0:.1f} s after start",
          file=sys.stderr)
    correct, checks = harness.judge(readings, cell.limits)
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": harness.metrics_line(cell, e2e,
                                            per_layer if traced else None)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = per_layer["slice"]["busy_s"]
        dev["window_s"] = per_layer["slice"]["wall_s"]
    line["device"] = dev
    if traced:
        line["breakdown"] = {k: per_layer["slice"][k]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = checks
    return line, readings


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line, _ = measure(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    line["device"]["power_limit_w"] = power_limit_w()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
