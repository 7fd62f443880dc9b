"""``--parallel mesh`` across every visible card against one card.

Run from the repository root on a machine with several CUDA devices:

    python -m tcgan_torch.tools.mesh_ab [--steps 6] \
        [--batch-sizes 256 1024]

For each batch size, ``run.gan`` at the round-2 configuration (N=51, 8
bandwidths x contrasts 5 and 10, fake truth at the slice's J, D, S, the
start +30% J and -30% D, ``--normalize-input --clip-grad 1.0``, the CUDA
kernel) runs for ``--steps`` steps on one card, then with ``--parallel
mesh`` on every visible card (one spawned NCCL rank each, B/P circuits a
rank), the same seed. Printed: each run's ``train_time`` per step (the
median of steps 1 on) and wall time, the largest relative difference of
the two runs' learning rows (held to rtol 1e-4), with the cards' names and
power limit; then ``tcgan_torch.entry.dryrun_multichip`` on the cards
(NCCL, a batch x model mesh). One JSON line at the end.
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from tcgan_torch.tools.ssn_solve_ab import (BANDWIDTHS, SLICE_D, SLICE_J,
                                            SLICE_S, card)

RTOL = 1e-4
CLOCKS = {"train_time", "SSsolve_time", "gradient_time"}


def _argv(store: Path, steps: int, batch: int) -> list:
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    return [
        "--device", "cuda", "--solver-backend", "cuda", "--seed", "0",
        "--datastore", str(store), "--N", "51",
        "--bandwidths", *flat(BANDWIDTHS), "--contrasts", "5", "10",
        "--batch-size", str(batch), "--normalize-input", "--clip-grad", "1.0",
        "--true-J", *flat(SLICE_J), "--true-D", *flat(SLICE_D),
        "--true-S", *flat(SLICE_S),
        "--J", *flat(round(1.3 * v, 6) for v in SLICE_J),
        "--D", *flat(round(0.7 * v, 6) for v in SLICE_D),
        "--S", *flat(SLICE_S), "--n-steps", str(steps),
    ]


def _run(argv: list) -> tuple[list, float]:
    from tcgan_torch.run import gan

    t0 = time.perf_counter()
    if gan.main(argv) != 0:
        raise RuntimeError(f"run.gan {' '.join(argv)} failed")
    seconds = time.perf_counter() - t0
    store = Path(argv[argv.index("--datastore") + 1])
    with open(store / "learning.csv", newline="") as f:
        return list(csv.DictReader(f)), seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[256, 1024])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_ab: no CUDA device is visible")
    from tcgan_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    out = {"cards": n, "card": card(), "steps": args.steps, "batches": {}}
    worst = 0.0
    for batch in args.batch_sizes:
        res, runs = out["batches"].setdefault(str(batch), {}), {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, extra in (("one_card", []),
                                ("mesh", ["--parallel", "mesh"])):
                rows, seconds = _run(_argv(Path(tmp) / name, args.steps,
                                           batch) + extra)
                train = [1e3 * float(r["train_time"]) for r in rows[1:]]
                runs[name] = rows
                res[name] = {"train_ms_median": statistics.median(train),
                             "train_ms": train, "seconds": seconds}
                print(f"[mesh_ab] B={batch} {name}: train_time steps "
                      f"1-{len(train)} "
                      f"{', '.join(f'{t:.1f}' for t in train)} ms, median "
                      f"{res[name]['train_ms_median']:.1f} ms; "
                      f"{seconds:.1f} s ({n} visible card(s): "
                      f"{out['card']})", flush=True)
        rel = 0.0
        for a, b in zip(runs["mesh"], runs["one_card"], strict=True):
            for k in a.keys() - CLOCKS:
                x, y = float(a[k]), float(b[k])
                if x != y:
                    rel = max(rel, abs(x - y) / max(abs(y), 1e-12))
        res["max_rel_d_row"] = rel
        worst = max(worst, rel)
        print(f"[mesh_ab] B={batch} learning rows, mesh of {n} against one "
              f"card: max rel difference {rel:.3e} (rtol {RTOL})",
              flush=True)
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(n)
    out["dryrun"]["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0 if worst <= RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
