"""Recovery-gate check: has a run held J/D within a tolerance of truth?

The port's own copy of :mod:`tcgan_tpu.analysis.recovery_gate`, with the
same flags, JSON and exit codes (0 cleared, 1 not, 2 no recorded truth).

Exit-code CLI for unattended chip-time orchestration (the pattern behind
``docs/artifacts/tpu_queue.sh`` / ``flagship_watchdog.sh``, whose first
versions embedded this logic as inline python): exit 0 when the run's
generator trajectory has BOTH J and D mean-relative errors at or below
``--gate`` across a trailing window past ``--min-step``, exit 1
otherwise (including "run too short" and "no generator.csv"). The
windowed check (three samples spanning ``--window`` steps) means a
single transient dip cannot stop a science run early.

Truth defaults to the run's own info.json (``true_J/true_D``); flags
override. Host-side CSV reading only — safe against a live run.

Usage:
    python -m tcgan_torch.analysis.recovery_gate RUNDIR [--gate 0.07]
        [--min-step 15000] [--window 1000] [--true-J a b c d]
        [--true-D a b c d] [--quiet]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from tcgan_torch.analysis.fit_quality import true_params_from_info
from tcgan_torch.analysis.loaders import load_run


def gate_status(run_dir, true_J, true_D, gate: float,
                min_step: int, window: int) -> dict:
    """Evaluate the gate; returns a status dict with ``cleared: bool``."""
    rec = load_run(run_dir)
    gen = rec.generator
    if not gen or "step" not in gen:
        return {"cleared": False, "reason": "no generator.csv"}
    steps = gen["step"]
    n = steps.size
    # --window is in STEPS, converted to row indices via the actual step
    # column (generator.csv happens to record every step today, but the
    # gate must not silently cover window*cadence steps if the recorder
    # cadence is ever thinned — ADVICE r3 #5).
    # Row AT-OR-BEFORE the window start: side='right' - 1. A side='left'
    # search lands one row INSIDE the window whenever no row's step
    # exactly equals steps[-1]-window (any cadence not dividing the
    # window, or offset steps after a resume), making the span check
    # below fail forever — 'trajectory too short' on an ever-growing run.
    i0 = int(np.searchsorted(steps, steps[-1] - window, side="right")) - 1
    if i0 < 0 or i0 >= n - 1 or steps[-1] - steps[i0] < window:
        return {"cleared": False,
                "reason": (f"trajectory too short: rows cover "
                           f"{int(steps[-1] - steps[0])} steps, window "
                           f"needs {window} past min-step")}
    J = np.stack([gen[f"J_{a}{b}"] for a in "EI" for b in "EI"], axis=1)
    D = np.stack([gen[f"D_{a}{b}"] for a in "EI" for b in "EI"], axis=1)
    tJ = np.asarray(true_J, dtype=np.float64).ravel()
    tD = np.asarray(true_D, dtype=np.float64).ravel()
    idx = [i0, (i0 + n - 1) // 2, n - 1]
    jerr = np.abs(J[idx] / tJ - 1).mean(axis=1)
    derr = np.abs(D[idx] / tD - 1).mean(axis=1)
    out = {
        "step": int(steps[-1]),
        "window_steps": [int(steps[i]) for i in idx],
        "j_err": [float(e) for e in jerr],
        "d_err": [float(e) for e in derr],
        "gate": gate,
    }
    if steps[idx[0]] < min_step:
        out.update(cleared=False,
                   reason=f"window starts before min-step {min_step}")
        return out
    cleared = bool((jerr <= gate).all() and (derr <= gate).all())
    out.update(cleared=cleared,
               reason="gate held across window" if cleared
                      else "errors above gate in window")
    return out


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tcgan_torch.analysis.recovery_gate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run", help="run datastore directory")
    p.add_argument("--gate", type=float, default=0.07,
                   help="max mean-relative J and D error (default 0.07)")
    p.add_argument("--min-step", type=int, default=15000,
                   help="gate cannot clear before this step")
    p.add_argument("--window", type=int, default=1000,
                   help="trailing STEPS the gate must hold across "
                        "(converted to rows via the step column, so a "
                        "thinned recorder cadence cannot shrink it)")
    p.add_argument("--true-J", type=float, nargs=4, default=None,
                   help="override truth (default: run's info.json)")
    p.add_argument("--true-D", type=float, nargs=4, default=None)
    p.add_argument("--quiet", action="store_true",
                   help="no JSON output, exit code only")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    run_dir = Path(args.run)
    true_J, true_D = args.true_J, args.true_D
    if true_J is None or true_D is None:
        info_file = run_dir / "info.json"
        info = (json.loads(info_file.read_text())
                if info_file.exists() else {})
        cfg = info.get("config", info)
        # Require the run's config to actually RECORD its truth: the
        # library-level DEFAULT_J/D fallback in true_params_from_info is
        # wrong for any run that used different truth, and an unattended
        # orchestrator acting on it would stop (or never stop) a science
        # run against parameters the run never used (ADVICE r3 #3).
        if (true_params_from_info(info) is None
                or not cfg.get("true_J") or not cfg.get("true_D")):
            print("recovery_gate: run config records no true_J/true_D "
                  "(real-data run, or truth left at library defaults) — "
                  "pass --true-J/--true-D explicitly", file=sys.stderr)
            return 2
        tp = true_params_from_info(info)
        true_J = tp["J"] if true_J is None else true_J
        true_D = tp["D"] if true_D is None else true_D
    status = gate_status(run_dir, true_J, true_D, args.gate,
                         args.min_step, args.window)
    if not args.quiet:
        print(json.dumps(status))
    return 0 if status["cleared"] else 1


if __name__ == "__main__":
    sys.exit(main())
