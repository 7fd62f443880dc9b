"""Multi-run comparison: load several datastores and overlay their fits.

The port's own copy of :mod:`tcgan_tpu.analysis.compare`, with the same
flags and summary; without matplotlib the figure is skipped and the
summary's ``"plot"`` says so.

Reference parity: the run-comparison analyzers of ``tc_gan/analyzers/``
(SURVEY.md §2 "Analyzers / loaders") — the workflow of comparing several
GAN/moment-matching fits (different seeds, hyper-parameters, or methods)
on shared axes.

Usage:
    python -m tcgan_torch.analysis.compare RUN1 RUN2 [...] [-o OUT.png]
        [--labels a b ...] [--true-J a b c d] [--true-D ...] [--true-S ...]

Writes an overlay figure (losses, convergence, J/D/S trajectories with
optional true-value lines) and prints a JSON summary with each run's final
stats and, when truth is given, per-run parameter-recovery errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from tcgan_torch.analysis.loaders import RunRecord, load_run
from tcgan_torch.analysis.metrics import param_recovery_error
from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib


def load_runs(paths: Sequence[str | Path]) -> List[RunRecord]:
    """Load several run datastores (order preserved)."""
    return [load_run(p) for p in paths]


def plot_comparison(recs: List[RunRecord], out_path, labels=None,
                    true_params=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or [r.path.name for r in recs]
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))

    ax = axes[0, 0]
    for rec, lab in zip(recs, labels):
        for col in ("g_loss", "loss"):
            if col in rec.learning:
                ax.plot(rec.steps, rec.learning[col], label=f"{lab}:{col}",
                        lw=0.9)
                break
    ax.set_title("generator / fit loss")
    ax.set_xlabel("step")
    ax.legend(fontsize=7)

    ax = axes[0, 1]
    for rec, lab in zip(recs, labels):
        if "wasserstein" in rec.learning:
            ax.plot(rec.steps, rec.learning["wasserstein"], label=lab, lw=0.9)
    ax.set_title("Wasserstein estimate")
    ax.set_xlabel("step")
    ax.legend(fontsize=7)

    ax = axes[0, 2]
    for rec, lab in zip(recs, labels):
        if "frac_converged" in rec.learning:
            ax.plot(rec.steps, rec.learning["frac_converged"], label=lab,
                    lw=0.9)
    ax.set_ylim(-0.05, 1.05)
    ax.set_title("solver convergence fraction")
    ax.legend(fontsize=7)

    pops = ("E", "I")
    for j, name in enumerate("JDS"):
        ax = axes[1, j]
        for rec, lab in zip(recs, labels):
            if f"{name}_EE" not in rec.generator:
                continue
            traj = rec.gen_param_trajectory(name)  # (steps, 2, 2)
            gsteps = rec.generator.get("step", np.arange(traj.shape[0]))
            for a in range(2):
                for b in range(2):
                    ax.plot(gsteps, traj[:, a, b], lw=0.8,
                            label=f"{lab}:{name}_{pops[a]}{pops[b]}"
                            if (a, b) == (0, 0) else None)
        if true_params and name in true_params:
            for a in range(2):
                for b in range(2):
                    ax.axhline(true_params[name][a][b], ls="--", lw=0.8,
                               color="k", alpha=0.5)
        ax.set_title(f"{name} trajectories"
                     + (" (-- true)" if true_params else ""))
        ax.set_xlabel("step")
        ax.legend(fontsize=7)

    fig.suptitle(" vs ".join(labels))
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def summarize(recs: List[RunRecord], labels=None,
              true_params=None) -> Dict[str, dict]:
    labels = labels or [r.path.name for r in recs]
    out: Dict[str, dict] = {}
    for rec, lab in zip(recs, labels):
        entry: dict = {
            "path": str(rec.path),
            "n_steps": int(rec.steps.shape[0]),
            "final": {k: float(v[-1]) for k, v in rec.learning.items()
                      if v.shape[0] and k != "step" and np.isfinite(v[-1])},
        }
        if true_params and rec.generator:
            fitted = {k: v for k, v in rec.final_gen_params().items()
                      if k in true_params}
            entry["param_recovery_error"] = param_recovery_error(
                fitted,
                {k: np.asarray(v) for k, v in true_params.items()
                 if k in fitted},
            )
        out[lab] = entry
    return out


def make_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rundirs", nargs="+")
    p.add_argument("-o", "--out", default="run_comparison.png")
    p.add_argument("--labels", nargs="+", default=None)
    for name in ("J", "D", "S"):
        p.add_argument(f"--true-{name}", type=float, nargs=4, default=None)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    recs = load_runs(args.rundirs)
    true_params = None
    if args.true_J or args.true_D or args.true_S:
        as22 = lambda f: ((f[0], f[1]), (f[2], f[3]))
        true_params = {n: as22(getattr(args, f"true_{n}"))
                       for n in "JDS" if getattr(args, f"true_{n}")}
    out = args.out
    if have_matplotlib():
        plot_comparison(recs, out, labels=args.labels,
                        true_params=true_params)
    else:
        out = PLOTS_SKIPPED
    print(json.dumps({"plot": out,
                      "runs": summarize(recs, args.labels, true_params)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
