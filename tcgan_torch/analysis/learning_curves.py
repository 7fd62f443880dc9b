"""Learning-curve and parameter-trajectory plots for a run directory.

The port's own copy of :mod:`tcgan_tpu.analysis.learning_curves`, with the
same flags and summary; without matplotlib the figure is skipped and the
summary's ``"plot"`` says so.

Reference parity: the learning-curve / parameter-trajectory analyzers of
``tc_gan/analyzers/`` (SURVEY.md §2 "Analyzers / loaders").

Usage:
    python -m tcgan_torch.analysis.learning_curves RUNDIR [-o OUT.png]
        [--true-J a b c d] [--true-D ...] [--true-S ...]

Writes a multi-panel PNG (losses, Wasserstein estimate, convergence
fraction, J/D/S trajectories with optional true-value reference lines) and
prints a one-line JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tcgan_torch.analysis.loaders import RunRecord, load_run
from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib


def plot_run(rec: RunRecord, out_path: str, true_params=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = rec.steps
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    lrn = rec.learning

    ax = axes[0, 0]
    for col in ("d_loss", "g_loss", "loss"):
        if col in lrn:
            ax.plot(steps, lrn[col], label=col)
    ax.set_title("losses")
    ax.set_xlabel("step")
    ax.legend()

    ax = axes[0, 1]
    if "wasserstein" in lrn:
        ax.plot(steps, lrn["wasserstein"])
        ax.set_title("Wasserstein estimate (critic advantage)")
    elif "mean_err" in lrn:
        ax.semilogy(steps, lrn["mean_err"], label="mean_err")
        ax.semilogy(steps, lrn["cov_err"], label="cov_err")
        ax.set_title("moment errors")
        ax.legend()
    ax.set_xlabel("step")

    ax = axes[0, 2]
    for col in ("frac_converged", "frac_diverged"):
        if col in lrn:
            ax.plot(steps, lrn[col], label=col)
    ax.set_ylim(-0.05, 1.05)
    ax.set_title("solver convergence")
    ax.legend()

    pops = ("E", "I")
    for j, name in enumerate("JDS"):
        ax = axes[1, j]
        if f"{name}_EE" not in rec.generator:
            ax.set_title(f"{name} trajectories (no generator stream)")
            continue
        traj = rec.gen_param_trajectory(name)  # (steps, 2, 2)
        gsteps = rec.generator.get("step", np.arange(traj.shape[0]))
        for a in range(2):
            for b in range(2):
                (line,) = ax.plot(gsteps, traj[:, a, b],
                                  label=f"{name}_{pops[a]}{pops[b]}")
                if true_params and name in true_params:
                    ax.axhline(true_params[name][a][b], ls="--", lw=0.8,
                               color=line.get_color())
        ax.set_title(f"{name} trajectory" + (" (-- true)" if true_params else ""))
        ax.set_xlabel("step")
        ax.legend(fontsize=7)

    fig.suptitle(str(rec.path))
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def make_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rundir")
    p.add_argument("-o", "--out", default=None,
                   help="output PNG (default RUNDIR/learning_curves.png)")
    for name in ("J", "D", "S"):
        p.add_argument(f"--true-{name}", type=float, nargs=4, default=None)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rec = load_run(args.rundir)
    out = args.out or str(rec.path / "learning_curves.png")
    true_params = None
    if args.true_J or args.true_D or args.true_S:
        as22 = lambda f: ((f[0], f[1]), (f[2], f[3]))
        true_params = {n: as22(getattr(args, f"true_{n}"))
                       for n in "JDS" if getattr(args, f"true_{n}")}
    if have_matplotlib():
        plot_run(rec, out, true_params)
    else:
        out = PLOTS_SKIPPED
    summary = {
        "run": str(rec.path),
        "n_steps": int(rec.steps.shape[0]),
        "plot": out,
        "final": {k: float(v[-1]) for k, v in rec.learning.items()
                  if v.shape[0] and k != "step" and np.isfinite(v[-1])},
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
