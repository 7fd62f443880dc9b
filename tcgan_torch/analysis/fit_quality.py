"""One-page fit-quality figure for a run directory (paper-style).

The port's own copy of :mod:`tcgan_tpu.analysis.fit_quality`, with the same
flags and summary keys. Every number is computed without matplotlib; the
figure is drawn only where it is installed, and otherwise the printed
``"plot"`` says it was skipped.

Reference parity: the fit-quality analyzers of ``tc_gan/analyzers/``
(SURVEY.md §2 "Analyzers / loaders") — the figure a reader of the paper
expects: learning curves, parameter trajectories against ground truth, and
the generated-vs-data tuning-curve distribution comparison, on one page.

Usage:
    python -m tcgan_torch.analysis.fit_quality RUNDIR [--eval EVALDIR]
        [-o OUT.png]

Ground-truth parameter lines are read from the run's own ``info.json``
(``true_J/true_D/true_S`` of the fake-truth dataset, falling back to the
framework defaults exactly as dataset generation did). The TC-distribution
panels use ``eval_tuning_curves.npz`` from an eval datastore
(``tcgan_torch.run.eval --datastore EVALDIR``) when available; without it
the figure still renders the run-stream panels.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from tcgan_torch.analysis.loaders import RunRecord, load_run
from tcgan_torch.analysis.metrics import (
    param_recovery_error, sliced_w1, tc_w1, w1_per_feature,
)
from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib


def true_params_from_info(info: dict):
    """Reconstruct the fake-truth (J, D, S) the run's dataset used."""
    from tcgan_torch.ops.ssn import DEFAULT_D, DEFAULT_J, DEFAULT_S

    cfg = info.get("config", info)
    if cfg.get("dataset"):
        return None  # real data — no ground truth
    as22 = lambda f: np.asarray(f, dtype=np.float64).reshape(2, 2)
    out = {}
    for name, default in (("J", DEFAULT_J), ("D", DEFAULT_D),
                          ("S", DEFAULT_S)):
        v = cfg.get(f"true_{name}")
        out[name] = as22(v) if v else np.asarray(default)
    return out


def fit_quality_summary(rec: RunRecord, true_params=None,
                        eval_npz=None) -> dict:
    """The figure's numbers: parameter recovery against the truth, and the
    W1 and sliced W1 of the eval's tuning curves against the data."""
    summary = {}
    if true_params is not None and rec.generator:
        summary["param_recovery_error"] = param_recovery_error(
            rec.final_gen_params(), true_params)
    if eval_npz is not None:
        gen_tc = np.asarray(eval_npz["gen_tc"])
        data_tc = np.asarray(eval_npz["data_tc"])
        summary["tc_w1"] = tc_w1(gen_tc, data_tc)
        summary["sliced_w1"] = sliced_w1(gen_tc, data_tc)
    return summary


def plot_fit_quality(rec: RunRecord, out_path, true_params=None,
                     eval_npz=None, jacobian=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    have_tc = eval_npz is not None
    have_jac = jacobian is not None and true_params is not None \
        and bool(rec.generator)
    nrows = 2 + (1 if have_tc else 0) + (1 if have_jac else 0)
    fig, axes = plt.subplots(nrows, 3, figsize=(15, 4 * nrows),
                             squeeze=False)
    lrn, steps = rec.learning, rec.steps

    ax = axes[0][0]
    for col in ("d_loss", "g_loss", "loss"):
        if col in lrn:
            ax.plot(steps, lrn[col], label=col, lw=0.8)
    ax.set_title("losses")
    ax.legend(fontsize=8)

    ax = axes[0][1]
    if "wasserstein" in lrn:
        ax.plot(steps, lrn["wasserstein"], lw=0.8)
        ax.set_title("Wasserstein estimate")
    elif "mean_err" in lrn:
        ax.semilogy(steps, lrn["mean_err"], label="mean_err", lw=0.8)
        ax.semilogy(steps, lrn["cov_err"], label="cov_err", lw=0.8)
        ax.set_title("moment errors")
        ax.legend(fontsize=8)

    ax = axes[0][2]
    for col in ("frac_converged", "frac_diverged", "d_accuracy"):
        if col in lrn:
            ax.plot(steps, lrn[col], label=col, lw=0.8)
    ax.set_ylim(-0.05, 1.05)
    ax.set_title("solver convergence / critic accuracy")
    ax.legend(fontsize=8)

    pops = ("E", "I")
    for j, name in enumerate("JDS"):
        ax = axes[1][j]
        if f"{name}_EE" not in rec.generator:
            # run aborted before the first generator.csv flush: render
            # the remaining panels rather than KeyError out
            ax.set_title(f"{name} trajectories (no generator stream)")
            continue
        traj = rec.gen_param_trajectory(name)
        gsteps = rec.generator.get("step", np.arange(traj.shape[0]))
        for a in range(2):
            for b in range(2):
                (line,) = ax.plot(gsteps, traj[:, a, b], lw=0.9,
                                  label=f"{name}_{pops[a]}{pops[b]}")
                if true_params is not None:
                    ax.axhline(true_params[name][a, b], ls="--", lw=0.8,
                               color=line.get_color())
        ax.set_title(f"{name} trajectory"
                     + (" (-- true)" if true_params is not None else ""))
        ax.legend(fontsize=7)

    if have_jac:
        from tcgan_torch.analysis.identifiability import subspace_trajectory

        traj = {n: rec.gen_param_trajectory(n) for n in "JDS"}
        st = subspace_trajectory(jacobian, traj, true_params)
        gsteps = rec.generator.get(
            "step", np.arange(st["components"].shape[0]))
        row = nrows - 1 - (1 if have_tc else 0)
        ax = axes[row][0]
        order = np.argsort(st["singular_values"])
        for rank, j in enumerate(order[:4]):  # 4 flattest
            ax.semilogy(gsteps, np.abs(st["components"][:, j]) + 1e-6,
                        lw=0.9, label=f"sv={st['singular_values'][j]:.3g}")
        for j in order[-2:]:  # 2 strongest
            ax.semilogy(gsteps, np.abs(st["components"][:, j]) + 1e-6,
                        lw=0.9, ls="--",
                        label=f"sv={st['singular_values'][j]:.3g}")
        ax.set_title("|error component| per singular direction")
        ax.set_xlabel("step")
        ax.legend(fontsize=7)

        ax = axes[row][1]
        final = np.abs(st["components"][-1])
        sv = np.maximum(st["singular_values"], 1e-12)
        ax.loglog(sv, final + 1e-6, "o")
        ax.set_xlabel("singular value")
        ax.set_ylabel("final |error component|")
        ax.set_title("final error vs identifiability")
        axes[row][2].axis("off")

    if have_tc:
        tc_row = nrows - 1
        gen_tc = np.asarray(eval_npz["gen_tc"])
        data_tc = np.asarray(eval_npz["data_tc"])

        ax = axes[tc_row][0]
        xs = np.arange(data_tc.shape[1])
        for tc, label, color in ((data_tc, "data", "C0"),
                                 (gen_tc, "generated", "C1")):
            m, s = tc.mean(0), tc.std(0)
            ax.plot(xs, m, color=color, label=label)
            ax.fill_between(xs, m - s, m + s, color=color, alpha=0.25)
        ax.set_title("mean TC ± std")
        ax.set_xlabel("condition index")
        ax.legend(fontsize=8)

        ax = axes[tc_row][1]
        w1s = w1_per_feature(gen_tc, data_tc)
        ax.bar(xs, w1s, color="C2")
        ax.set_title(f"per-condition W1 (mean {w1s.mean():.4g})")
        ax.set_xlabel("condition index")

        ax = axes[tc_row][2]
        fidx = int(np.argmax(data_tc.std(0)))
        ax.hist(data_tc[:, fidx], bins=30, alpha=0.6, density=True,
                label="data")
        ax.hist(gen_tc[:, fidx], bins=30, alpha=0.6, density=True,
                label="generated")
        ax.set_title(f"marginal at condition {fidx}")
        ax.legend(fontsize=8)

    fig.suptitle(f"fit quality — {rec.path}")
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return fit_quality_summary(rec, true_params, eval_npz)


def make_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rundir")
    p.add_argument("--eval", default=None,
                   help="eval datastore holding eval_tuning_curves.npz "
                        "(from tcgan_torch.run.eval --datastore ...)")
    p.add_argument("-o", "--out", default=None,
                   help="output PNG (default RUNDIR/fit_quality.png)")
    p.add_argument("--jacobian", default=None,
                   help="moment-Jacobian .npz saved by "
                        "tcgan_torch.analysis.identifiability --save-jacobian: "
                        "adds the ridge-aware error decomposition "
                        "(identifiable vs provably-flat directions)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rec = load_run(args.rundir)
    out = args.out or str(rec.path / "fit_quality.png")
    true_params = true_params_from_info(rec.info)
    eval_npz = None
    if args.eval:
        npz_path = Path(args.eval) / "eval_tuning_curves.npz"
        if npz_path.exists():
            eval_npz = np.load(npz_path)
    else:  # look next to the run by convention
        for cand in (rec.path / "eval_tuning_curves.npz",
                     Path(str(rec.path) + "_eval") / "eval_tuning_curves.npz"):
            if cand.exists():
                eval_npz = np.load(cand)
                break
    jac = np.load(args.jacobian)["jacobian"] if args.jacobian else None
    if have_matplotlib():
        summary = plot_fit_quality(rec, out, true_params=true_params,
                                   eval_npz=eval_npz, jacobian=jac)
    else:
        summary = fit_quality_summary(rec, true_params, eval_npz)
        out = PLOTS_SKIPPED
    if jac is not None and true_params is not None and rec.generator:
        from tcgan_torch.analysis.identifiability import subspace_errors

        dec = subspace_errors(jac, rec.final_gen_params(), true_params)
        summary["subspace"] = {
            k: dec[k] for k in ("identifiable_error", "unidentifiable_error",
                                "n_identifiable", "raw_error")}
    print(json.dumps({"run": str(rec.path), "plot": out, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
