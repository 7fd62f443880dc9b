"""Ensemble-run figure: per-member parameter trajectories, loss overlays,
and the across-member spread decomposition.

The port's own copy of :mod:`tcgan_tpu.analysis.ensemble_view`, with the
same flags and summary; without matplotlib the figure is skipped and the
summary's ``"plot"`` says so.

Usage:
    python -m tcgan_torch.analysis.ensemble_view RUNDIR [-o OUT.png]
        [--jacobian JAC.npz]

With ``--jacobian`` (saved by ``analysis.identifiability
--save-jacobian``), the figure adds the spread-vs-identifiability panel:
across-member parameter standard deviation along each of the battery's
singular directions against that direction's singular value — the
multi-start consistency check of BASELINE.md ("ensemble seed-spread is
predicted by the identifiability spectrum").
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tcgan_torch.analysis.loaders import EnsembleRecord, load_ensemble
from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib


def spread_vs_spectrum(rec: EnsembleRecord, jacobian: np.ndarray):
    """(singular_values, member spread along each right singular dir).

    full_matrices SVD with zero-padded singular values: a moment-deficient
    battery (fewer moment rows than the 12 params) has an EXACT null
    space, and the reduced SVD would silently drop those flattest
    directions — exactly the ones the spread panel exists to expose."""
    K = rec.params["J"].shape[0]
    theta = np.concatenate(
        [np.log(rec.params[k].reshape(K, 4)) for k in ("J", "D", "S")],
        axis=1)
    d = theta - theta.mean(axis=0)
    jac = np.asarray(jacobian, dtype=np.float64)
    _, s, vt = np.linalg.svd(jac, full_matrices=True)
    if s.shape[0] < jac.shape[1]:
        s = np.concatenate([s, np.zeros(jac.shape[1] - s.shape[0])])
    spread = (d @ vt.T).std(axis=0)
    return s, spread


def _spearman(a, b):  # scipy-free (scipy may not be in the image)
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def _usable_jacobian(rec: EnsembleRecord, jacobian):
    if jacobian is not None and not rec.params:
        # An aborted run may have no stacked-params artifact
        # (ensemble_params.npz); skip the spread panel rather than KeyError.
        print("ensemble_view: no ensemble_params.npz in the run dir — "
              "skipping the spread-vs-spectrum panel", file=sys.stderr)
        return None
    return jacobian


def ensemble_summary(rec: EnsembleRecord, jacobian=None) -> dict:
    """The figure's numbers: the member count, the rank correlation of the
    members' spread with the identifiability spectrum and its two ends
    (with a Jacobian), and the recorded across-member std."""
    summary = {"n_members": rec.n_members}
    jacobian = _usable_jacobian(rec, jacobian)
    if jacobian is not None:
        s, spread = spread_vs_spectrum(rec, jacobian)
        rho = _spearman(np.log(s + 1e-300), np.log(spread + 1e-9))
        summary["spread_spectrum_spearman"] = float(rho)
        summary["spread_strongest3"] = float(spread[:3].mean())
        summary["spread_flattest3"] = float(spread[-3:].mean())
    if rec.summary:
        summary["param_std"] = rec.summary.get("std")
    return summary


def plot_ensemble(rec: EnsembleRecord, out_path, jacobian=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    K = rec.n_members
    jacobian = _usable_jacobian(rec, jacobian)
    summary = ensemble_summary(rec, jacobian)
    ncols = 3
    nrows = 2 + (1 if jacobian is not None else 0)
    fig, axes = plt.subplots(nrows, ncols, figsize=(15, 4 * nrows),
                             squeeze=False)

    for j, name in enumerate("JDS"):
        ax = axes[0][j]
        for m in range(K):
            traj = rec.member_trajectory(m, name)
            steps = rec.member_steps(m)
            for a in range(2):
                for b in range(2):
                    ax.plot(steps, traj[:, a, b], lw=0.7, alpha=0.7,
                            color=f"C{2 * a + b}")
        pops = ("E", "I")
        for a in range(2):
            for b in range(2):
                ax.plot([], [], color=f"C{2 * a + b}",
                        label=f"{name}_{pops[a]}{pops[b]}")
        ax.set_title(f"{name} trajectories ({K} members)")
        ax.legend(fontsize=7)

    # Metric columns differ per estimator family: the WGAN ensemble logs
    # (d_loss, d_accuracy, ...), the moment-matching ensemble logs
    # (loss, mean_err, cov_err, ...) — pick the first three present.
    metric_cols = [c for c in ("d_loss", "d_accuracy", "loss", "mean_err",
                               "cov_err", "frac_converged")
                   if c in rec.table][:ncols]
    for j, col in enumerate(metric_cols):
        ax = axes[1][j]
        for m in range(K):
            mask = rec.member_mask(m)
            ax.plot(rec.table["step"][mask], rec.table[col][mask], lw=0.7,
                    alpha=0.7)
        ax.set_title(col)
    for j in range(len(metric_cols), ncols):
        axes[1][j].axis("off")

    if jacobian is not None:
        s, spread = spread_vs_spectrum(rec, jacobian)
        ax = axes[2][0]
        ax.loglog(s, spread, "o")
        ax.set_xlabel("singular value (identifiability)")
        ax.set_ylabel("member spread (log-param std)")
        ax.set_title("seed spread vs identifiability")
        ax.text(0.05, 0.05,
                f"Spearman rho = {summary['spread_spectrum_spearman']:.2f}",
                transform=ax.transAxes)
        axes[2][1].axis("off")
        axes[2][2].axis("off")

    fig.suptitle(f"ensemble — {rec.path}")
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return summary


def make_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rundir")
    p.add_argument("-o", "--out", default=None,
                   help="output PNG (default RUNDIR/ensemble.png)")
    p.add_argument("--jacobian", default=None,
                   help="moment-Jacobian .npz for the spread-vs-spectrum "
                        "panel")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rec = load_ensemble(args.rundir)
    out = args.out or str(rec.path / "ensemble.png")
    jac = np.load(args.jacobian)["jacobian"] if args.jacobian else None
    if have_matplotlib():
        summary = plot_ensemble(rec, out, jacobian=jac)
    else:
        summary = ensemble_summary(rec, jacobian=jac)
        out = PLOTS_SKIPPED
    print(json.dumps({"run": str(rec.path), "plot": out, **summary}))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
