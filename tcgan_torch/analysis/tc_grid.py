"""Per-condition tuning-curve distribution comparison (paper-style grid).

Reference parity: the TC-distribution comparison analyzer of
``tc_gan/analyzers/`` (SURVEY.md §2 "Analyzers / loaders") — the
fit-quality figure of the paper compares the *distribution* of generated
tuning curves against the data per stimulus condition, not just the mean.

Each panel is one stimulus condition (bandwidth x contrast): the marginal
distribution of the probe readout under that condition, generated vs data,
annotated with the per-condition Wasserstein-1 distance.

The port's own copy of :mod:`tcgan_tpu.analysis.tc_grid`; matplotlib is
imported only inside :func:`plot_tc_grid`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from tcgan_torch.analysis.metrics import w1_per_feature


def per_condition_w1(gen_tc: np.ndarray, data_tc: np.ndarray) -> np.ndarray:
    """(D,) per-condition W1 between generated and data samples (n, D)."""
    return w1_per_feature(gen_tc, data_tc)


def plot_tc_grid(
    gen_tc: np.ndarray,
    data_tc: np.ndarray,
    cond_labels: Sequence[Tuple[float, float]] | None,
    out_path,
    max_panels: int = 32,
    bins: int = 30,
):
    """Histogram grid: one panel per tuning-curve feature (= stimulus
    condition for sample_sites=1), generated vs data, per-panel W1.

    cond_labels: (bandwidth, contrast) per feature, or None for bare
    feature indices (e.g. when track_offset_identity concatenates sites).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gen_tc = np.asarray(gen_tc)
    data_tc = np.asarray(data_tc)
    D = data_tc.shape[1]
    w1s = per_condition_w1(gen_tc, data_tc)
    n_show = min(D, max_panels)
    ncols = min(8, n_show)
    nrows = (n_show + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(2.2 * ncols, 1.9 * nrows),
                             squeeze=False)
    for f in range(n_show):
        ax = axes[f // ncols][f % ncols]
        lo = min(data_tc[:, f].min(), gen_tc[:, f].min())
        hi = max(data_tc[:, f].max(), gen_tc[:, f].max())
        edges = np.linspace(lo, hi if hi > lo else lo + 1e-6, bins + 1)
        ax.hist(data_tc[:, f], bins=edges, alpha=0.55, density=True,
                color="C0")
        ax.hist(gen_tc[:, f], bins=edges, alpha=0.55, density=True,
                color="C1")
        if cond_labels is not None and f < len(cond_labels):
            bw, c = cond_labels[f]
            title = f"bw={bw:g} c={c:g}"
        else:
            title = f"feature {f}"
        ax.set_title(f"{title}\nW1={w1s[f]:.3g}", fontsize=7)
        ax.tick_params(labelsize=6)
        ax.set_yticks([])
    for f in range(n_show, nrows * ncols):
        axes[f // ncols][f % ncols].axis("off")
    fig.legend(["data", "generated"], loc="lower right", fontsize=8)
    fig.suptitle(
        f"per-condition TC marginals (mean W1 = {w1s.mean():.4g};"
        f" showing {n_show}/{D})",
        fontsize=10,
    )
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return w1s
