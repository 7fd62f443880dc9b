"""One-command markdown report for a run datastore.

The port's own copy of :mod:`tcgan_tpu.analysis.report`, with the same
flags and the same markdown (naming this module as its generator).

Reference parity: the reference has no single-report analyzer — its users
stitch together ``tc_gan/analyzers/`` calls by hand (SURVEY.md §2
"Analyzers / loaders"). This module is the capstone over the same streams
(learning.csv, generator.csv, info.json, optional eval JSON): one command
produces a self-contained markdown summary a user can paste into a lab
notebook or attach to a results thread.

Usage:
    python -m tcgan_torch.analysis.report RUNDIR [-o report.md]
        [--eval-json FILE]

Sections: run identity + config highlights, parameter recovery vs the
run's own fake-truth (info.json ``true_J/D/S``), training health
(losses, convergence, solver iterations, step timing), optional eval
metrics (the JSON printed by ``tcgan_torch.run.eval``), and an artifact
inventory. Everything is host-side numpy — safe to run while a chip job
is training (it only reads the append-only streams).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from tcgan_torch.analysis.fit_quality import true_params_from_info
from tcgan_torch.analysis.loaders import (
    EnsembleRecord, RunRecord, load_ensemble, load_run,
)
from tcgan_torch.analysis.metrics import param_recovery_error

_POPS = ("E", "I")


def _fmt(v, nd=4) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if not np.isfinite(f):
        return "nan"
    return f"{f:.{nd}g}"


def _tail_mean(arr: np.ndarray, frac: float = 0.1) -> float:
    """Mean of the last ``frac`` of a stream (NaN-safe, empty-safe)."""
    arr = np.asarray(arr, dtype=np.float64)
    if arr.size == 0:
        return float("nan")
    tail = arr[-max(1, int(arr.size * frac)):]
    return float(np.nanmean(tail)) if np.isfinite(tail).any() else float("nan")


def _config_highlights(cfg: dict) -> Dict[str, str]:
    """The knobs a reader needs to interpret the run, in display order."""
    keys = [
        "entry", "solver", "solver_backend", "N", "batch_size", "n_steps",
        "contrasts", "bandwidths", "sample_sites", "io_type",
        "include_inhibitory_neurons", "track_offset_identity", "antithetic",
        "disc_layers", "n_critic", "gp_lambda", "lr_gen", "lr_critic",
        "normalize_input", "normalize_input_mode", "reject_unconverged",
        "rate_cost", "moment_anchor", "anchor_ema", "gen_ema",
        "mm_lr", "moment_ema", "max_iter", "atol", "adaptive_max_iter",
        "dataset", "truth_samples", "seed",
    ]
    out = {}
    for k in keys:
        if k in cfg and cfg[k] is not None:
            out[k] = str(cfg[k])
    return out


def _recovery_section(rec: RunRecord, true_params) -> str:
    if not rec.generator:
        return "No generator.csv — parameter table unavailable.\n"
    fitted = rec.final_gen_params()
    lines = []
    if true_params is not None:
        err = param_recovery_error(fitted, true_params)
        lines.append("| param | fitted | true | rel. error |")
        lines.append("|---|---|---|---|")
        for name in "JDS":
            f, t = fitted[name], true_params[name]
            for a in range(2):
                for b in range(2):
                    rel = abs(f[a, b] / t[a, b] - 1.0) if t[a, b] else np.nan
                    lines.append(
                        f"| {name}_{_POPS[a]}{_POPS[b]} | {_fmt(f[a, b])} "
                        f"| {_fmt(t[a, b])} | {rel * 100:.1f}% |")
            lines.append(
                f"| **{name} (Frobenius)** | | | **{err[name] * 100:.1f}%** |")
        worst = max(err.values())
        verdict = ("**recovered** (all blocks ≤ 10%)" if worst <= 0.10
                   else "**not recovered** (worst block "
                        f"{worst * 100:.1f}% > 10%)")
        lines.append("")
        lines.append(f"Recovery verdict at the 10% gate: {verdict}.")
    else:
        lines.append("| param | fitted |")
        lines.append("|---|---|")
        for name in "JDS":
            f = fitted[name]
            for a in range(2):
                for b in range(2):
                    lines.append(
                        f"| {name}_{_POPS[a]}{_POPS[b]} | {_fmt(f[a, b])} |")
        lines.append("")
        lines.append("No ground truth in info.json (real-data run) — "
                     "errors not computable.")
    return "\n".join(lines) + "\n"


def _health_section(rec: RunRecord) -> str:
    lrn = rec.learning
    if not lrn:
        return "No learning.csv — training-health table unavailable.\n"
    steps = rec.steps
    rows = []

    def row(label, col, nd=4):
        if col in lrn and np.isfinite(lrn[col]).any():
            first = _tail_mean(lrn[col][: max(1, len(lrn[col]) // 10)], 1.0)
            last = _tail_mean(lrn[col])
            rows.append(f"| {label} | {_fmt(first, nd)} | {_fmt(last, nd)} |")

    row("critic loss (d_loss)", "d_loss")
    row("Wasserstein estimate", "wasserstein")
    row("moment loss", "loss")
    row("gradient penalty", "gp")
    row("rate penalty", "rate_penalty")
    row("critic rank accuracy", "d_accuracy", 3)
    row("frac converged", "frac_converged", 3)
    row("frac diverged", "frac_diverged", 3)
    row("mean solver iters", "mean_iters", 5)
    row("step time (s)", "train_time", 3)
    header = (f"Steps recorded: **{int(steps[-1]) if steps.size else 0}** "
              f"({steps.size} rows).")
    if "train_time" in lrn and np.isfinite(lrn["train_time"]).any():
        total = float(np.nansum(lrn["train_time"]))
        header += f" Total recorded step time: {total / 3600:.2f} h."
    table = ("| metric | first 10% | last 10% |\n|---|---|---|\n"
             + "\n".join(rows)) if rows else "(no finite metric columns)"
    return header + "\n\n" + table + "\n"


def _eval_section(eval_json: Optional[Path]) -> str:
    if eval_json is None:
        return ""
    try:
        payload = json.loads(Path(eval_json).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return f"\n## Eval\n\nCould not read eval JSON ({e}).\n"
    lines = ["", "## Eval", "", "| metric | value |", "|---|---|"]
    for k, v in payload.items():
        lines.append(f"| {k} | {_fmt(v, 5)} |")
    return "\n".join(lines) + "\n"


def render_report(rec: RunRecord, eval_json: Optional[Path] = None) -> str:
    cfg = rec.info.get("config", {})
    true_params = true_params_from_info(rec.info)
    hl = _config_highlights(cfg)
    parts = [
        f"# Run report: `{rec.path}`",
        "",
        f"Entry: **{cfg.get('entry', '?')}** · solver: "
        f"{cfg.get('solver', '?')}/{cfg.get('solver_backend', '?')} · "
        f"generated by `tcgan_torch.analysis.report`.",
        "",
        "## Config highlights",
        "",
        "| knob | value |",
        "|---|---|",
        *[f"| {k} | {v} |" for k, v in hl.items()],
        "",
        "## Parameter recovery",
        "",
        _recovery_section(rec, true_params),
        "## Training health",
        "",
        _health_section(rec),
        _eval_section(eval_json),
        "## Artifacts",
        "",
        *[f"- `{p.name}` ({p.stat().st_size:,} B)"
          for p in sorted(rec.path.iterdir()) if p.is_file()],
        "",
    ]
    return "\n".join(parts)


def render_ensemble_report(rec: EnsembleRecord) -> str:
    """Markdown report for a multi-start ensemble datastore
    (tcgan_torch.run.ensemble): per-member endpoints + recovery errors and
    the across-member spread — the multi-start consistency check that
    ``ensemble_view`` plots, as a table."""
    cfg = rec.info.get("config", {})
    hl = _config_highlights(cfg)
    lines = [
        f"# Ensemble report: `{rec.path}`",
        "",
        f"Estimator: **{cfg.get('estimator', cfg.get('entry', '?'))}** · "
        f"{rec.n_members} members · generated by "
        "`tcgan_torch.analysis.report`.",
        "",
        "## Config highlights",
        "",
        "| knob | value |",
        "|---|---|",
        *[f"| {k} | {v} |" for k, v in hl.items()],
        "",
        "## Members",
        "",
    ]
    members = rec.summary.get("members", [])
    if members:
        # ANY member may lack recovery_error (e.g. it aborted mid-write);
        # degrade that ROW to em-dashes instead of raising KeyError on
        # the whole report (ADVICE r3 #4)
        has_err = any("recovery_error" in m for m in members)
        head = "| member | steps |" + (
            " J err | D err | S err | worst |" if has_err else "")
        lines += [head, "|---|---|" + ("---|" * 4 if has_err else "")]
        for m, row in enumerate(members):
            steps = rec.member_steps(m)
            cells = [str(m), str(int(steps[-1]) if steps.size else 0)]
            if has_err:
                err = row.get("recovery_error")
                if err:
                    worst = max(err.values())
                    cells += [f"{err[k] * 100:.1f}%" for k in "JDS"]
                    cells += [f"**{worst * 100:.1f}%**"]
                else:
                    cells += ["—"] * 4
            lines.append("| " + " | ".join(cells) + " |")
        if has_err:
            worsts = [max(r["recovery_error"].values()) for r in members
                      if r.get("recovery_error")]
            n_ok = sum(w <= 0.10 for w in worsts)
            lines += ["", f"Members recovered at the 10% gate: "
                          f"**{n_ok}/{len(members)}** "
                          f"(median worst-block error "
                          f"{np.median(worsts) * 100:.1f}%)."]
    else:
        lines.append("No ensemble_summary.json — member table unavailable "
                     "(aborted run?); see ensemble.csv for trajectories.")
    std = rec.summary.get("std")
    if std:
        lines += ["", "## Across-member spread (seed std)", "",
                  "| block | std (2x2, row-major) |", "|---|---|"]
        for k in "JDS":
            flat = np.asarray(std[k]).ravel()
            lines.append(
                f"| {k} | {', '.join(_fmt(v, 3) for v in flat)} |")
        lines += ["", "Spread maps the identifiability spectrum's flat "
                      "subspace, not noise — compare with "
                      "`analysis.ensemble_view --jacobian` "
                      "(BASELINE.md, ens_ridge)."]
    lines += ["", "## Artifacts", "",
              *[f"- `{p.name}` ({p.stat().st_size:,} B)"
                for p in sorted(rec.path.iterdir()) if p.is_file()], ""]
    return "\n".join(lines)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tcgan_torch.analysis.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run", help="run datastore directory")
    p.add_argument("-o", "--out", default=None,
                   help="output markdown path (default: <run>/report.md)")
    p.add_argument("--eval-json", default=None,
                   help="JSON file printed by tcgan_torch.run.eval to embed")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    run_dir = Path(args.run)
    if not run_dir.is_dir():
        print(f"report: no such run directory: {run_dir}", file=sys.stderr)
        return 2
    if (run_dir / "ensemble.csv").exists():
        text = render_ensemble_report(load_ensemble(run_dir))
    else:
        text = render_report(
            load_run(run_dir),
            Path(args.eval_json) if args.eval_json else None)
    out = Path(args.out) if args.out else run_dir / "report.md"
    out.write_text(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
