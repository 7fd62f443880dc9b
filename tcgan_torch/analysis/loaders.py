"""Load a run datastore directory into a structured record.

The port's own copy of :mod:`tcgan_tpu.analysis.loaders` (NumPy only); it
reads the run directories of both packages, whose streams are the same.

Reference parity: ``tc_gan/loaders.py::load(...)`` (SURVEY.md §2
"Analyzers / loaders") — consumes the recorder streams written by
tcgan_torch.train (learning.csv, generator.csv, disc_param_stats.csv,
tc_mean.jsonl, info.json).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import sys
import warnings
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def _read_csv(path: Path) -> Dict[str, np.ndarray]:
    if not path.exists():
        return {}
    with open(path) as fh:
        reader = csv.DictReader(fh)
        rows = list(reader)
    if not rows:
        return {}
    out: Dict[str, np.ndarray] = {}
    for col in rows[0].keys():
        vals = []
        for r in rows:
            v = r.get(col, "")
            try:
                vals.append(float(v))
            except (TypeError, ValueError):
                vals.append(np.nan)
        out[col] = np.asarray(vals)
    return out


def _read_jsonl(path: Path) -> List[dict]:
    """Parse a JSONL stream, SKIPPING torn lines.

    A process killed mid-write (preemption, watchdog hang-kill) leaves a
    truncated final line, and a resume-truncation racing a concurrent
    writer can tear a line mid-file (observed 2026-08-19, see
    docs/artifacts/rec13anchor4_incident_0731.md) — neither should make
    every later analysis of the run crash.
    """
    if not path.exists():
        return []
    out, torn, first_bad = [], 0, None
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                torn += 1
                if first_bad is None:
                    first_bad = lineno
    if torn:
        # stderr unconditionally, not only warnings.warn: warnings are
        # deduplicated per call site and routinely filtered in batch
        # pipelines, so widespread corruption (beyond the single torn
        # tail) could pass silently into analyses (ADVICE r4 #4).
        msg = (f"{path}: skipped {torn} unparseable JSONL line(s), first "
               f"at line {first_bad} (torn write from a kill/preemption?)")
        print(msg, file=sys.stderr)
        warnings.warn(msg)
    return out


@dataclasses.dataclass
class RunRecord:
    """A loaded run directory."""

    path: Path
    info: Dict[str, Any]
    learning: Dict[str, np.ndarray]
    generator: Dict[str, np.ndarray]
    disc_stats: Dict[str, np.ndarray]
    tc_mean: List[dict]

    @property
    def steps(self) -> np.ndarray:
        return self.learning.get("step", np.array([]))

    def gen_param_trajectory(self, name: str) -> np.ndarray:
        """(steps, 2, 2) trajectory of J / D / S."""
        pops = ("E", "I")
        cols = [[self.generator[f"{name}_{a}{b}"] for b in pops] for a in pops]
        return np.stack([np.stack(c, axis=-1) for c in cols], axis=-2)

    def final_gen_params(self) -> Dict[str, np.ndarray]:
        return {name: self.gen_param_trajectory(name)[-1] for name in "JDS"}


def load_run(path: str | Path) -> RunRecord:
    path = Path(path)
    info_file = path / "info.json"
    info = json.loads(info_file.read_text()) if info_file.exists() else {}
    return RunRecord(
        path=path,
        info=info,
        learning=_read_csv(path / "learning.csv"),
        generator=_read_csv(path / "generator.csv"),
        disc_stats=_read_csv(path / "disc_param_stats.csv"),
        tc_mean=_read_jsonl(path / "tc_mean.jsonl"),
    )


def fitted_params(run_dir: str | Path, source: str = "csv",
                  rec: RunRecord | None = None) -> Dict[str, np.ndarray]:
    """Endpoint generator params {"J","D","S"} (2x2, value space).

    ``source``: "csv" = final generator.csv row; "npz" = the
    disc_params.npz export; "npz_ema" = its EMA-averaged J_ema/D_ema/S_ema
    entries (requires a run trained with --gen-ema). One implementation
    shared by run.eval and analysis.uncertainty so the two always agree
    on what "the fit" is."""
    if source == "csv":
        if rec is None:
            rec = load_run(run_dir)
        return rec.final_gen_params()
    npz = np.load(Path(run_dir) / "disc_params.npz")
    suffix = "_ema" if source == "npz_ema" else ""
    missing = [f"{n}{suffix}" for n in "JDS"
               if f"{n}{suffix}" not in npz.files]
    if missing:
        raise SystemExit(
            f"disc_params.npz lacks {missing} — run with --gen-ema to "
            "export EMA params" if suffix else
            f"disc_params.npz lacks {missing}")
    return {n: np.asarray(npz[f"{n}{suffix}"]) for n in "JDS"}


@dataclasses.dataclass
class EnsembleRecord:
    """A loaded ensemble run directory (tcgan_torch.run.ensemble)."""

    path: Path
    info: Dict[str, Any]
    table: Dict[str, np.ndarray]  # ensemble.csv columns
    summary: Dict[str, Any]  # ensemble_summary.json (may be {})
    params: Dict[str, np.ndarray]  # ensemble_params.npz (member-stacked)

    @property
    def n_members(self) -> int:
        m = self.table.get("member")
        if m is None or not m.size:
            return 0
        # a torn/partial final row (live-monitoring a running ensemble)
        # parses as NaN; skip it rather than crash on int(NaN)
        m = m[np.isfinite(m)]
        return int(m.max()) + 1 if m.size else 0

    def member_mask(self, member: int) -> np.ndarray:
        return self.table["member"] == member

    def member_trajectory(self, member: int, name: str) -> np.ndarray:
        """(steps, 2, 2) trajectory of J / D / S for one member."""
        mask = self.member_mask(member)

        def col(a, b):  # E/I naming, with legacy digit-index fallback
            key = f"{name}_{'EI'[a]}{'EI'[b]}"
            if key not in self.table:
                key = f"{name}_{a}{b}"
            return self.table[key][mask]

        return np.stack(
            [np.stack([col(a, 0), col(a, 1)], axis=-1) for a in (0, 1)],
            axis=-2)

    def member_steps(self, member: int) -> np.ndarray:
        return self.table["step"][self.member_mask(member)]


def load_ensemble(path: str | Path) -> EnsembleRecord:
    path = Path(path)
    info_file = path / "info.json"
    summary_file = path / "ensemble_summary.json"
    params_file = path / "ensemble_params.npz"
    params = {}
    if params_file.exists():
        with np.load(params_file) as npz:
            params = {k: npz[k] for k in npz.files}
    return EnsembleRecord(
        path=path,
        info=json.loads(info_file.read_text()) if info_file.exists() else {},
        table=_read_csv(path / "ensemble.csv"),
        summary=(json.loads(summary_file.read_text())
                 if summary_file.exists() else {}),
        params=params,
    )
