"""Recorder streams: append-only CSV/JSONL metric files in the datastore.

Port of :mod:`tcgan_tpu.train.recorders`, byte-compatible with it: the same
files, headers, column order and number formatting, so
``tcgan_tpu.analysis`` reads a port run unchanged.

- ``learning.csv``         per-step GAN stats;
- ``generator.csv``        per-step flattened generator params (J/D/S);
- ``disc_param_stats.csv`` per-step critic parameter norms;
- ``disc_learning.csv``    one row per critic iteration;
- ``tc_mean.jsonl``        periodic mean generated tuning curve;
- ``learning.jsonl``       JSONL mirror of learning.csv.

Values arrive as host scalars or arrays (the driver copies everything a
step records to the host at once). Under a mesh of several ranks only rank
0's recorders touch their files.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence

import numpy as np

from tcgan_torch.parallel.mesh import is_writer
from tcgan_torch.train.datastore import DataStore


def _scalar(v: Any) -> Any:
    arr = np.asarray(v)
    if arr.ndim == 0:
        item = arr.item()
        return float(item) if isinstance(item, (float, np.floating)) else item
    return arr.tolist()


class CSVRecorder:
    """Append-only CSV with a fixed column schema (header written once)."""

    def __init__(self, path: Path, columns: Sequence[str]):
        self.path = Path(path)
        self.columns = list(columns)
        self.enabled = is_writer()
        if not self.enabled:
            return
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if self.path.stat().st_size == 0:
            self._writer.writerow(self.columns)
            self._fh.flush()

    def record(self, row: Dict[str, Any]):
        if not self.enabled:
            return
        self._writer.writerow([_scalar(row.get(c, "")) for c in self.columns])
        self._fh.flush()

    def truncate_from(self, step: int):
        """Drop rows with step >= ``step`` (resume: checkpoints are
        periodic, the streams are flushed every step)."""
        if "step" not in self.columns or not self.enabled:
            return
        idx = self.columns.index("step")
        self._fh.close()
        with open(self.path, newline="") as f:
            rows = list(csv.reader(f))
        kept = rows[:1] + [r for r in rows[1:] if r and float(r[idx]) < step]
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerows(kept)
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)

    def close(self):
        if self.enabled:
            self._fh.close()


class JSONLRecorder:
    """Append-only JSONL stream (schemaless companion to the CSVs)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.enabled = is_writer()
        if self.enabled:
            self._fh = open(path, "a")

    def record(self, row: Dict[str, Any]):
        if not self.enabled:
            return
        self._fh.write(json.dumps({k: _scalar(v) for k, v in row.items()})
                       + "\n")
        self._fh.flush()

    def truncate_from(self, step: int):
        """Drop rows with step >= ``step`` (see CSVRecorder.truncate_from);
        lines that do not parse are kept."""
        if not self.enabled:
            return
        self._fh.close()
        kept = []
        with open(self.path) as f:
            for line in f:
                try:
                    if json.loads(line).get("step", -1) >= step:
                        continue
                except (ValueError, AttributeError, TypeError):
                    pass
                kept.append(line)
        with open(self.path, "w") as f:
            f.writelines(kept)
        self._fh = open(self.path, "a")

    def close(self):
        if self.enabled:
            self._fh.close()


LEARNING_COLUMNS = [
    "step", "d_loss", "g_loss", "wasserstein", "gp", "rate_penalty",
    "d_accuracy", "frac_converged", "frac_diverged", "mean_iters",
    "train_time", "SSsolve_time", "gradient_time",
]


def flatten_gen_params(values) -> Dict[str, float]:
    """Flatten (J, D, S) 2x2 blocks to row-major columns (J_EE, J_EI,
    J_IE, J_II, D_..., S_...)."""
    pops = ("E", "I")
    out: Dict[str, float] = {}
    for name, mat in zip(("J", "D", "S"), values):
        m = np.asarray(mat)
        for a in range(2):
            for b in range(2):
                out[f"{name}_{pops[a]}{pops[b]}"] = float(m[a, b])
    return out


GEN_COLUMNS = ["step"] + [
    f"{n}_{a}{b}" for n in ("J", "D", "S") for a in ("E", "I")
    for b in ("E", "I")
]


class RecorderSet:
    """The standard bundle of streams for a GAN run."""

    def __init__(self, store: DataStore,
                 critic_param_names: Iterable[str] = (), jsonl: bool = True):
        self.learning = CSVRecorder(store.file("learning.csv"),
                                    LEARNING_COLUMNS)
        self.generator = CSVRecorder(store.file("generator.csv"), GEN_COLUMNS)
        disc_cols = ["step"] + [f"{k}.{s}" for k in critic_param_names
                                for s in ("nnorm", "absmax")]
        self.disc_stats = CSVRecorder(store.file("disc_param_stats.csv"),
                                      disc_cols)
        self.disc_learning = CSVRecorder(
            store.file("disc_learning.csv"),
            ["step", "critic_iter", "d_loss", "wasserstein", "gp",
             "accuracy"])
        self.tc_mean = JSONLRecorder(store.file("tc_mean.jsonl"))
        self.jsonl = (JSONLRecorder(store.file("learning.jsonl"))
                      if jsonl else None)

    def record_learning(self, row: Dict[str, Any]):
        self.learning.record(row)
        if self.jsonl:
            self.jsonl.record(row)

    def record_generator(self, step: int, values):
        row = {"step": step}
        row.update(flatten_gen_params(values))
        self.generator.record(row)

    def record_disc_stats(self, step: int, stats: Dict[str, Any]):
        row = {"step": step}
        row.update({k: _scalar(v) for k, v in stats.items()})
        self.disc_stats.record(row)

    def record_disc_learning(self, step: int, d_loss, wasserstein, gp, acc):
        """One row per critic iteration of this step."""
        d_loss, wasserstein, gp, acc = (np.asarray(a) for a in
                                        (d_loss, wasserstein, gp, acc))
        for i in range(d_loss.shape[0]):
            self.disc_learning.record({
                "step": step, "critic_iter": i,
                "d_loss": float(d_loss[i]),
                "wasserstein": float(wasserstein[i]),
                "gp": float(gp[i]), "accuracy": float(acc[i]),
            })

    def record_tc_mean(self, step: int, tc_mean) -> None:
        self.tc_mean.record({"step": step,
                             "tc_mean": np.asarray(tc_mean).tolist()})

    def truncate_from(self, step: int):
        """Resume support: drop every stream's rows at/after ``step``."""
        for rec in self._streams():
            rec.truncate_from(step)

    def close(self):
        for rec in self._streams():
            rec.close()

    def _streams(self):
        recs = [self.learning, self.generator, self.disc_stats,
                self.disc_learning, self.tc_mean]
        return recs + ([self.jsonl] if self.jsonl else [])
