"""What the benchmark finds by name: the cell's entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and the
reader of each per-layer metric (``metrics/<metric>.py``); and the result
line every run prints.

A later change adds a configuration, a mix, a cell or a per-layer metric by
adding files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tcgan_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(by_name)}")
        self.name = name
        self.entry = by_name[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = HERE / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def reader(metric: str):
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}}):
    the compared numbers are those ``limits`` names; one the run did not
    read, or that is not a finite number, fails. With no limits nothing
    is correct."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        ok = ok and value == value and value != float("inf") \
            and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def metrics_line(cell: Cell, e2e: dict | None, trace: dict | None) -> dict:
    """The ``metrics`` of the result: the cell's end-to-end metrics from
    ``e2e`` (an untraced run), or its per-layer metrics read from ``trace``
    (a traced run); a reader that finds nothing leaves its metric out."""
    out = {}
    if trace is None:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"the run measured no {m['name']}")
            out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def report(line: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
