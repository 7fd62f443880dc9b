"""Every file that BENCHMARK.json names loads by name, and the file keeps
the contract's shapes: names, units, bounds and the cells' metrics."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = harness.Cell(name)
    assert cell.config["circuit"]["N"] > 0
    assert cell.traffic["kind"] in ("forward", "fit")
    assert cell.limits, f"limits/{name}.json is missing or empty"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_reader_loads(metric):
    assert callable(harness.reader(metric))


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
