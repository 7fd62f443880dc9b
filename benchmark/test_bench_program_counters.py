"""The readers of the program's own record (``record.py``) on the CPU at
tiny sizes: a traced run of each kind gives each of them a finite number,
and two traced runs in one process read the same counts.

The CPU has no device activity for ``trace.summarize`` to read, so these
runs take an empty device summary in its place; the record is the
program's, as on the card."""

import math

import pytest
import torch

from benchmark import forward, harness, record, tiny
from benchmark.run import measure

CPU = torch.device("cpu")
READERS = {"n51_forward": ("host_syncs.forward", "sync_wait_ms.forward",
                           "kernel_substeps.forward",
                           "phase2_share.forward"),
           "n51_gan_round2": ("host_syncs.fit", "sync_wait_ms.fit")}
COUNTS = ("host_syncs.forward", "kernel_substeps.forward",
          "phase2_share.forward", "host_syncs.fit")


@pytest.fixture
def no_device_summary(monkeypatch):
    def summarize(prof, spans=()):
        return {"wall_s": 1.0, "busy_s": 0.0, "kernel_s": 0.0,
                "other_device_s": 0.0, "span_s": {s: 0.0 for s in spans},
                "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(forward.trace, "summarize", summarize)


@pytest.mark.parametrize("name", sorted(READERS))
def test_traced_runs_read_the_record(name, no_device_summary):
    cell = tiny.cell(name)
    lines = [measure(cell, 21, 0.2, True, CPU)[0]["metrics"]
             for _ in range(2)]
    for metrics in lines:
        for m in READERS[name]:
            assert math.isfinite(metrics[m]["value"]), m
    for m in set(READERS[name]) & set(COUNTS):
        assert lines[0][m] == lines[1][m], m
    if name == "n51_forward":
        # the battery's two copies a batch
        assert lines[0]["host_syncs.forward"]["value"] == 2.0


def test_no_record_reads_nothing(monkeypatch):
    """A program without the record leaves the new metrics out."""
    monkeypatch.setattr(record, "counters", lambda: {})
    t = {"kind": "forward", "batches": 2, "steps": 1}
    for names in READERS.values():
        for m in names:
            assert harness.reader(m)(t | {"kind": "fit"} if m.endswith(
                ".fit") else t) is None
