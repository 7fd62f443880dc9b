"""The reader of ``adjoint_roofline.fit`` on synthetic summaries: the least
time of the counted adjoints over the device time under ``ift.adjoint``,
and nothing where there is nothing to read."""

import pytest

from benchmark import count, harness, record

READ = harness.reader("adjoint_roofline.fit")


def _fit(span_s):
    return {"kind": "fit", "steps": 3,
            "slice": {"span_s": {"ift.adjoint": span_s}}}


def test_least_time_over_the_span(monkeypatch):
    """Three adjoints at 2N=402 (256 circuits of 16 rows each) and one at
    2N=102 (4 circuits): operations at the TF32 peak against W's bytes at
    the HBM peak, over the span's device time."""
    monkeypatch.setattr(record, "counters", lambda: {
        "ift.adjoint_rows.402": 3 * 4096, "ift.adjoint_circuits.402": 768,
        "ift.adjoint_rows.102": 64, "ift.adjoint_circuits.102": 4,
        "ift.adjoint_kernel_launches": 4, "host_syncs.ift.stop_test": 4})
    ops = (12288 * (2 / 3 * 402 ** 3 + 6 * 402 ** 2)
           + 64 * (2 / 3 * 102 ** 3 + 6 * 102 ** 2))
    nbytes = 4.0 * (768 * 402 ** 2 + 4 * 102 ** 2)
    least = max(ops / 495e12, nbytes / 3.35e12)
    assert least == pytest.approx(ops / 495e12)
    assert least == pytest.approx(count.least_seconds(ops, nbytes))
    assert READ(_fit(0.09)) == pytest.approx(100.0 * least / 0.09)


def test_bytes_set_the_bound_where_they_outweigh_the_work(monkeypatch):
    monkeypatch.setattr(record, "counters", lambda: {
        "ift.adjoint_rows.8": 1, "ift.adjoint_circuits.8": 10 ** 6})
    least = 4.0 * 10 ** 6 * 64 / 3.35e12
    assert READ(_fit(1e-3)) == pytest.approx(100.0 * least / 1e-3)


def test_nothing_to_read(monkeypatch):
    """None for a forward summary, for a run whose program kept no such
    counters (an earlier program), and where no device time fell under the
    span."""
    monkeypatch.setattr(record, "counters", lambda: {
        "ift.adjoint_rows.402": 4096, "ift.adjoint_circuits.402": 256})
    assert READ({"kind": "forward", "batches": 2}) is None
    assert READ(_fit(0.0)) is None
    monkeypatch.setattr(record, "counters", lambda: {
        "ift.adjoint_kernel_launches": 3, "host_syncs.ift.stop_test": 3})
    assert READ(_fit(0.05)) is None
    monkeypatch.setattr(record, "counters", lambda: {})
    assert READ(_fit(0.05)) is None
