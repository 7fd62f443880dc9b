"""Blocking host syncs per profiled forward batch: the program's
``host_syncs.<site>`` counters, summed (:mod:`benchmark.record`)."""

from benchmark import record


def read(t):
    c = record.counters() if t["kind"] == "forward" else {}
    if not c:
        return None
    return record.total(c, "host_syncs.") / t["batches"]
