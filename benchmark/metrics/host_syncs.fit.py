"""Blocking host syncs per profiled fit step: the program's
``host_syncs.<site>`` counters, summed (:mod:`benchmark.record`)."""

from benchmark import record


def read(t):
    c = record.counters() if t["kind"] == "fit" else {}
    if not c:
        return None
    return record.total(c, "host_syncs.") / t["steps"]
