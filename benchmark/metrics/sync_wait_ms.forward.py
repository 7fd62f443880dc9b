"""Host time per profiled forward batch spent blocked in the program's host
syncs, ms: its ``sync_wait_ns.<site>`` counters, summed
(:mod:`benchmark.record`)."""

from benchmark import record


def read(t):
    c = record.counters() if t["kind"] == "forward" else {}
    if not c:
        return None
    return 1e-6 * record.total(c, "sync_wait_ns.") / t["batches"]
