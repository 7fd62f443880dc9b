"""Share of the solver kernel's substeps in the profiled forward batches
that ran in phase 2, the full-precision phase, %: the kernel's own device
totals (:mod:`benchmark.record`)."""

from benchmark import record


def read(t):
    c = record.counters() if t["kind"] == "forward" else {}
    p1 = c.get("ssn_solve.phase1_substeps", 0)
    p2 = c.get("ssn_solve.phase2_substeps", 0)
    if p1 + p2 <= 0:
        return None
    return 100.0 * p2 / (p1 + p2)
