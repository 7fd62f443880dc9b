"""Substeps the solver kernel ran per row in the profiled forward batches,
both phases: the kernel's own device totals over the rows it solved,
``ssn_solve.rows`` (the batches x B x S; :mod:`benchmark.record`)."""

from benchmark import record


def read(t):
    c = record.counters() if t["kind"] == "forward" else {}
    if not c.get("ssn_solve.rows"):
        return None
    return (c["ssn_solve.phase1_substeps"] + c["ssn_solve.phase2_substeps"]
            ) / c["ssn_solve.rows"]
