"""The implicit backward's share of its roofline in a fit cell, %: the least
time of the profiled steps' adjoints over the device time under the
program's ``ift.adjoint`` span. The least time is that of their least work
(``count.adjoint_ops``: a dense solve a row) at the TF32 peak, or of reading
each circuit's W once (float32) at the HBM peak, whichever is longer, from
the program's counters ``ift.adjoint_rows.<2N>`` and
``ift.adjoint_circuits.<2N>`` (:mod:`benchmark.record`). The same work
whatever implements the adjoint."""

from benchmark import count, record

ROWS = "ift.adjoint_rows."


def read(t):
    c = record.counters() if t["kind"] == "fit" else {}
    ops = nbytes = 0.0
    for name, rows in c.items():
        if name.startswith(ROWS):
            n2 = int(name[len(ROWS):])
            ops += count.adjoint_ops(rows, n2)
            nbytes += 4.0 * c.get(f"ift.adjoint_circuits.{n2}", 0) * n2 * n2
    span = t["slice"]["span_s"].get("ift.adjoint", 0.0) if ops else 0.0
    if span <= 0:
        return None
    return 100.0 * count.least_seconds(ops, nbytes) / span
