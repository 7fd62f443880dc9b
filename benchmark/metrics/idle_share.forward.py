"""Share of the profiled slice of forward batches in which no device
activity ran, %."""


def read(t):
    if t["kind"] != "forward":
        return None
    s = t["slice"]
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
