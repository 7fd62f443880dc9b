"""Share of the profiled fit steps in which no device activity ran on the
card, %."""


def read(t):
    if t["kind"] != "fit":
        return None
    s = t["slice"]
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
