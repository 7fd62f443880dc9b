"""The solver kernel's share of its roofline in a forward cell, %: the least
time of the profiled batches' solves (:mod:`benchmark.count`, from the
reference's substeps on the same inputs) over the kernel's device time."""


def read(t):
    if t["kind"] != "forward" or t["slice"]["kernel_s"] <= 0:
        return None
    return 100.0 * t["least_s"] / t["slice"]["kernel_s"]
