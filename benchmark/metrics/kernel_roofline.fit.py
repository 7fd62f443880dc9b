"""The solver kernel's share of its roofline in a fit cell, %: the least time
of every solve of the profiled steps over the kernel's device time."""


def read(t):
    if t["kind"] != "fit" or t["slice"]["kernel_s"] <= 0:
        return None
    return 100.0 * t["least_s"] / t["slice"]["kernel_s"]
