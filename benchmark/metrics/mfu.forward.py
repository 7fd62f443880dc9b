"""The whole batch's share of the card's TF32 peak, %: the solves'
operations (the reference's substeps on the profiled inputs) over the
profiled slice's wall time at 495 TFLOP/s."""

from benchmark.count import PEAK_TF32_FLOPS


def read(t):
    if t["kind"] != "forward":
        return None
    return 100.0 * t["ops"] / t["slice"]["wall_s"] / PEAK_TF32_FLOPS
