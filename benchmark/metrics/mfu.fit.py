"""The whole step's share of the cards' TF32 peak, %: every forward solve
(the reference's substeps on the profiled inputs), the implicit backward
and the critic's work (from shapes), over the profiled steps' wall time
at 495 TFLOP/s."""

from benchmark.count import PEAK_TF32_FLOPS


def read(t):
    if t["kind"] != "fit":
        return None
    return 100.0 * t["ops"] / t["slice"]["wall_s"] / PEAK_TF32_FLOPS
