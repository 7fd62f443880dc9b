"""Device time per step of the kernels launched under the program's
``ift.adjoint`` span (the implicit backward), ms."""


def read(t):
    if t["kind"] != "fit":
        return None
    return 1e3 * t["slice"]["span_s"]["ift.adjoint"] / t["steps"]
