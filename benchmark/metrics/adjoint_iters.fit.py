"""The program's ``ift.adjoint_iterations`` counter per profiled step."""


def read(t):
    if t["kind"] != "fit":
        return None
    return t["counters"]["adjoint_iterations"] / t["steps"]
