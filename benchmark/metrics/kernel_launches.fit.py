"""The program's ``ssn_solve.launches`` counter per profiled step."""


def read(t):
    if t["kind"] != "fit":
        return None
    return t["counters"]["launches"] / t["steps"]
