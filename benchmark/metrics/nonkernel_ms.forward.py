"""Device time per forward batch outside the solver kernel, ms: the
generator's W build, battery and readout."""


def read(t):
    if t["kind"] != "forward":
        return None
    return 1e3 * t["slice"]["other_device_s"] / t["batches"]
