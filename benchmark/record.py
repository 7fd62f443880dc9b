"""The program's own record of the traced slice, for the per-layer readers
of ``metrics/``: the counters that ``tcgan_torch.utils.profiling`` kept
while the slice's profiler ran (host syncs and their wait, the solver's
rows and its substeps by phase). A program that keeps no such record, or
recorded nothing, gives ``{}``, and the readers then report nothing."""


def counters() -> dict:
    try:
        from tcgan_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def total(counts: dict, prefix: str) -> int:
    """The sum of the counters whose names start with ``prefix``."""
    return sum(v for k, v in counts.items() if k.startswith(prefix))
