"""Profiler integration: ``--profile-dir`` on a training CLI (or
:func:`maybe_trace` in code) records a ``torch.profiler`` trace of the run,
host and CUDA activity, as a Chrome/Perfetto ``trace.json`` in that
directory. Port of :mod:`tcgan_tpu.utils.profiling` (``jax.profiler``
there). Under a mesh every rank traces its own process: rank r > 0 writes
``trace.rank<r>.json`` beside rank 0's ``trace.json``."""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
import torch.distributed as dist


@contextmanager
def trace(profile_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    prof.export_chrome_trace(
        str(out / ("trace.json" if rank == 0 else f"trace.rank{rank}.json")))


def maybe_trace(profile_dir: str | None):
    """A profiler trace when a directory is given, else a no-op."""
    return trace(profile_dir) if profile_dir else nullcontext()
