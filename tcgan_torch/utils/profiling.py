"""Profiler integration: ``--profile-dir`` on a training CLI (or
:func:`maybe_trace` in code) records a ``torch.profiler`` trace of the run,
host and CUDA activity, as a Chrome/Perfetto ``trace.json`` in that
directory. Port of :mod:`tcgan_tpu.utils.profiling` (``jax.profiler``
there)."""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch


@contextmanager
def trace(profile_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def maybe_trace(profile_dir: str | None):
    """A profiler trace when a directory is given, else a no-op."""
    return trace(profile_dir) if profile_dir else nullcontext()
