"""Profiler integration: ``--profile-dir`` on a training CLI (or
:func:`maybe_trace` in code) records a ``torch.profiler`` trace of the run,
host and CUDA activity, as a Chrome/Perfetto ``trace.json`` in that
directory, and the program's counters of the same session as
``counters.json`` beside it. Port of :mod:`tcgan_tpu.utils.profiling`
(``jax.profiler`` there). Under a mesh every rank traces its own process:
rank r > 0 writes ``trace.rank<r>.json`` and ``counters.rank<r>.json``.

The program records into one record, and only while a ``torch.profiler``
session runs (:func:`enabled`; no flag or option turns it on):

- :func:`span` opens a ``record_function`` span, a profiler event on the
  profiler's own clock beside the device's, so a trace's idle gaps can be
  labelled with the innermost span;
- :func:`host_sync` wraps one blocking host-device transfer: the span
  ``host_sync.<site>``, the counter ``host_syncs.<site>`` and the host
  nanoseconds spent inside it, ``sync_wait_ns.<site>``;
- :func:`add` counts on the host and :func:`device_totals` hands out a
  device buffer that kernels add into without a sync.

:func:`counters` reads the record (the device totals once, by one copy)
and :func:`reset` clears it. The record holds one session: the first site
that records in a new session clears what an earlier one left. A session
ends for the record when a site runs or :func:`counters` is called with no
profiler running. With none running each site costs a flag read and a
comparison, and nothing is allocated or entered.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import profiler as _autograd_profiler


class _Record:
    __slots__ = ("on", "counts", "device")

    def __init__(self):
        self.on = False  # the profiler's state when a site last looked
        self.counts: dict[str, int] = {}
        # device -> (names, int64 buffer with one slot per name)
        self.device: dict[tuple, tuple[tuple[str, ...], torch.Tensor]] = {}


_record = _Record()
_OFF = nullcontext()


def enabled() -> bool:
    """True exactly while a ``torch.profiler`` session runs. The first call
    in a new session clears the record of the one before."""
    on = _autograd_profiler._is_profiler_enabled
    if on is not _record.on:
        if on:
            reset()
        _record.on = on
    return on


def reset() -> None:
    """Clear the record."""
    _record.counts = {}
    _record.device = {}


def span(name: str):
    """A profiler span named ``name`` while a profiler runs, else a no-op
    context."""
    return torch.profiler.record_function(name) if enabled() else _OFF


def host_sync(site: str):
    """The context of one blocking host-device transfer at ``site``: while
    a profiler runs, the span ``host_sync.<site>``, one more
    ``host_syncs.<site>`` and the host nanoseconds inside it added to
    ``sync_wait_ns.<site>``; else a no-op context. A site counts on CPU
    tensors too, so a CPU run counts what the card's does."""
    return _sync(site) if enabled() else _OFF


@contextmanager
def _sync(site: str):
    with torch.profiler.record_function(f"host_sync.{site}"):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            add(f"sync_wait_ns.{site}", time.perf_counter_ns() - t0)
            add(f"host_syncs.{site}")


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while a profiler runs."""
    if enabled():
        _record.counts[name] = _record.counts.get(name, 0) + n


def device_totals(names: tuple[str, ...], device) -> torch.Tensor:
    """The record's int64 buffer on ``device`` with one slot per name of
    ``names``, zero at its first use in a session; code on the device adds
    into it and :func:`counters` reports each slot under its name. Call it
    only while :func:`enabled`."""
    key = (tuple(names), torch.device(device))
    if key not in _record.device:
        _record.device[key] = (key[0], torch.zeros(
            len(names), dtype=torch.int64, device=device))
    return _record.device[key][1]


def counters() -> dict:
    """The record, name -> number: the host counters and the device totals,
    each buffer read once."""
    enabled()
    out = dict(_record.counts)
    for names, buf in _record.device.values():
        for name, v in zip(names, buf.tolist()):
            out[name] = out.get(name, 0) + v
    return out


@contextmanager
def trace(profile_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    rank = dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
    prof.export_chrome_trace(
        str(out / ("trace.json" if rank == 0 else f"trace.rank{rank}.json")))
    (out / ("counters.json" if rank == 0 else f"counters.rank{rank}.json")
     ).write_text(json.dumps(counters(), indent=1, sort_keys=True) + "\n")


def maybe_trace(profile_dir: str | None):
    """A profiler trace when a directory is given, else a no-op."""
    return trace(profile_dir) if profile_dir else nullcontext()
