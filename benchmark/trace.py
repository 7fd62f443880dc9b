"""Reading ``torch.profiler``'s trace of a profiled slice into the summary
the per-layer readers take (:mod:`benchmark.metrics`).

The profiler records host ops and annotations (CPU) and every device
activity (CUDA, through CUPTI). Everything is read in memory; nothing is
written. The slice is bracketed by the benchmark's own annotation
``bench.slice`` (host time), so its wall time and its idle gaps are taken
on the profiler's own clock.

- device activity: each device event but the annotations' mirrors on the
  device timeline; its union is the busy time;
- device time under a host span: the kernels that host ops launched while
  the span (a ``record_function`` of the program, such as ``ift.adjoint``)
  was open, on any thread;
- idle gaps: the holes in the union inside the slice, each labelled by the
  innermost host annotation and the innermost host op open at its midpoint.
"""

from __future__ import annotations

import bisect
import collections

import torch

SLICE = "bench.slice"
SOLVER_KERNEL = "ssn_solve"
SHORT_US = 5.0  # shorter idle gaps are summed without a label


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(host, starts, spans, t: float) -> str:
    """The innermost program annotation and host op open at host time
    ``t`` ("-" and "host" where none is)."""
    ann = max((s for s in spans if s[0] <= t <= s[1]), default=None)
    op = None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 500), -1):
        e = host[j]
        if not e.is_annotation and e.time_range.end >= t:
            op = e.name
            break
    return f"{ann[2] if ann else '-'}:{op or 'host'}"


class _Host:
    __slots__ = ("name", "time_range", "is_annotation", "kernels")

    def __init__(self, e, annotation: bool):
        self.name, self.time_range = e.name, e.time_range
        self.is_annotation, self.kernels = annotation, e.kernels


def summarize(prof, spans=()) -> dict:
    """The slice's summary, times in seconds: ``wall_s``, ``busy_s``,
    ``kernel_s`` (the solver kernel), ``other_device_s`` (device time
    outside it), ``span_s`` (device time under
    each host span of ``spans``), ``device_ops`` and ``idle_gaps``
    ([name, seconds], the ten largest)."""
    events = list(prof.events())
    annotations = {e.name for e in events if not _is_device(e)
                   and getattr(e, "is_user_annotation", False)}
    annotations |= {SLICE, *spans}
    host = sorted((_Host(e, e.name in annotations) for e in events
                   if not _is_device(e)), key=lambda h: h.time_range.start)
    starts = [h.time_range.start for h in host]
    slices = [h for h in host if h.name == SLICE]
    if not slices:
        raise RuntimeError("the profiled slice has no bench.slice span")
    t0 = min(h.time_range.start for h in slices)
    t1 = max(h.time_range.end for h in slices)
    device = [e for e in events if _is_device(e)
              and not getattr(e, "is_user_annotation", False)
              and e.name not in annotations
              and e.time_range.end > e.time_range.start]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = collections.Counter()
    kernel = 0.0
    for e in device:
        d = e.time_range.end - e.time_range.start
        by_name[e.name] += d
        if SOLVER_KERNEL in e.name:
            kernel += d
    merged = _union([(max(e.time_range.start, t0), min(e.time_range.end, t1))
                     for e in device if e.time_range.end > t0
                     and e.time_range.start < t1])
    busy = sum(b - a for a, b in merged)
    gaps = collections.Counter()
    marks = [(h.time_range.start, h.time_range.end, h.name) for h in host
             if h.is_annotation and h.name != SLICE]
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a >= SHORT_US:
            gaps[_label(host, starts, marks, (a + b) / 2.0)] += b - a
        elif b > a:
            gaps["gaps under 5 us"] += b - a
    span_us = {}
    for name in spans:
        open_ = [(h.time_range.start, h.time_range.end) for h in host
                 if h.name == name]
        total = 0.0
        for h in host:
            if h.is_annotation or not h.kernels:
                continue
            t = h.time_range.start
            if any(a <= t <= b for a, b in open_):
                total += sum(k.duration for k in h.kernels)
        span_us[name] = total
    us = 1e-6
    return {
        "wall_s": (t1 - t0) * us,
        "busy_s": busy * us,
        "kernel_s": kernel * us,
        "other_device_s": (sum(by_name.values()) - kernel) * us,
        "span_s": {k: v * us for k, v in span_us.items()},
        "device_ops": [[n[:120], v * us] for n, v in by_name.most_common(10)],
        "idle_gaps": [[n[:120], v * us] for n, v in gaps.most_common(10)],
    }
