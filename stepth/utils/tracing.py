"""Tracing & profiling utilities (SURVEY.md §5: the reference has none — its
``indicatif`` progress-bar dependency is declared but never used,
reference Cargo.toml:11).

Thin wrappers over ``jax.profiler`` so pipeline stages show up as named spans
in device traces, a process-local wall-clock stage timer that works with the
async dispatch model (explicitly blocks on results when asked), and the
reduction of a recorded trace to device busy time.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import jax


class StageTimes:
    """Accumulates wall-clock per named stage; thread-unsafe by design (one per
    pipeline instance)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Times a stage. ``block_on`` (optional pytree of arrays) is
        block_until_ready'd before the clock stops so device work is counted."""
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a device profile (Perfetto/TensorBoard) around a region when
    ``log_dir`` is given; no-op otherwise."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Decorator: wrap a function in a named profiler span."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            with jax.profiler.TraceAnnotation(name):
                return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco


def busy_and_span_ns(intervals):
    """``(busy, span)`` of ``(start, end)`` intervals: the length of their
    union, and the time from the first start to the last end."""
    busy, end, first = 0, None, None
    for a, b in sorted(intervals):
        if first is None:
            first = a
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, 0 if first is None else end - first


def device_time_ns(log_dir: str):
    """Reduce the newest trace under ``log_dir`` to device time: returns
    ``(busy_ns, span_ns, per_name_ns)`` where ``busy_ns`` is the union of the
    event intervals on the device planes (``/device:GPU:*``), ``span_ns`` the
    time from their first start to their last end (so ``1 - busy/span`` is
    the device's idle share over the traced window), and ``per_name_ns``
    sums event durations by event name."""
    from jax._src.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    data = ProfileData.from_file(paths[-1])
    intervals, per_name = [], defaultdict(int)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.end_ns))
                per_name[ev.name] += ev.duration_ns
    busy, span = busy_and_span_ns(intervals)
    return busy, span, dict(per_name)
