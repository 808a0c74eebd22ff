"""Profiling and tracing.

Port of ``maunet_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, where there is a card, device activity), written to ``logdir`` as a
  Chrome trace (``trace.json``; open it in Perfetto or ``chrome://tracing``)
  where JAX writes an XPlane;
- ``StepTimer``: a cheap per-step wall-time accumulator with percentile
  summaries, as in JAX;
- ``device_memory_stats()``: per visible CUDA device, the bytes allocated,
  the device's total and the peak allocated since the last
  ``torch.cuda.reset_peak_memory_stats``; an empty list without a card.

The program's own spans and tallies, which the JAX package has not:

- ``span(name)``: a context manager around one piece of host work, at a
  layer boundary of the program (``engine.forward``, ``train.loss``, ...);
- ``tally(owner, attr, n)``: ``owner.attr += n``, a plain counter
  attribute, as the kernel wrappers' ``.launches`` are.

Both record only while ``torch``'s profiler is enabled, so they cost one
flag read outside a trace and need no switch of their own: they appear
whenever someone traces, with :func:`trace` or any other ``torch.profiler``
profile.  Times are ``time.time_ns``, the wall clock that a Chrome trace's
``ts`` and ``baseTimeNanoseconds`` count in, so a span is placed beside the
device's intervals by subtracting ``baseTimeNanoseconds``.  They are kept
in memory, in a bounded buffer, until :func:`recorded` reads them or
:func:`clear` empties it; :func:`trace` writes them into its
``trace.json``.  A span is host time: one that ends by copying a result to
the host also holds the wait for the device.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from maunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TRACE_FILE = "trace.json"
# The Chrome trace's category and process of the program's spans and tallies.
CATEGORY = "maunet"
# Spans and tally events kept until read: a traced window of thousands of
# units fits; older events give way first.
MAX_EVENTS = 1 << 16

# Read at every span and tally; about 80 ns.
_profiler_enabled = torch._C._autograd._profiler_enabled
_events: collections.deque = collections.deque(maxlen=MAX_EVENTS)
_serial = itertools.count()
_local = threading.local()


class Span(NamedTuple):
    """A recorded span: ``parent`` is the index, in :func:`recorded`'s list,
    of the span that enclosed it on the same thread (-1: none, or one not
    kept or not yet closed); ``thread`` is the native id of that thread."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int


class Tally(NamedTuple):
    """A recorded tally: ``<owner's qualified name>.<attr>`` grew by ``n`` at ``t_ns``."""
    name: str
    t_ns: int
    n: int


# What :func:`span` returns outside a trace: one shared object that does nothing.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "serial", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self.serial = next(_serial)
        self.parent = stack[-1] if stack else -1
        stack.append(self.serial)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        # (serial, name, start, end, parent's serial, thread): a Span once read.
        _events.append((self.serial, self.name, self.start, end, self.parent, _local.thread))
        return None


def span(name: str):
    """A context manager recording ``name``'s host time while the profiler is
    enabled; otherwise the shared no-op object."""
    return _Span(name) if _profiler_enabled() else _NO_SPAN


def tally(owner, attr: str, n: int = 1) -> None:
    """``owner.attr += n``; while the profiler is enabled, also record the
    event, so a reader can count the tally inside a window."""
    setattr(owner, attr, getattr(owner, attr) + n)
    if _profiler_enabled():
        _events.append(Tally(f"{owner.__qualname__}.{attr}", time.time_ns(), n))


def recorded() -> tuple[list[Span], list[Tally]]:
    """The kept spans, in the order they were entered, and tally events, in
    the order they happened."""
    events = list(_events)
    opened = sorted(e for e in events if not isinstance(e, Tally))
    index = {e[0]: i for i, e in enumerate(opened)}
    spans = [Span(name, start, end, index.get(parent, -1), thread)
             for _, name, start, end, parent, thread in opened]
    return spans, [e for e in events if isinstance(e, Tally)]


def clear() -> None:
    _events.clear()


def _chrome_events(base_ns: int) -> list[dict]:
    """The kept spans (``"X"``) and tallies (``"C"``, each tally's running
    total) as Chrome-trace events in µs from ``base_ns``."""
    spans, tallies = recorded()
    us = lambda t: (t - base_ns) / 1e3
    out = [{"ph": "X", "cat": CATEGORY, "name": s.name, "pid": CATEGORY, "tid": s.thread,
            "ts": us(s.start_ns), "dur": (s.end_ns - s.start_ns) / 1e3} for s in spans]
    totals: dict[str, int] = {}
    for t in tallies:
        totals[t.name] = totals.get(t.name, 0) + t.n
        out.append({"ph": "C", "cat": CATEGORY, "name": t.name, "pid": CATEGORY,
                    "ts": us(t.t_ns), "args": {"total": totals[t.name]}})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir/trace.json``; the device's kernels are in it when a card is
    visible.  Work still queued on the card at the end is waited for.  The
    program's spans and tallies of the block are added to the same file,
    on the trace's clock, in the category and process ``maunet``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
    log.info(f"Profiler trace written to {path}")


class StepTimer:
    """Wall-clock step timer.  Call ``tick()`` once per step; read
    ``summary()`` for mean/percentiles.  Note: under asynchronous launches a
    tick measures launch-to-launch time; synchronise the device (e.g.
    ``torch.cuda.synchronize()``) around the region you want device-accurate."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def reset(self) -> None:
        self._times.clear()
        self._last = None

    @property
    def steps(self) -> int:
        return max(0, len(self._times) - self.skip_first)

    def summary(self) -> dict[str, float]:
        times = np.asarray(self._times[self.skip_first:])
        if times.size == 0:
            return {}
        return {
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p90_s": float(np.percentile(times, 90)),
            "p99_s": float(np.percentile(times, 99)),
            "steps_per_s": float(1.0 / times.mean()),
            "n": int(times.size),
        }


def device_memory_stats() -> list[dict]:
    """Per visible CUDA device (bytes): ``bytes_in_use`` (allocated by this
    process's tensors), ``bytes_limit`` (the device's total memory) and
    ``peak_bytes_in_use`` (the most allocated since the last reset).  Empty
    without a card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        out.append({"device": str(d),
                    "bytes_in_use": torch.cuda.memory_allocated(d),
                    "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(d)})
    return out
