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
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from maunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir/trace.json``; the device's kernels are in it when a card is
    visible.  Work still queued on the card at the end is waited for."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
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
