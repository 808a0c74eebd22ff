"""Reading a ``torch.profiler`` Chrome trace of one traced window.

Busy time is the union of the device's kernel, memcpy and memset
intervals inside the window, which ends after the final synchronise.  The
idle share is taken within that same traced window.  The benchmark traces
the device alone, so that the profiler adds no cost to each host operation:
the window and the host spans are its own readings of the wall clock
(``time.time_ns``), the clock that the trace's ``baseTimeNanoseconds`` and
``ts`` count in.  Kernel families are matched by name, in order, as
``profile_port.py`` matches them (copied here).  Idle gaps are
labelled by the innermost host span of the benchmark that covers them.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The train step's families (profile_port.TRAIN_FAMILIES).  E is the stash
# instantiation of B's template (``<true>``, mangled ``ILb1E``).
TRAIN_FAMILIES = (
    ("A conv3x3_fused", ("conv3x3_fused",)),
    ("E lstm stash forward", ("lstm_last_hidden_kernel<true", "lstm_last_hidden_kernelILb1E")),
    ("B lstm_last_hidden", ("lstm_last_hidden",)),
    ("F lstm backward", ("lstm_gate_terms", "lstm_backward")),
    ("dW lstm_dw", ("lstm_dw",)),
    ("C resize_align_corners", ("resize_align_corners",)),
    ("cuDNN convs, forward and backward", ("xmma", "cudnn", "dgrad", "wgrad", "fprop", "conv")),
    ("GEMMs (dense layers, SSIM blur, resize backward)", ("gemm", "cutlass")),
    ("optimizer (multi-tensor apply)", ("multi_tensor_apply",)),
)
OTHER = "other torch ops"
COPIES = "memcpy and memset"


def family(name: str, families) -> str:
    for label, keys in families:
        if any(k in name for k in keys):
            return label
    return OTHER


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without template arguments and parameter lists."""
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = re.sub(r"\s+", " ", "".join(out)).strip()
    s = s.split(" ")[-1] if s.startswith("void ") else s
    return s[:96] or name[:96]


@dataclass
class TraceView:
    """The device's work inside one traced window, in seconds."""
    window: tuple[float, float]
    device: list[tuple[str, str, float, float]]  # (cat, name, start, end)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, start: float | None = None, end: float | None = None) -> float:
        a = self.window[0] if start is None else start
        b = self.window[1] if end is None else end
        return sum(e - s for s, e in merged([(max(s, a), min(e, b))
                                             for _, _, s, e in self.device if e > a and s < b]))

    def kernels(self, key: str | None = None) -> list[tuple[str, float, float]]:
        return [(n, s, e) for c, n, s, e in self.device
                if c == "kernel" and (key is None or key in n)]

    def kernel_s(self, key: str) -> float:
        return sum(e - s for n, s, e in self.kernels(key))

    def family_s(self, families) -> dict[str, float]:
        out: dict[str, float] = {}
        for c, n, s, e in self.device:
            label = family(n, families) if c == "kernel" else COPIES
            out[label] = out.get(label, 0.0) + (e - s)
        return out

    def span_list(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, by short name."""
        out: dict[str, float] = {}
        for c, n, s, e in self.device:
            key = short_name(n) if c == "kernel" else c
            out[key] = out.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle time inside the window, summed by the innermost benchmark span
        that covers each gap's middle (``host`` where none does)."""
        busy = merged([(max(s, self.window[0]), min(e, self.window[1]))
                       for _, _, s, e in self.device
                       if e > self.window[0] and s < self.window[1]])
        gaps, cursor = [], self.window[0]
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.window[1]:
            gaps.append((cursor, self.window[1]))
        inner = [sp for sp in self.spans if sp[0] != WINDOW]
        out: dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            covering = [sp for sp in inner if sp[1] <= mid <= sp[2]]
            label = min(covering, key=lambda sp: sp[2] - sp[1])[0] if covering else "host"
            out[label] = out.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def read_events(events: list[dict], spans: list[tuple[str, float, float]]) -> TraceView:
    """A :class:`TraceView` of Chrome-trace events (``ts``/``dur`` in µs)
    and the host spans (name, start, end in seconds on the events' clock),
    the window among them."""
    windows = [sp for sp in spans if sp[0] == WINDOW]
    if not windows:
        raise ValueError(f"no {WINDOW!r} span")
    _, w0, w1 = windows[-1]
    device = [(e["cat"], str(e.get("name", "")), float(e["ts"]) / 1e6,
               (float(e["ts"]) + float(e.get("dur", 0))) / 1e6)
              for e in events if e.get("cat") in DEVICE_CATS]
    device = [d for d in device if d[3] > w0 and d[2] < w1]
    return TraceView((w0, w1), device, [sp for sp in spans if sp[2] > w0 and sp[1] < w1])


def read_file(path: str, wall_ns: list[tuple[str, int, int]]) -> TraceView:
    """``wall_ns``: the host spans in ``time.time_ns`` units, placed on the
    trace's clock by its ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) if isinstance(doc, dict) else 0
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return read_events(events, [(n, (a - base) / 1e9, (b - base) / 1e9) for n, a, b in wall_ns])
