"""Reduction of a torch.profiler Chrome trace to the benchmark's numbers.

Device busy time is the union of the card's kernel, memcpy and memset
intervals (a frozen copy of chip_smoke.py's `_busy_union` and
`trace_report`); the traced window is the traced job's length by the
host's clock, or else the span of every timed event. Idle
gaps are the stretches of the window in which no device interval runs,
each labelled by the innermost host event that covers it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_s: Dict[str, float]          # device time by operation name
    idle_gaps: List[Tuple[str, float]]  # longest first, at most TOP

    def device_ops(self) -> List[Tuple[str, float]]:
        return sorted(self.device_s.items(), key=lambda x: -x[1])[:TOP]


def busy_union(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _label(host, h_lo, h_hi, a: float, b: float) -> str:
    """The innermost host event over the gap [a, b): the shortest one that
    covers it whole, else one over its middle; else the host events on
    either side of it."""
    for x, y in ((a, b), ((a + b) / 2, (a + b) / 2)):
        cover = np.flatnonzero((h_lo <= x) & (h_hi >= y))
        if len(cover):
            return host[cover[np.argmin(h_hi[cover] - h_lo[cover])]]["name"]
    before = np.flatnonzero(h_hi <= a)
    after = np.flatnonzero(h_lo >= b)
    prev = (host[before[np.argmax(h_hi[before])]]["name"] if len(before)
            else "the trace's start")
    nxt = (host[after[np.argmin(h_lo[after])]]["name"] if len(after)
           else "the trace's end")
    return f"host, between {prev} and {nxt}"


def read(path: str, window_s: Optional[float] = None) -> Trace:
    """The trace's numbers; the window is `window_s` when given (the
    traced job's length by the host's clock), else the span of its
    events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    if not events:
        return Trace(0.0, window_s or 0.0, {}, [])
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device_s: Dict[str, float] = {}
    for a, b, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (b - a) / 1e6
    spans = [(a, b) for a, b, _ in dev]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    h_lo = np.array([float(e["ts"]) for e in host])
    h_hi = h_lo + np.array([float(e["dur"]) for e in host])
    gaps = sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    labelled = []
    for a, b in gaps:
        labelled.append((_label(host, h_lo, h_hi, a, b), (b - a) / 1e6))
    return Trace(busy_union(spans) / 1e6,
                 (hi - lo) / 1e6 if window_s is None else window_s,
                 device_s, labelled)
