"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics read: device busy time, kernel time by name, the
evidence kernels' calls, and the idle gaps by the host activity that
spanned them.

The trace is the profiler's Chrome-trace export (CPU and CUDA
activities): events with ``cat`` ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` are device work, ``cpu_op`` host operations, and the
``user_annotation`` named WINDOW marks the window.  Times in microseconds.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "gpbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
EVIDENCE = re.compile(r"evidence_kernel<\s*\d+\s*,\s*(false|true)\s*>")
TABLE = re.compile(r"table_kernel<")
TOP = 10
SCAN = 20_000   # host ops looked back at per gap


@dataclass
class Event:
    name: str
    cat: str
    start: float
    end: float


@dataclass
class TraceSummary:
    window: tuple[float, float]
    busy_us: float
    kernels: list = field(default_factory=list)      # Event, in start order
    device_ops: list = field(default_factory=list)   # [[name, seconds]], longest first
    idle_gaps: list = field(default_factory=list)    # [[host op, seconds]], longest first
    evidence: dict = field(default_factory=dict)     # {"single"|"pair": (calls, device us)}

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def load_events(path) -> list[Event]:
    with open(path) as f:
        raw = json.load(f)
    out = []
    for e in raw.get("traceEvents", raw if isinstance(raw, list) else []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts = float(e["ts"])
        out.append(Event(e.get("name", ""), e.get("cat", ""), ts, ts + float(e["dur"])))
    return out


def merged(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, t0, t1):
    return [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]


def evidence_calls(kernels) -> dict:
    """Device time of each evidence configuration's calls: each
    ``evidence_kernel<K, PAIR>`` with the ``table_kernel`` prologue that
    went before it.  {"single": (calls, us), "pair": (calls, us)}."""
    acc = {"single": [0, 0.0], "pair": [0, 0.0]}
    pending = 0.0
    for k in sorted(kernels, key=lambda e: e.start):
        if TABLE.search(k.name):
            pending += k.end - k.start
            continue
        m = EVIDENCE.search(k.name)
        if m:
            kind = "pair" if m.group(1) == "true" else "single"
            acc[kind][0] += 1
            acc[kind][1] += k.end - k.start + pending
            pending = 0.0
    return {k: (v[0], v[1]) for k, v in acc.items()}


def idle_gaps(busy, host_ops, t0, t1):
    """The gaps in ``busy`` (merged device intervals) inside [t0, t1],
    each named by the innermost host op that spans its midpoint, or where
    none does (the host in Python between ops) "after <op>", the last op
    that ended before the gap ("idle" where none did): [[name, seconds]]
    summed by name, longest first."""
    gaps, last = [], t0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    ops = sorted(host_ops, key=lambda o: o.start)
    starts = [o.start for o in ops]
    by_end = sorted(host_ops, key=lambda o: o.end)
    ends = [o.end for o in by_end]
    by_name = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        # the latest-starting op that still spans the midpoint: on its
        # thread, the innermost
        best = None
        hi = bisect.bisect_right(starts, mid)
        for i in range(hi - 1, max(hi - SCAN, 0) - 1, -1):
            if ops[i].end >= mid:
                best = ops[i]
                break
        if best is not None:
            name = best.name
        else:
            i = bisect.bisect_right(ends, s) - 1
            name = f"after {by_end[i].name}" if i >= 0 else "idle"
        by_name[name] += (e - s) * 1e-6
    return sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]


def summarize(events: list[Event]) -> TraceSummary:
    marks = [e for e in events if e.name == WINDOW and e.cat in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    t0, t1 = marks[0].start, marks[0].end
    dev = [e for e in events if e.cat in DEVICE_CATS and e.end > t0 and e.start < t1]
    busy = merged(clip([(e.start, e.end) for e in dev], t0, t1))
    kernels = sorted((e for e in dev if e.cat == "kernel"), key=lambda e: e.start)
    per_name = defaultdict(float)
    for e in dev:
        per_name[e.name] += (e.end - e.start) * 1e-6
    host = [e for e in events if e.cat == "cpu_op" and e.end > t0 and e.start < t1]
    return TraceSummary(
        window=(t0, t1), busy_us=sum(e - s for s, e in busy), kernels=kernels,
        device_ops=sorted(([n, v] for n, v in per_name.items()), key=lambda x: -x[1])[:TOP],
        idle_gaps=idle_gaps(busy, host, t0, t1), evidence=evidence_calls(kernels),
    )
