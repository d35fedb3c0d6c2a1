"""The program's spans against a ``torch.profiler`` trace of the window:
which driver code launched each device op, and which left the card idle.

The spans come from the program's own recorder
(``gp_dla_detection_tpu_torch.utils.observability.recording``), on the
``time.perf_counter_ns`` clock, from every thread; the profiler's trace
holds the calling thread's spans too, as ``user_annotation`` events of
the same names (it records no range of another thread).  This module
takes the recorded spans as plain tuples (name, thread, t0_ns, t1_ns,
parent, ids), so it needs nothing of the program, and the raw Chrome
trace (``load_raw``), whose ``args`` carry the correlation of each
device op with the runtime call that launched it.  Times in
microseconds on the trace's clock unless a name says otherwise.

- :func:`align`: the offset from the recorder's clock to the trace's,
  from (trace ts - recorder t0) over the calling thread's spans found in
  both, matched by name and order: the program stamps a span before the
  profiler does, so each difference is the offset plus a delay of at
  least 0, and the offset is their lower envelope (a line, for the two
  clocks may drift apart); the spread is the delays' quartile distance;
- :func:`launched_by`: each device op put down to the innermost calling
  thread span open at its launch (the ``cuda_runtime`` or ``cuda_driver``
  event of the same correlation);
- :func:`idle_by_span`: the device's idle gaps in the window, each named
  by the innermost calling-thread span open at its middle, or "outside
  the program" where no ``gpdla.call`` is;
- :func:`timeline`: the calling thread's window cut into stretches, each
  under its innermost span: where its time went, and each instant of
  idle time by the span the thread was in;
- :func:`reduce`: all of it, and the quantities the drivers' layers are
  read by (``call_setup_ms``, ``host_finalize_ms``, ``host_wait_pct``,
  ``reducer_device_ms``).
"""

from __future__ import annotations

import json
import statistics
from collections import defaultdict, namedtuple

from gpbench import trace as tr

Span = namedtuple("Span", "name thread t0_ns t1_ns parent ids")
Placed = namedtuple("Placed", "name start end ids")    # a span on the trace's clock
DeviceOp = namedtuple("DeviceOp", "name start end correlation")

PREFIX = "gpdla."
CALL = "gpdla.call"
OUTSIDE = "outside the program"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def load_raw(path) -> list[dict]:
    """The complete ("X") events of a Chrome trace, as the export wrote them."""
    with open(path) as f:
        raw = json.load(f)
    events = raw.get("traceEvents", raw if isinstance(raw, list) else [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def as_spans(spans) -> list[Span]:
    return [s if isinstance(s, Span) else Span(*s) for s in spans]


def calling_thread(spans: list[Span]) -> str:
    """The thread that made the driver calls (that of the ``gpdla.call``
    spans)."""
    threads = {s.thread for s in spans if s.name == CALL}
    if len(threads) != 1:
        raise ValueError(f"the driver calls ran on {len(threads)} threads, not one")
    return threads.pop()


def align(spans: list[Span], events: list[dict]) -> dict:
    """The map from the recorder's clock to the trace's (module
    docstring): ``offset_us`` at ``t_ref_us`` (recorder us) and
    ``drift_us_per_s``, the lower envelope of the differences: the line
    through the least difference in each of up to 16 stretches of the
    pairs (one per 32 pairs), lowered onto the least of all; its
    ``spread_us``, how far those least differences lie from it (largest
    less smallest); the profiler's delays above it (``delay_iqr_us``,
    their quartile distance, and ``delay_max_us``); ``pairs``."""
    thread = calling_thread(spans)
    mine, theirs = defaultdict(list), defaultdict(list)
    for s in spans:
        if s.thread == thread:
            mine[s.name].append(s.t0_ns * 1e-3)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            theirs[e["name"]].append(float(e["ts"]))
    pairs = []
    for name, starts in mine.items():
        ts = theirs.get(name, [])
        if len(ts) == len(starts):
            pairs += [(s, t - s) for t, s in zip(sorted(ts), sorted(starts))]
    if len(pairs) < 2:
        raise ValueError("fewer than two spans are both recorded and in the trace")
    pairs.sort()
    bins = max(1, min(16, len(pairs) // 32))
    size = -(-len(pairs) // bins)
    lows = [min(pairs[i:i + size], key=lambda p: p[1]) for i in range(0, len(pairs), size)]
    t_ref = pairs[0][0]
    slope = 0.0
    if len(lows) > 1:
        tm = statistics.fmean(t for t, _ in lows)
        dm = statistics.fmean(d for _, d in lows)
        slope = (sum((t - tm) * (d - dm) for t, d in lows)
                 / sum((t - tm) ** 2 for t, _ in lows))
    offset = min(d - slope * (t - t_ref) for t, d in pairs)
    low = [d - offset - slope * (t - t_ref) for t, d in lows]
    delays = [d - offset - slope * (t - t_ref) for t, d in pairs]
    q1, _, q3 = statistics.quantiles(delays, n=4) if len(delays) > 2 else (0, 0, 0)
    return {"offset_us": offset, "t_ref_us": t_ref, "drift_us_per_s": slope * 1e6,
            "spread_us": max(low) - min(low), "delay_iqr_us": q3 - q1,
            "delay_max_us": max(delays), "pairs": len(pairs)}


def placed(spans: list[Span], thread: str, fit: dict) -> list[Placed]:
    """``thread``'s spans on the trace's clock (``fit``: :func:`align`),
    in order of start."""
    slope = fit["drift_us_per_s"] * 1e-6

    def on_trace(ns):
        t = ns * 1e-3
        return t + fit["offset_us"] + slope * (t - fit["t_ref_us"])

    out = [Placed(s.name, on_trace(s.t0_ns), on_trace(s.t1_ns), s.ids)
           for s in spans if s.thread == thread]
    return sorted(out, key=lambda p: (p.start, -p.end))


def innermost(spans: list[Placed], points: list[float]) -> list[Placed | None]:
    """For each point, the innermost span that holds it (the spans of one
    thread nest), or None: one sweep over both in time order."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out = [None] * len(points)
    stack, i = [], 0
    for j in order:
        t = points[j]
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out


def device_ops(events: list[dict], t0: float, t1: float) -> list[DeviceOp]:
    out = []
    for e in events:
        if e.get("cat") in tr.DEVICE_CATS:
            start = float(e["ts"])
            end = start + float(e["dur"])
            if end > t0 and start < t1:
                out.append(DeviceOp(e.get("name", ""), start, end,
                                    (e.get("args") or {}).get("correlation")))
    return out


def trace_tid(events: list[dict]):
    """The trace's id of the calling thread (that of its ``gpdla.call``
    annotations)."""
    tids = {e.get("tid") for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == CALL}
    if len(tids) != 1:
        raise ValueError(f"the trace's driver calls ran on {len(tids)} threads, not one")
    return tids.pop()


def launches(ops: list[DeviceOp], events: list[dict]) -> list[tuple]:
    """Each op's launch, the runtime (or driver) call with its
    correlation: (ts, thread id), (None, None) where the trace has none."""
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = (float(e["ts"]), e.get("tid"))
    return [launch.get(op.correlation, (None, None)) for op in ops]


def launched_by(at: list[tuple], spans: list[Placed], tid) -> list[Placed | None]:
    """For each launch of :func:`launches`, the innermost of the calling
    thread's ``spans`` at it, where the calling thread (``tid``) made it;
    None where another thread did, or outside every span."""
    hits = [k for k, (ts, t) in enumerate(at) if ts is not None and t == tid]
    found = innermost(spans, [at[k][0] for k in hits])
    out = [None] * len(at)
    for k, span in zip(hits, found):
        out[k] = span
    return out


def gaps(busy, t0: float, t1: float) -> list[tuple[float, float]]:
    """The gaps of ``busy`` (merged intervals) inside [t0, t1]."""
    out, last = [], t0
    for s, e in busy:
        if s > last:
            out.append((last, min(s, t1)))
        last = max(last, e)
    if t1 > last:
        out.append((last, t1))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(idle, spans: list[Placed]) -> list[list]:
    """[[span name or OUTSIDE, seconds]] of the ``idle`` gaps, each
    named by the innermost span at its middle, longest first."""
    found = innermost(spans, [0.5 * (s + e) for s, e in idle])
    by = defaultdict(float)
    for (s, e), span in zip(idle, found):
        by[span.name if span is not None else OUTSIDE] += (e - s) * 1e-6
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])


def timeline(spans: list[Placed], t0: float, t1: float) -> list[tuple]:
    """[t0, t1] cut into (start, end, name) stretches, each under the
    innermost of ``spans`` (which nest) or OUTSIDE."""
    marks = sorted({t0, t1} | {t for p in spans for t in (p.start, p.end) if t0 < t < t1})
    mids = [0.5 * (a + b) for a, b in zip(marks, marks[1:])]
    return [(a, b, span.name if span is not None else OUTSIDE)
            for a, b, span in zip(marks, marks[1:], innermost(spans, mids))]


def overlap_by_name(stretches, intervals) -> dict:
    """Seconds of the (sorted, disjoint) ``intervals`` under each name of
    the (sorted, disjoint) ``stretches``."""
    by, j = defaultdict(float), 0
    for a, b, name in stretches:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            by[name] += (min(b, intervals[k][1]) - max(a, intervals[k][0])) * 1e-6
            k += 1
    return by


def top(by: dict) -> list[list]:
    return sorted(([n, v] for n, v in by.items() if v > 0), key=lambda x: -x[1])[:TOP]


def reduce(events: list[dict], recorded) -> dict:
    """The window's device time and idle time by program span, the
    alignment, and the drivers' quantities (module docstring).  ``events``:
    :func:`load_raw`; ``recorded``: the recorder's spans of the window's
    calls."""
    spans = as_spans(recorded)
    marks = [e for e in events
             if e.get("name") == tr.WINDOW and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError(f"the trace has no {tr.WINDOW!r} annotation")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    fit = align(spans, events)
    thread = calling_thread(spans)
    mine = placed(spans, thread, fit)
    inside = [p for p in mine if p.end > t0 and p.start < t1]
    ops = device_ops(events, t0, t1)
    at = launches(ops, events)
    by_op = launched_by(at, mine, trace_tid(events))

    device = defaultdict(float)
    early = []
    # an op's start less its launch's: below 0 where the trace's device
    # times run ahead of its host times
    lead = [op.start - ts for op, (ts, _) in zip(ops, at) if ts is not None]
    for op, span in zip(ops, by_op):
        device[span.name if span is not None else "another thread or none"] += (
            min(op.end, t1) - max(op.start, t0)) * 1e-6
        if span is not None and span.name.startswith("gpdla.stage.") and op.start < span.start:
            early.append([op.name[:60], span.name, op.start - span.start])
    busy = tr.merged(tr.clip([(op.start, op.end) for op in ops], t0, t1))
    idle = gaps(busy, t0, t1)
    idle_s = sum(e - s for s, e in idle) * 1e-6
    named = idle_by_span(idle, mine)
    stretches = timeline(mine, t0, t1)

    def total_us(name):
        return sum(min(p.end, t1) - max(p.start, t0) for p in inside if p.name == name)

    batches = sum(1 for p in inside if p.name == "gpdla.batch.complete")
    setups = [(p.end - p.start) * 1e-3 for p in inside if p.name == "gpdla.call.setup"]
    cddf_us = sum(min(op.end, t1) - max(op.start, t0) for op, span in zip(ops, by_op)
                  if span is not None and span.name == "gpdla.stage.cddf")
    window_us = t1 - t0
    quantities = {
        "call_setup_ms": statistics.median(setups) if setups else None,
        "host_finalize_ms": ((total_us("gpdla.batch.complete") - total_us("gpdla.batch.wait")
                              + total_us("gpdla.call.finalize")) * 1e-3 / batches
                             if batches else None),
        "host_wait_pct": 100.0 * total_us("gpdla.batch.wait") / window_us,
        "reducer_device_ms": (cddf_us * 1e-3 / batches
                              if batches and ops and any(p.name == "gpdla.stage.cddf"
                                                         for p in inside) else None),
    }
    return {
        "window_s": window_us * 1e-6,
        "alignment": fit,
        "idle_s": idle_s,
        "idle_by_span": named[:TOP],
        "idle_named_share": (sum(v for _, v in named) / idle_s) if idle_s else 1.0,
        "idle_split_by_span": top(overlap_by_name(stretches, idle)),
        "host_by_span": top(overlap_by_name(stretches, [(t0, t1)])),
        "device_by_span": top(device),
        "stage_ops_before_their_span": len(early),
        "stage_ops_before_their_span_first": early[:5],
        "ops_before_their_launch": sum(1 for x in lead if x < 0),
        "launch_to_start_min_us": min(lead) if lead else None,
        "batches": batches,
        **quantities,
    }
