"""The profiler arithmetic on a synthetic event list: busy time, idle
gaps by host activity, kernel time by name, the evidence calls."""

import json

import pytest

from gpbench import trace as tr


def ev(name, cat, start, end):
    return tr.Event(name, cat, float(start), float(end))


EVENTS = [
    ev(tr.WINDOW, "user_annotation", 0, 100),
    ev("void table_kernel<20>(float const*, float2*, int)", "kernel", 5, 10),
    ev("void (anonymous namespace)::evidence_kernel<20, false>(Args, Constants)", "kernel", 10, 30),
    ev("void table_kernel<20>(float const*, float2*, int)", "kernel", 30, 32),
    ev("void (anonymous namespace)::evidence_kernel<20, true>(Args, Constants)", "kernel", 32, 50),
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 45, 55),
    ev("other_kernel", "kernel", 80, 90),
    ev("other_kernel", "kernel", 95, 120),     # runs past the window
    ev("aten::sort", "cpu_op", 58, 70),          # spans the gap 55-80 at 67.5
    ev("aten::copy_", "cpu_op", 60, 62),         # inner, but ends before the midpoint
    ev("aten::empty", "cpu_op", 88, 89),         # ends before the gap 90-95
    ev("before", "kernel", -20, -10),            # outside the window
]


def test_summary_of_a_synthetic_trace():
    s = tr.summarize(EVENTS)
    assert s.window == (0.0, 100.0)
    # busy: 5-55 (table, evidence, memcpy overlapping), 80-90, 95-100
    assert s.busy_us == pytest.approx(50 + 10 + 5)
    assert s.evidence["single"] == (1, pytest.approx(25.0))
    assert s.evidence["pair"] == (1, pytest.approx(20.0))
    names = dict(s.idle_gaps)
    assert names["aten::sort"] == pytest.approx(25e-6)       # 55-80
    assert names["after aten::empty"] == pytest.approx(5e-6)  # 90-95, no op spans it
    assert names["idle"] == pytest.approx(5e-6)               # 0-5, nothing before it
    ops = dict(s.device_ops)
    assert ops["other_kernel"] == pytest.approx(35e-6)        # by name, whole durations
    assert len(s.kernels) == 6


def test_load_events_reads_complete_events(tmp_path):
    raw = {"traceEvents": [
        {"ph": "X", "name": "k", "cat": "kernel", "ts": 1.5, "dur": 2.0},
        {"ph": "i", "name": "marker", "ts": 3},
        {"ph": "X", "name": "no dur", "cat": "cpu_op", "ts": 3},
    ]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(raw))
    (e,) = tr.load_events(p)
    assert (e.name, e.cat, e.start, e.end) == ("k", "kernel", 1.5, 3.5)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tr.summarize(EVENTS[1:])
