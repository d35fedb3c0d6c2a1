"""The program's spans against a synthetic Chrome trace: the alignment of
the recorder's clock to the trace's, the device ops put down to the span
that launched them, the idle time by span, the drivers' quantities, and
the trace's own reduction untouched by the program's annotations."""

import pytest

from gpbench import spans as sp
from gpbench import trace as tr

OFFSET = 1.0e6      # trace us - recorder us
TID = 7             # the calling thread in the trace
# the profiler stamps a span after the program does: a delay of at least 0
DELAY = (0.0, 1.0, 3.0, 0.5, 1.5, 0.0, 2.0, 4.0, 0.0, 0.0, 1.0, 2.5, 0.0)

# (name, thread, start us, end us, ids) on the recorder's clock
SPANS = [
    ("gpdla.call", "MainThread", 100, 900, {"call": 0}),
    ("gpdla.call.setup", "MainThread", 100, 200, {"call": 0}),
    ("gpdla.batch.upload", "gpdla-upload", 150, 180, {"call": 0, "batch": 0}),
    ("gpdla.batch.issue", "MainThread", 200, 300, {"call": 0, "batch": 0}),
    ("gpdla.stage.single", "MainThread", 205, 240, {"call": 0, "batch": 0}),
    ("gpdla.stage.cddf", "MainThread", 250, 290, {"call": 0, "batch": 0}),
    ("gpdla.batch.complete", "MainThread", 600, 800, {"call": 0, "batch": 0}),
    ("gpdla.batch.wait", "MainThread", 610, 780, {"call": 0, "batch": 0}),
    ("gpdla.call.finalize", "MainThread", 820, 880, {"call": 0}),
    ("gpdla.call", "MainThread", 1000, 1200, {"call": 1}),
    ("gpdla.call.setup", "MainThread", 1000, 1100, {"call": 1}),
    ("gpdla.batch.issue", "MainThread", 1100, 1150, {"call": 1, "batch": 0}),
    ("gpdla.batch.complete", "MainThread", 1150, 1190, {"call": 1, "batch": 0}),
    ("gpdla.batch.wait", "MainThread", 1155, 1185, {"call": 1, "batch": 0}),
]


def recorded():
    parent = {s[0]: None for s in SPANS}
    return [(name, thread, int(t0 * 1000), int(t1 * 1000), parent[name], ids)
            for name, thread, t0, t1, ids in SPANS]


def x(name, cat, start, dur, tid=TID, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": start, "dur": dur, "pid": 1,
            "tid": tid, "args": args}


def trace_events():
    """The window, the calling thread's spans (a little later on the
    trace's side), launches on the calling thread and on the upload
    thread, and their device ops."""
    main = [s for s in SPANS if s[1] == "MainThread"]
    ev = [x(tr.WINDOW, "user_annotation", OFFSET + 50, 1250)]
    ev += [x(name, "user_annotation", OFFSET + t0 + d, t1 - t0)
           for (name, _, t0, t1, _), d in zip(main, DELAY)]
    ev += [
        x("cudaLaunchKernel", "cuda_runtime", OFFSET + 210, 5, correlation=1),
        x("evidence_kernel", "kernel", OFFSET + 300, 200, tid=9, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", OFFSET + 260, 5, correlation=2),
        x("DeviceRadixSort", "kernel", OFFSET + 500, 60, tid=9, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", OFFSET + 1120, 5, correlation=3),
        x("other_kernel", "kernel", OFFSET + 1150, 10, tid=9, correlation=3),
        x("cudaMemcpyAsync", "cuda_runtime", OFFSET + 160, 2, tid=11, correlation=4),
        x("Memcpy HtoD", "gpu_memcpy", OFFSET + 170, 5, tid=9, correlation=4),
        x("aten::sort", "cpu_op", OFFSET + 255, 20),
    ]
    return ev


def test_the_offset_and_its_spread():
    fit = sp.align(sp.as_spans(recorded()), trace_events())
    assert fit["offset_us"] == pytest.approx(OFFSET) and fit["drift_us_per_s"] == 0
    assert fit["pairs"] == len([s for s in SPANS if s[1] == "MainThread"])
    assert fit["spread_us"] == 0      # one stretch: the envelope is its least difference
    assert fit["delay_iqr_us"] == pytest.approx(2.25) and fit["delay_max_us"] == pytest.approx(4.0)


def test_the_offset_follows_a_drift_between_the_clocks():
    # 640 spans over 10 s, the trace's clock 3 us a second faster, each
    # stamped 0-5 us after the recorder's
    n, drift = 640, 3.0
    spans = [("gpdla.call", "MainThread", int(i * 15625e3), int(i * 15625e3 + 5e6), None, {})
             for i in range(n)]
    events = [x("gpdla.call", "user_annotation",
                OFFSET + s[2] * 1e-3 * (1 + drift * 1e-6) + (i * 7919 % 11) * 0.5, 5e3)
              for i, s in enumerate(spans)]
    fit = sp.align(sp.as_spans(spans), events)
    assert fit["drift_us_per_s"] == pytest.approx(drift, rel=1e-3)
    assert fit["offset_us"] == pytest.approx(OFFSET, abs=0.05)
    assert fit["delay_max_us"] == pytest.approx(5.0, abs=0.1) and fit["spread_us"] < 0.1


def test_alignment_needs_spans_found_in_both():
    with pytest.raises(ValueError, match="fewer than two"):
        sp.align(sp.as_spans(recorded()), [x(tr.WINDOW, "user_annotation", 0, 1)])


def test_device_ops_are_put_down_to_the_span_that_launched_them():
    ev = trace_events()
    fit = {"offset_us": OFFSET, "t_ref_us": 0.0, "drift_us_per_s": 0.0}
    spans = sp.placed(sp.as_spans(recorded()), "MainThread", fit)
    ops = sp.device_ops(ev, OFFSET, OFFSET + 2000)
    by = {op.name: (s.name if s else None, s.ids if s else None)
          for op, s in zip(ops, sp.launched_by(sp.launches(ops, ev), spans, TID))}
    assert by == {
        "evidence_kernel": ("gpdla.stage.single", {"call": 0, "batch": 0}),
        "DeviceRadixSort": ("gpdla.stage.cddf", {"call": 0, "batch": 0}),
        "other_kernel": ("gpdla.batch.issue", {"call": 1, "batch": 0}),
        "Memcpy HtoD": (None, None),              # launched by the upload thread
    }


def test_idle_time_by_span_and_the_quantities():
    out = sp.reduce(trace_events(), recorded())
    assert out["window_s"] == pytest.approx(1250e-6)
    # busy 170-175, 300-560, 1150-1160 in the window 50-1300; the gaps'
    # middles at 110 (setup), 237.5 (the single stage), 855 (finalize)
    # and 1230 (between the calls)
    idle = dict(out["idle_by_span"])
    assert idle == pytest.approx({"gpdla.call.setup": 120e-6, "gpdla.stage.single": 125e-6,
                                  "gpdla.call.finalize": 590e-6, sp.OUTSIDE: 140e-6})
    assert out["idle_s"] == pytest.approx(975e-6) and out["idle_named_share"] == pytest.approx(1)
    assert dict(out["device_by_span"]) == pytest.approx({
        "gpdla.stage.single": 200e-6, "gpdla.stage.cddf": 60e-6, "gpdla.batch.issue": 10e-6,
        "another thread or none": 5e-6})
    assert out["stage_ops_before_their_span"] == 0
    # every instant of the window under the calling thread's innermost
    # span, and every instant of idle time
    assert dict(out["host_by_span"]) == pytest.approx({
        sp.OUTSIDE: 250e-6, "gpdla.call.setup": 200e-6, "gpdla.batch.issue": 75e-6,
        "gpdla.stage.single": 35e-6, "gpdla.stage.cddf": 40e-6, "gpdla.batch.complete": 40e-6,
        "gpdla.batch.wait": 200e-6, "gpdla.call.finalize": 60e-6, "gpdla.call": 350e-6})
    assert dict(out["idle_split_by_span"]) == pytest.approx({
        sp.OUTSIDE: 250e-6, "gpdla.call.setup": 195e-6, "gpdla.batch.issue": 75e-6,
        "gpdla.stage.single": 35e-6, "gpdla.stage.cddf": 40e-6, "gpdla.call": 90e-6,
        "gpdla.batch.complete": 35e-6, "gpdla.batch.wait": 195e-6,
        "gpdla.call.finalize": 60e-6})
    assert out["batches"] == 2
    assert out["call_setup_ms"] == pytest.approx(0.1)
    # the complete spans outside their waits (30 + 10 us) and the finalize (60 us)
    assert out["host_finalize_ms"] == pytest.approx(100e-3 / 2)
    assert out["host_wait_pct"] == pytest.approx(100 * 200 / 1250)
    assert out["reducer_device_ms"] == pytest.approx(60e-3 / 2)


def test_a_stage_op_that_starts_before_its_span_is_counted():
    ev = trace_events()
    ev.append(x("cudaLaunchKernel", "cuda_runtime", OFFSET + 270, 2, correlation=5))
    ev.append(x("early_kernel", "kernel", OFFSET + 240, 5, tid=9, correlation=5))
    assert sp.reduce(ev, recorded())["stage_ops_before_their_span"] == 1


def test_the_trace_summary_ignores_the_programs_annotations():
    plain = [e for e in trace_events() if not e["name"].startswith("gpdla.")]
    events = lambda raw: [tr.Event(e["name"], e["cat"], e["ts"], e["ts"] + e["dur"])
                          for e in raw]
    assert tr.summarize(events(trace_events())) == tr.summarize(events(plain))


def test_the_reducer_reads_nothing_without_a_cddf_stage():
    keep = [s for s in recorded() if s[0] != "gpdla.stage.cddf"]
    ev = [e for e in trace_events() if e["name"] != "gpdla.stage.cddf"]
    assert sp.reduce(ev, keep)["reducer_device_ms"] is None
