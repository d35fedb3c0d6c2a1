"""The port's spans (``utils/observability.trace``) on the CPU: nesting,
parents and the ``call``/``batch`` ids across the calling and writer
threads; nothing done while neither the recorder nor
``torch.profiler`` is on; the calling thread's spans in the profiler's
trace; the drivers' spans, one of each per batch and per call, with the
same results bit for bit whether the recorder is on or off, and the
``[driver]`` lines (``GPDLA_DRIVER_TIMING=1``) read from them."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu_torch.inference import PaddedSpectra
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig
from gp_dla_detection_tpu_torch.parallel.sharded_inference import process_spectra_sharded
from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_sharded
from gp_dla_detection_tpu_torch.utils import observability as obs

from synthetic_problem import make_problem

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BATCH = 4
CALL_SPANS = ("gpdla.call", "gpdla.call.setup", "gpdla.call.drain", "gpdla.call.finalize")
BATCH_SPANS = ("gpdla.batch.upload", "gpdla.batch.issue", "gpdla.batch.complete",
               "gpdla.batch.wait", "gpdla.batch.checkpoint")
STAGES = {"single": ("single", "fetch"), "chain": ("single", "redraw", "pair", "cddf", "fetch")}
MODES = {"full": ("single", {}), "lean": ("single", {"store_sample_likelihoods": False}),
         "chain": ("chain", {"store_sample_likelihoods": False, "store_cddf_inputs": True})}


@pytest.fixture(scope="module")
def problem():
    params, jm, sp, offsets, nhis, prior_z, prior_f = make_problem()
    fields = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}
    model = GPModel.from_numpy(**fields, dtype=torch.float64, device="cpu")
    spectra = PaddedSpectra(sp.wavelengths, sp.flux, sp.noise_variance, sp.mask, sp.z_qso)
    prior_num = np.random.default_rng(7).choice([0, 0, 0, 0, 0, 1, 1, 2], len(prior_z))
    return params, model, spectra, offsets, nhis, prior_z, prior_f, prior_num


def run(problem, mode, depth=1, checkpoint_dir=None):
    params, model, spectra, offsets, nhis, prior_z, prior_f, prior_num = problem
    driver, extra = MODES[mode]
    config = ShardedRunConfig(
        per_device_batch=BATCH, sample_chunk=32, dtype="float64", device="cpu",
        backend="torch", pipeline_depth=depth,
        checkpoint_dir=None if checkpoint_dir is None else str(checkpoint_dir), **extra)
    if driver == "single":
        return process_spectra_sharded(model, offsets, nhis, spectra, prior_z, prior_f,
                                       params=params, config=config)
    return process_spectra_multi_sharded(model, offsets, nhis, spectra, prior_z, prior_num,
                                         params=params, config=config)


def arrays(res) -> dict:
    """Every array of a result, by dotted name."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in arrays(v).items()})
    return out


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spans_nest_and_carry_their_ids_across_threads(problem, tmp_path):
    with obs.recording() as rec:
        run(problem, "lean", depth=4, checkpoint_dir=tmp_path)
    spans = rec.drain()
    n = -(-len(problem[2]) // BATCH)
    (call,) = [s for s in spans if s.name == "gpdla.call"]
    cid = call.ids["call"]
    assert call.parent is None and call.thread == threading.current_thread().name
    assert all(s.ids["call"] == cid for s in spans)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    # the writer thread names its batch; the calling thread's spans take
    # theirs from the span around them, the uploads' among them
    writes = by["gpdla.checkpoint.write"]
    assert sorted(s.ids["batch"] for s in writes) == list(range(n))
    assert all(s.thread.startswith("gpdla-ckpt") and s.parent is None for s in writes)
    uploads = by["gpdla.batch.upload"]
    assert [s.ids["batch"] for s in uploads] == list(range(n))
    assert all(s.thread == call.thread for s in uploads)
    assert "gpdla.loop.wait_upload" not in by   # no upload thread to wait on
    parents = {"gpdla.call.setup": "gpdla.call", "gpdla.batch.upload": "gpdla.call",
               "gpdla.batch.issue": "gpdla.call", "gpdla.batch.complete": "gpdla.call",
               "gpdla.call.drain": "gpdla.call", "gpdla.call.finalize": "gpdla.call",
               "gpdla.stage.single": "gpdla.batch.issue", "gpdla.stage.fetch": "gpdla.batch.issue",
               "gpdla.batch.wait": "gpdla.batch.complete",
               "gpdla.batch.checkpoint": "gpdla.batch.complete"}
    for name, parent in parents.items():
        assert by[name] and all(s.parent == parent for s in by[name]), name
    issues = {s.ids["batch"]: s for s in by["gpdla.batch.issue"]}
    for s in by["gpdla.stage.single"] + by["gpdla.stage.fetch"]:
        outer = issues[s.ids["batch"]]
        assert outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns
    setup, = by["gpdla.call.setup"]
    assert call.t0_ns <= setup.t0_ns and setup.t1_ns <= min(s.t0_ns for s in by["gpdla.batch.issue"])
    assert max(s.t1_ns for s in spans if s.name != "gpdla.call") <= call.t1_ns
    # a write follows its hand-off
    hand = {s.ids["batch"]: s for s in by["gpdla.batch.checkpoint"]}
    assert all(w.t0_ns >= hand[w.ids["batch"]].t0_ns for w in by["gpdla.checkpoint.write"])


def test_off_no_span_is_made_and_no_range_entered(problem, monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(obs._torch_profiler, "record_function", no_range)
    monkeypatch.delenv("GPDLA_DRIVER_TIMING", raising=False)
    assert obs._recorders == ()
    assert obs.trace("gpdla.call", call=1) is obs.trace("x")
    run(problem, "chain", depth=4)
    with obs.recording() as rec:
        pass
    assert rec.drain() == []
    assert obs.current_call() is None


def test_the_calling_threads_spans_are_in_the_profilers_trace(problem, tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run(problem, "full", depth=4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = Counter(e["name"] for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"].startswith("gpdla."))
    n = -(-len(problem[2]) // BATCH)
    for name in ("gpdla.call", "gpdla.call.setup", "gpdla.call.finalize", "gpdla.call.drain"):
        assert names[name] == 1, name
    for name in ("gpdla.batch.issue", "gpdla.batch.complete", "gpdla.batch.wait",
                 "gpdla.stage.single"):
        assert names[name] == n, name


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("mode", ["full", "lean", "chain"])
def test_driver_spans_once_per_batch_and_call_and_the_same_bits(problem, mode, depth,
                                                                 monkeypatch):
    off = arrays(run(problem, mode, depth=depth))
    monkeypatch.setenv("GPDLA_DRIVER_TIMING", "1")
    out = io.StringIO()
    with obs.recording() as rec, contextlib.redirect_stdout(out):
        on = arrays(run(problem, mode, depth=depth))
    assert sorted(on) == sorted(off)
    for k, v in off.items():
        np.testing.assert_array_equal(on[k], v, err_msg=k)
    spans = rec.drain()
    n = -(-len(problem[2]) // BATCH)
    count = Counter(s.name for s in spans)
    for name in CALL_SPANS:
        assert count[name] == 1, name
    stages = [f"gpdla.stage.{s}" for s in STAGES[MODES[mode][0]]]
    for name in BATCH_SPANS + tuple(stages):
        per_batch = Counter(s.ids["batch"] for s in spans if s.name == name)
        assert per_batch == {b: 1 for b in range(n)}, name
    assert count["gpdla.loop.wait_upload"] == 0   # no loop has an upload thread
    means = load_chip_smoke().stage_means(out.getvalue())
    assert sorted(means) == ["batches", "dispatch", "fetch", "upload"]
    assert means["batches"] == n and all(means[k] >= 0 for k in ("upload", "dispatch", "fetch"))


def test_recorders_nest_and_drain_across_threads():
    with obs.recording() as outer:
        with obs.trace("a", call=1):
            with obs.recording() as inner:
                worker = threading.Thread(target=lambda: obs.trace("b", batch=2).__enter__()
                                          .__exit__(None, None, None))
                worker.start()
                worker.join(timeout=10)
            with obs.trace("c", batch=3):
                pass
    assert not worker.is_alive()
    assert [(s.name, s.parent, s.ids) for s in inner.drain()] == [("b", None, {"batch": 2})]
    got = [(s.name, s.parent, s.ids) for s in outer.drain()]
    assert got == [("b", None, {"batch": 2}), ("c", "a", {"call": 1, "batch": 3}),
                   ("a", None, {"call": 1})]
    assert outer.drain() == []


def test_a_span_closes_and_passes_on_the_exception():
    with obs.recording() as rec:
        with pytest.raises(KeyError):
            with obs.trace("outer"):
                with obs.trace("inner"):
                    raise KeyError("propagates")
        with obs.trace("after"):
            pass
    assert [(s.name, s.parent) for s in rec.drain()] == [
        ("inner", "outer"), ("outer", None), ("after", None)]

