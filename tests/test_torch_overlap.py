"""The port's compute/transfer overlap (gp_dla_detection_tpu_torch/
parallel/overlap.py), held to the JAX package's contracts.

tests/test_overlap.py's nine cases, run against the port's module: the
pipelined loop completes every item exactly once and in order while
keeping the dispatch-ahead bound, on the calling thread, with every
callback's exception propagating; the background writer preserves write
order and surfaces worker errors; atomic writes never leave torn files
behind.  One more case holds the port's ``run_pipelined_split`` to the
JAX module's: the same issue and complete calls in the same program
order at depths 1-4, against the JAX loop with and without its upload
thread, each upload right before its issue.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.parallel import overlap as jax_overlap
from gp_dla_detection_tpu_torch.parallel import overlap
from gp_dla_detection_tpu_torch.parallel.overlap import (
    BackgroundWriter,
    atomic_savez,
    atomic_write_json,
    run_pipelined,
    run_pipelined_split,
)


def test_run_pipelined_completes_all_in_order():
    events = []
    run_pipelined(
        range(5),
        dispatch=lambda i: (events.append(("d", i)), i * 10)[1],
        complete=lambda i, s: events.append(("c", i, s)),
        depth=2,
    )
    assert [e for e in events if e[0] == "c"] == [
        ("c", i, i * 10) for i in range(5)
    ]
    # double buffering: item 1 dispatched BEFORE item 0 completes
    assert events.index(("d", 1)) < events.index(("c", 0, 0))
    # bounded lookahead: item 3 dispatched only after item 0 completed
    assert events.index(("c", 0, 0)) < events.index(("d", 3))


def test_run_pipelined_threaded_overlaps_and_bounds():
    """The one loop runs both callbacks on the calling thread: it
    completes in order, keeps at most ``depth`` items dispatched but not
    completed, dispatches the next item only once the oldest completed,
    and an exception from either callback propagates at once, with
    nothing dispatched or completed after it and no thread left."""
    main = threading.get_ident()
    completed, events, inflight = [], [], []
    n_inflight = 0

    def dispatch(i):
        nonlocal n_inflight
        assert threading.get_ident() == main
        n_inflight += 1
        inflight.append(n_inflight)
        events.append(("d", i))
        return i * 10

    def complete(i, s):
        nonlocal n_inflight
        assert threading.get_ident() == main
        completed.append((i, s))
        n_inflight -= 1
        events.append(("c", i))

    run_pipelined(range(6), dispatch, complete, depth=3)
    assert completed == [(i, i * 10) for i in range(6)]
    assert max(inflight) == 3  # strict dispatched-not-completed bound, reached
    assert events.index(("c", 0)) < events.index(("d", 3)) < events.index(("c", 1))

    # complete() exceptions propagate before anything more is dispatched
    dispatched = []
    with pytest.raises(RuntimeError, match="fetch died"):
        run_pipelined(
            range(100),
            dispatch=lambda i: dispatched.append(i) or i,
            complete=lambda i, s: (_ for _ in ()).throw(
                RuntimeError("fetch died")
            ),
            depth=2,
        )
    assert dispatched == [0, 1]

    # dispatch() exceptions propagate too
    def bad_dispatch(i):
        if i == 2:
            raise OSError("upload died")
        return i

    done = []
    with pytest.raises(OSError, match="upload died"):
        run_pipelined(range(10), bad_dispatch, lambda i, s: done.append(i), depth=2)
    assert done == [0]
    assert not [t for t in threading.enumerate() if t.name.startswith("gpdla-")]


def test_run_pipelined_depth_one_is_serial():
    events = []
    run_pipelined(
        range(3),
        dispatch=lambda i: events.append(("d", i)),
        complete=lambda i, s: events.append(("c", i)),
        depth=1,
    )
    assert events == [
        ("d", 0), ("c", 0), ("d", 1), ("c", 1), ("d", 2), ("c", 2),
    ]
    with pytest.raises(ValueError, match="depth"):
        run_pipelined([], lambda i: i, lambda i, s: None, depth=0)


def test_run_pipelined_split_serial_schedule():
    """The split loop is the pipelined loop with upload+issue fused as
    dispatch: the same bounded lookahead."""
    events = []
    run_pipelined_split(
        range(5),
        upload=lambda i: (events.append(("u", i)), i)[1],
        issue=lambda i, u: (events.append(("i", i)), u * 10)[1],
        complete=lambda i, s: events.append(("c", i, s)),
        depth=2,
    )
    assert [e for e in events if e[0] == "c"] == [
        ("c", i, i * 10) for i in range(5)
    ]
    assert events.index(("i", 1)) < events.index(("c", 0, 0))
    assert events.index(("c", 0, 0)) < events.index(("u", 3))


def test_run_pipelined_split_threaded_deterministic_issue_order():
    """The load-bearing contract for multi-rank runs: upload, issue and
    complete land on the CALLING thread in the serial schedule's exact
    program order (upload_0, issue_0, upload_1, issue_1, complete_0,
    upload_2, issue_2, ... at depth 2) however long the uploads take, so
    that every rank issues its collectives in one order; at most
    ``depth`` items are uploaded but not completed."""
    main = threading.get_ident()
    schedule = []
    inflight_hwm = [0]
    n_up = [0]

    def upload(i):
        assert threading.get_ident() == main
        # jitter: odd uploads are slow — must not perturb the schedule
        time.sleep(0.005 if i % 2 else 0.0)
        n_up[0] += 1
        inflight_hwm[0] = max(inflight_hwm[0], n_up[0])
        schedule.append(("u", i))
        return i

    def issue(i, u):
        assert threading.get_ident() == main
        schedule.append(("i", i))
        return u * 10

    def complete(i, s):
        assert threading.get_ident() == main
        schedule.append(("c", i, s))
        n_up[0] -= 1

    for _ in range(3):  # schedule must be stable across repeats
        schedule.clear()
        run_pipelined_split(range(5), upload, issue, complete, depth=2)
        assert schedule == [
            ("u", 0), ("i", 0), ("u", 1), ("i", 1), ("c", 0, 0), ("u", 2), ("i", 2),
            ("c", 1, 10), ("u", 3), ("i", 3), ("c", 2, 20), ("u", 4), ("i", 4),
            ("c", 3, 30), ("c", 4, 40),
        ]
    assert inflight_hwm[0] == 2


def test_run_pipelined_split_threaded_errors_propagate():
    # upload() exceptions propagate, before that item's issue
    def bad_upload(i):
        if i == 2:
            raise OSError("upload died")
        return i

    done, issued = [], []
    with pytest.raises(OSError, match="upload died"):
        run_pipelined_split(
            range(10), bad_upload, lambda i, u: issued.append(i) or u,
            lambda i, s: done.append(i), depth=2,
        )
    assert (issued, done) == ([0, 1], [0])  # issue_0, issue_1, complete_0, then the raise

    # issue() and complete() exceptions propagate as well
    with pytest.raises(RuntimeError, match="issue died"):
        run_pipelined_split(
            range(10), lambda i: i,
            lambda i, u: (_ for _ in ()).throw(RuntimeError("issue died")),
            lambda i, s: None, depth=2,
        )
    uploaded = []
    with pytest.raises(RuntimeError, match="fetch died"):
        run_pipelined_split(
            range(100), lambda i: uploaded.append(i) or i, lambda i, u: u,
            lambda i, s: (_ for _ in ()).throw(RuntimeError("fetch died")),
            depth=2,
        )
    assert uploaded == [0, 1]
    # no thread left behind
    assert not [t for t in threading.enumerate() if t.name.startswith("gpdla-")]


def test_background_writer_ordered_and_raises():
    order = []
    lock = threading.Lock()

    def work(i, delay):
        time.sleep(delay)
        with lock:
            order.append(i)

    with BackgroundWriter() as w:
        w.submit(work, 0, 0.05)  # slow first write must still land first
        w.submit(work, 1, 0.0)
        w.submit(work, 2, 0.0)
    assert order == [0, 1, 2]

    # worker errors surface at close (via the context manager exit)
    def boom():
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        with BackgroundWriter() as w:
            w.submit(boom)

    # ... or at a later submit, whichever comes first
    w2 = BackgroundWriter()
    try:
        w2.submit(boom)
        deadline = time.time() + 10.0
        while not w2._pending[0].done() and time.time() < deadline:
            time.sleep(0.01)  # deterministic: wait for the failure to land
        with pytest.raises(OSError, match="disk full"):
            w2.submit(time.sleep, 0)
    finally:
        w2._pool.shutdown(wait=True, cancel_futures=True)


def test_background_writer_error_exit_does_not_mask(tmp_path):
    """An exception inside the with-block propagates unchanged even if a
    queued write also failed."""
    with pytest.raises(KeyError, match="original"):
        with BackgroundWriter() as w:
            w.submit(lambda: (_ for _ in ()).throw(OSError("late")))
            raise KeyError("original")


def test_atomic_writes_no_torn_files(tmp_path):
    target = tmp_path / "batch_000001.npz"
    atomic_savez(target, a=np.arange(5), b=np.eye(2))
    with np.load(target) as f:
        np.testing.assert_array_equal(f["a"], np.arange(5))
        np.testing.assert_array_equal(f["b"], np.eye(2))
    # overwrite is atomic too, and no .tmp remnants remain
    atomic_savez(target, a=np.zeros(3))
    with np.load(target) as f:
        np.testing.assert_array_equal(f["a"], np.zeros(3))
    mpath = tmp_path / "manifest.json"
    atomic_write_json(mpath, {"completed_batches": [0, 1]})
    assert json.loads(mpath.read_text()) == {"completed_batches": [0, 1]}
    assert list(tmp_path.iterdir()) and not list(tmp_path.glob("*.tmp"))


def split_schedule(split, depth: int, n: int = 7, **kw):
    """The calls ``split`` makes on a calling-thread list and a side-thread
    list: each in the order it made them."""
    main = threading.get_ident()
    calls = {"main": [], "side": []}

    def record(*event):
        calls["main" if threading.get_ident() == main else "side"].append(event)

    split(
        range(n),
        upload=lambda i: (record("u", i), i)[1],
        issue=lambda i, u: (record("i", i, u), u * 10)[1],
        complete=lambda i, s: record("c", i, s),
        depth=depth,
        **kw,
    )
    return calls


@pytest.mark.parametrize("threaded", [False, True], ids=["serial", "threaded"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_run_pipelined_split_schedule_equals_jax(depth, threaded):
    """The port's loop makes the JAX loop's issue and complete calls in
    the JAX loop's program order on the calling thread, with or without
    the JAX loop's upload thread; the port's uploads run there too, in
    item order, each right before its issue (without the thread, the
    JAX loop's calls exactly)."""
    ours = split_schedule(run_pipelined_split, depth)
    jax = split_schedule(jax_overlap.run_pipelined_split, depth, threaded=threaded)
    assert ours["side"] == []
    drop_uploads = lambda calls: [e for e in calls if e[0] != "u"]
    assert drop_uploads(ours["main"]) == drop_uploads(jax["main"])
    if not threaded:
        assert ours == jax
    for i in range(7):
        assert ours["main"].index(("u", i)) + 1 == ours["main"].index(("i", i, i))
    assert [e for e in ours["main"] if e[0] == "c"] == [("c", i, i * 10) for i in range(7)]
    with pytest.raises(ValueError, match="depth"):
        run_pipelined_split([], lambda i: i, lambda i, u: u, lambda i, s: None, depth=0)
    with pytest.raises(ValueError, match="depth"):
        jax_overlap.run_pipelined_split([], lambda i: i, lambda i, u: u, lambda i, s: None,
                                        depth=0, threaded=threaded)
    with pytest.raises(ValueError, match="depth"):
        overlap.check_depth(0)


def test_transfers_on_the_cpu_hand_tensors_through():
    """On the CPU the device side of the three stages is plain tensors
    (the dtype converted on the host) and no events."""
    t = overlap.Transfers("cpu")
    assert t.copy_stream is None
    mask = np.array([[True, False]])
    up = t.upload((np.array([[1.0, 2.5]]), torch.float32), (mask, torch.bool))
    assert up[1] is None
    x, m = t.take(up)
    assert x.dtype == torch.float32 and x.tolist() == [[1.0, 2.5]]
    assert m.dtype == torch.bool and m.tolist() == [[True, False]]
    host = t.wait(t.to_host(x * 2, np.arange(3)))
    assert host[0].tolist() == [[2.0, 5.0]]
    np.testing.assert_array_equal(host[1], np.arange(3))


def test_transfers_record_the_results_event_on_their_cards_stream(monkeypatch):
    """The result copies run on the current stream of their tensors'
    card; the event ``complete`` waits on is recorded on that stream too,
    with that card current, whichever card the thread had current (a
    rank on its second card: the copies could otherwise land after the
    wait).  A result on another card is refused."""
    log = []
    card = torch.device("cuda", 1)

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return card

    class Event:
        def record(self, stream=None):
            log.append(("record", stream, current))

    class Device:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            nonlocal current
            self.prev, current = current, self.device

        def __exit__(self, *exc):
            nonlocal current
            current = self.prev

    current = torch.device("cuda", 0)

    def pinned(shape, dtype):
        log.append(("pinned", current))
        return torch.empty(shape, dtype=dtype)

    monkeypatch.setattr(torch.cuda, "Stream", lambda device: ("copy stream", device))
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream", device))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(overlap, "_pinned", pinned)
    t = overlap.Transfers(card)
    value = torch.arange(3.0).as_subclass(OnCard)
    host, done = t.to_host(value, np.arange(2))
    assert log == [("pinned", card), ("record", ("stream", card), card)]
    assert torch.equal(host[0].as_subclass(torch.Tensor), torch.arange(3.0))
    np.testing.assert_array_equal(host[1], np.arange(2))
    assert current == torch.device("cuda", 0)
    card = torch.device("cuda", 2)
    with pytest.raises(ValueError, match="not on cuda:1"):
        t.to_host(value)
