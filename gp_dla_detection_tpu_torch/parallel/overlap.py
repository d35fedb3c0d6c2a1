"""Compute/transfer overlap for the drivers.

Counterpart of ``gp_dla_detection_tpu/parallel/overlap.py``.  A serial
driver runs

    slice -> upload -> compute -> blocking fetch -> savez -> next batch

on one critical path, so the card waits for the host between batches.
This module supplies the pieces that break that serialization:

  - :func:`run_pipelined` -- a bounded in-flight dispatch/complete loop:
    batch i+1's upload and compute are enqueued before batch i's results
    are fetched, so the card computes while the host fetches and does
    its bookkeeping;
  - :func:`run_pipelined_split` -- the same with dispatch split into
    ``upload`` (host slice/pad and the copy to the device: no
    collectives) and ``issue`` (the batch's computation, which may carry
    collectives), so that each stage has a span of its own;
  - :class:`BackgroundWriter` -- a single-worker ordered writer moving
    the checkpoint and manifest writes off the critical path;
  - :class:`Transfers` -- the device side of the three stages: pinned
    host buffers, non-blocking copies on a copy stream of their own and
    the CUDA events that order them against the compute stream.

Checkpoint files are written atomically (tmp + os.replace): a SIGKILL
mid-write leaves either the old state or the new state, never a corrupt
npz/manifest -- load-bearing for the kill/resume contract.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.atomic_io import atomic_savez, atomic_write_json
from ..utils.observability import trace

__all__ = [
    "BackgroundWriter",
    "Transfers",
    "atomic_savez",
    "atomic_write_json",
    "check_depth",
    "run_pipelined",
    "run_pipelined_split",
]


def check_depth(depth: int) -> None:
    """Raise unless ``depth`` (the items in flight) is at least 1."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")


def run_pipelined(items, dispatch, complete, depth: int = 2):
    """Run ``complete(item, dispatch(item))`` over ``items`` with up to
    ``depth`` dispatched items in flight.

    ``dispatch`` should enqueue device work and return without blocking
    (its return value is handed to ``complete`` unchanged); ``complete``
    fetches results and does host-side bookkeeping.  ``depth=1``
    degenerates to the serial loop; ``depth=2`` is classic double
    buffering (one batch computing while the previous one drains).
    Both callbacks run on the calling thread, in item order, in one
    program order (dispatch_0 .. dispatch_{d-1}, then complete_{i-d+1},
    dispatch_i, ...), so that every rank of a process group issues its
    collectives alike; an exception from either propagates at once.
    """
    check_depth(depth)
    inflight: deque = deque()
    for item in items:
        inflight.append((item, dispatch(item)))
        while len(inflight) >= depth:
            done_item, state = inflight.popleft()
            complete(done_item, state)
    while inflight:
        done_item, state = inflight.popleft()
        complete(done_item, state)


def run_pipelined_split(items, upload, issue, complete, depth: int = 2):
    """:func:`run_pipelined` with the dispatch stage split into
    ``upload`` (host slice/pad and the copy to the device: no
    collectives) and ``issue`` (the batch's computation, enqueued on the
    device; it may carry collectives): ``dispatch = issue(item,
    upload(item))``, so that every rank issues its collective-bearing
    operations (the sample-axis gathers, ``fetch_global``'s all-gathers)
    in one identical order.
    """
    run_pipelined(items, lambda item: issue(item, upload(item)), complete, depth=depth)


class BackgroundWriter:
    """Ordered background execution of checkpoint writes.

    One worker thread keeps writes (and the manifest updates that must
    follow them) in submission order.  Worker exceptions surface at the
    next :meth:`submit` or at :meth:`close` -- never silently.  As a
    context manager, the success path closes (waits + re-raises); an
    exceptional exit abandons pending writes without masking the
    original error.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gpdla-ckpt")
        self._pending: deque = deque()

    def submit(self, fn, *args) -> None:
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()  # re-raise worker errors
        self._pending.append(self._pool.submit(fn, *args))

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "BackgroundWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            with trace("gpdla.call.drain"):
                self.close()
        else:
            self._pool.shutdown(wait=True, cancel_futures=True)
        return False


def _pinned(shape, dtype) -> torch.Tensor:
    """An empty page-locked host tensor (raises where nothing can pin)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class Transfers:
    """The host <-> device copies of the pipelined drivers on ``device``.

    On a CUDA device, :meth:`upload` (``upload``) stages host
    arrays in pinned buffers and copies them to the card with
    non-blocking copies on a copy stream of its own, then records an
    event; :meth:`take` (``issue``) makes the compute stream wait on that
    event and marks the tensors as used there, so the caching allocator
    does not hand their blocks on before the compute stream is done with
    them; :meth:`to_host` (``issue``) enqueues non-blocking copies of the
    batch's results into pinned buffers behind its work and records an
    event, which :meth:`wait` (``complete``) waits on.  Nothing of this
    waits for the card on the host except :meth:`wait`, and nothing
    falls back: a failed pin, copy or record raises.  On the CPU the same
    calls hand plain tensors through, with no events.
    """

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    def upload(self, *arrays):
        """``(array, dtype)`` pairs as device tensors of those dtypes,
        and the event of their copies (None on the CPU).  The dtype
        conversion happens on the host (float64 -> float32 rounds as on
        the card)."""
        if self.copy_stream is None:
            return [torch.as_tensor(np.asarray(a)).to(dt) for a, dt in arrays], None
        out = []
        with torch.cuda.stream(self.copy_stream):
            for a, dt in arrays:
                a = np.ascontiguousarray(a)
                host = _pinned(a.shape, dt)
                host.copy_(torch.from_numpy(a))
                out.append(host.to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        return out, done

    def take(self, uploaded) -> list:
        """The tensors of :meth:`upload`, ready for the current stream."""
        tensors, done = uploaded
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    def to_host(self, *values):
        """Enqueue the copies of ``values`` (tensors on this device; host
        arrays pass through) into host buffers on the device's current
        stream: (the host values, the event that marks them landed, None
        on the CPU)."""
        on_card = [isinstance(v, torch.Tensor) and v.is_cuda for v in values]
        if not any(on_card):
            return [v.detach() if isinstance(v, torch.Tensor) else v for v in values], None
        for v, card in zip(values, on_card):
            if card and v.device != self.device:
                raise ValueError(f"a result on {v.device}, not on {self.device}")
        # a copy runs on the current stream of its tensor's card, which
        # need not be the thread's current card: the event is recorded
        # on that card's stream, behind the copies
        with torch.cuda.device(self.device):
            host = [
                _pinned(v.shape, v.dtype).copy_(v, non_blocking=True) if card else v
                for v, card in zip(values, on_card)
            ]
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def wait(fetched) -> list:
        """The host values of :meth:`to_host`, once their copies landed."""
        host, done = fetched
        with trace("gpdla.batch.wait"):
            if done is not None:
                done.synchronize()
        return host
