"""Observability: debug logging, wall-clock timing, device profiling.

The reference's observability is a swappable no-op debug printer
(set_parameters.m:91-92), tic/toc per spectrum (process_qsos.m:89,219)
and progress lines (preload_qsos.m:69-70).  Equivalents here:

  - :func:`debug_print` — gated by GPDLA_DEBUG=1 or :func:`set_debug`
  - :class:`Timer` / :func:`stage_timer` — stage wall-clock timing
  - :class:`ProgressMeter` — the spectra/sec throughput counter
  - :func:`trace` — the program's one span (below)

A copy of ``gp_dla_detection_tpu/utils/observability.py``; only
:func:`trace` differs (the JAX package's annotates jax.profiler traces),
and the span recorder's entry points are attributes outside ``__all__``
(which stays the JAX module's): :func:`recording` and
:class:`Recorder`, :class:`Span`, and the drivers' :func:`driver_call`
and :func:`current_call`.

Spans.  ``trace(name, **ids)`` costs two flag checks while neither a
recorder nor ``torch.profiler`` is on.  Under ``torch.profiler`` it
opens a ``record_function`` range of the same name, so the calling
thread's spans sit in the profiler's trace beside the kernels (the
profiler records no range of another thread, and drops ``ids``).  While
a recorder is on (``with recording() as rec``) every span of every
thread lands in ``rec`` as a :class:`Span` on the ``time.perf_counter_ns``
clock; ``rec.drain()`` hands them over.  A span's ``ids`` are its own
over those of the span around it on its thread; spans on other threads
name theirs.  No span waits for the card.

The drivers' spans (``parallel/``), with ``call`` (a count of driver
calls) and ``batch`` in their ids: ``gpdla.call`` (one driver call)
holding ``gpdla.call.setup`` (entry to the loop's start),
``gpdla.batch.upload`` (the host slice/pad and the enqueue of the
copies to the card), ``gpdla.batch.issue`` (its stages
``gpdla.stage.single``, ``.redraw``, ``.pair``, ``.cddf`` and ``.fetch``,
the enqueue of the copies to the host; the evidence stages ``.single``
and ``.pair`` also carry ``lines``, the Lyman lines, and ``window``, the
kernel's sample window in pixels, 0 for the full grid), ``gpdla.batch.complete``
(``gpdla.batch.wait``, the host blocked on the card, and
``gpdla.batch.checkpoint``, the hand-off to the writer),
``gpdla.call.drain`` (the checkpoint writer's exit) and
``gpdla.call.finalize`` (the posteriors after the loop); on the
checkpoint writer's thread ``gpdla.checkpoint.write``.
``GPDLA_DRIVER_TIMING=1`` records each driver call's spans and prints a
line per batch from them (``parallel.batches.BatchLog``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import NamedTuple

import torch.autograd.profiler as _torch_profiler

__all__ = [
    "set_debug",
    "debug_print",
    "env_flag",
    "Timer",
    "stage_timer",
    "ProgressMeter",
    "trace",
]


def env_flag(name: str) -> bool:
    """The repo-wide boolean env-var convention: unset, empty, and "0"
    are False; anything else is True (so NAME=0 disables, matching
    GPDLA_DEBUG)."""
    return os.environ.get(name, "") not in ("", "0")


_debug_enabled = env_flag("GPDLA_DEBUG")


def set_debug(enabled: bool) -> None:
    """Toggle debug output (the fprintf_debug swap, set_parameters.m:92)."""
    global _debug_enabled
    _debug_enabled = enabled


def debug_print(fmt: str, *args, **kwargs) -> None:
    if _debug_enabled:
        print(fmt % args if args else fmt, file=sys.stderr, flush=True, **kwargs)


class Timer:
    """Context-manager wall clock (tic/toc, process_qsos.m:89,219)."""

    def __init__(self, label: str = "", report=None):
        self.label = label
        self.report = report
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.report is not None:
            self.report(f"{self.label} took {self.elapsed:0.3f}s.")
        else:
            debug_print("%s took %0.3fs.", self.label, self.elapsed)


def stage_timer(fn):
    """Decorator: debug-log the wall time of a pipeline stage."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with Timer(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


class ProgressMeter:
    """Throughput counter: items/sec with periodic reporting."""

    def __init__(self, total: int, unit: str = "spectra", every: float = 10.0,
                 stream=sys.stderr):
        self.total = total
        self.unit = unit
        self.every = every
        self.stream = stream
        self.count = 0
        self._t0 = time.perf_counter()
        self._last_report = self._t0

    def update(self, n: int = 1) -> None:
        self.count += n
        now = time.perf_counter()
        if now - self._last_report >= self.every or self.count >= self.total:
            rate = self.count / max(now - self._t0, 1e-9)
            print(
                f"[{self.count}/{self.total}] {rate:0.2f} {self.unit}/s",
                file=self.stream,
                flush=True,
            )
            self._last_report = now

    @property
    def rate(self) -> float:
        return self.count / max(time.perf_counter() - self._t0, 1e-9)


class Span(NamedTuple):
    """A closed span as a recorder holds it: ``parent`` is the name of the
    span around it on its thread (None at the top), ``thread`` its
    thread's name, the times ``time.perf_counter_ns``."""

    name: str
    thread: str
    t0_ns: int
    t1_ns: int
    parent: str | None
    ids: dict


class Recorder:
    """The spans closed while it was on, in the order they closed."""

    def __init__(self):
        self._spans: deque = deque()   # append and popleft are thread-safe

    def drain(self) -> list:
        """The spans recorded since the last drain, oldest first."""
        return [self._spans.popleft() for _ in range(len(self._spans))]


_recorders: tuple = ()   # the recorders on; replaced whole, never mutated
_recorders_lock = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """A :class:`Recorder` of every span that closes in the block, on any
    thread.  Recorders nest: each gets every span."""
    global _recorders
    rec = Recorder()
    with _recorders_lock:
        _recorders = _recorders + (rec,)
    try:
        yield rec
    finally:
        with _recorders_lock:
            _recorders = tuple(r for r in _recorders if r is not rec)


def _open_spans() -> list:
    stack = getattr(_local, "spans", None)
    if stack is None:
        stack = _local.spans = []
    return stack


class _Span:
    __slots__ = ("name", "ids", "parent", "t0", "range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if outer is not None and outer.ids:
            self.ids = {**outer.ids, **self.ids}
        stack.append(self)
        # stamped outside the profiler's range, so that the recorded span
        # holds the range (gpbench/spans.py aligns the two clocks on it)
        self.t0 = time.perf_counter_ns()
        self.range = None
        if _torch_profiler._is_profiler_enabled:
            self.range = _torch_profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        recorders = _recorders
        if recorders:
            span = Span(self.name, threading.current_thread().name, self.t0, t1,
                        self.parent, self.ids)
            for rec in recorders:
                rec._spans.append(span)
        return False


def trace(name: str, **ids):
    """The span ``name`` over a ``with`` block, with identifiers ``ids``
    (module docstring): a no-op unless a recorder or ``torch.profiler``
    is on.  Exceptions raised in the traced block propagate unchanged."""
    if not (_recorders or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, ids)


_call_ids = itertools.count()


class DriverCall:
    """A driver call in progress on this thread (:func:`driver_call`):
    its ``id``, and its own recorder under ``GPDLA_DRIVER_TIMING=1``."""

    __slots__ = ("id", "recorder", "_setup")

    def __init__(self, call_id: int, recorder):
        self.id, self.recorder, self._setup = call_id, recorder, None

    def end_setup(self) -> None:
        """Close ``gpdla.call.setup``: the loop starts."""
        setup, self._setup = self._setup, None
        if setup is not None:
            setup.__exit__(None, None, None)


def driver_call(fn):
    """``fn`` (a driver) as one driver call: a new ``call`` id, the
    spans ``gpdla.call`` and ``gpdla.call.setup`` (open until the driver
    ends it, at the latest until ``fn`` returns or raises), and under
    ``GPDLA_DRIVER_TIMING=1`` a recorder of the call's spans."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        calls = getattr(_local, "calls", None)
        if calls is None:
            calls = _local.calls = []
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(recording()) if env_flag("GPDLA_DRIVER_TIMING") else None
            this = DriverCall(next(_call_ids), rec)
            stack.enter_context(trace("gpdla.call", call=this.id))
            this._setup = trace("gpdla.call.setup").__enter__()
            stack.callback(this.end_setup)
            calls.append(this)
            stack.callback(calls.pop)
            return fn(*args, **kwargs)

    return call


def current_call() -> DriverCall | None:
    """The innermost driver call in progress on this thread."""
    calls = getattr(_local, "calls", None)
    return calls[-1] if calls else None
