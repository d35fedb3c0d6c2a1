"""Observability: debug logging, wall-clock timing, device profiling.

The reference's observability is a swappable no-op debug printer
(set_parameters.m:91-92), tic/toc per spectrum (process_qsos.m:89,219)
and progress lines (preload_qsos.m:69-70).  Equivalents here:

  - :func:`debug_print` — gated by GPDLA_DEBUG=1 or :func:`set_debug`
  - :class:`Timer` / :func:`stage_timer` — stage wall-clock timing
  - :class:`ProgressMeter` — the spectra/sec throughput counter
  - :func:`trace` — torch.profiler ``record_function`` range (shows up
    in a ``torch.profiler`` trace beside the device kernels)

A copy of ``gp_dla_detection_tpu/utils/observability.py``; only
:func:`trace` differs (the JAX package's annotates jax.profiler traces).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

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


@contextlib.contextmanager
def trace(name: str):
    """A ``torch.profiler.record_function`` range named ``name``.

    Exceptions raised in the traced block propagate unchanged."""
    from torch.profiler import record_function

    with record_function(name):
        yield
