"""Host utilities: observability (timing, debug logging, profiler
ranges), atomic file writes and the synthetic flagship workload.

Counterpart of ``gp_dla_detection_tpu/utils``; the JAX package's
compilation cache serves jax and is not ported.
"""

from .atomic_io import atomic_savez, atomic_write_json
from .observability import (
    ProgressMeter,
    Timer,
    debug_print,
    env_flag,
    set_debug,
    stage_timer,
    trace,
)
from .synthetic import synthetic_workload

__all__ = [
    "ProgressMeter",
    "Timer",
    "atomic_savez",
    "atomic_write_json",
    "debug_print",
    "env_flag",
    "set_debug",
    "stage_timer",
    "synthetic_workload",
    "trace",
]
