"""The 95th percentile over every call of the window, each timed from
the call to its return with its results on the host (host clock)."""

import numpy as np

NAME, UNIT, BETTER, SOURCE = "call_p95_ms", "ms", "lower", "host_clock"


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([1e3 * (t1 - t0) for t0, t1, _ in run.calls], 95))
