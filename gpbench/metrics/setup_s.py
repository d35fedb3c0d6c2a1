"""Process start to window start: imports, the CUDA context, the
kernels' libraries, the traffic synthesis and the warm-up (host clock)."""

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"


def read(run):
    return run.setup_s
