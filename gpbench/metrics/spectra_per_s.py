"""Spectra whose results reached the host in the window, over the whole
window (host clock)."""

NAME, UNIT, BETTER, SOURCE = "spectra_per_s", "spectra/s", "higher", "host_clock"


def read(run):
    return run.spectra / run.window_s if run.window_s > 0 else None
