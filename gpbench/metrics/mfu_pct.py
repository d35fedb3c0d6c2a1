"""The whole inference step's share of the card's peak: the frozen count
of every kernel of a batch (null, single, and for the chain the redraw,
pair and CDDF sums) times the batches the traced window completed, as
least time at the peaks, over the window."""

from gpbench.metrics import _device

NAME, UNIT, BETTER, SOURCE = "mfu_pct", "%", "higher", "device_trace"
LAYER = "whole step"


def read(run):
    return _device.mfu(run)
