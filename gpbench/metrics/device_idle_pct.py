"""The share of the traced window that no kernel, copy or fill covers."""

from gpbench.metrics import _device

NAME, UNIT, BETTER, SOURCE = "device_idle_pct", "%", "lower", "device_trace"
LAYER = "device"


def read(run):
    return _device.idle(run)
