"""Device kernels the traced window launched per batch its calls made:
what a batch enqueues."""

from gpbench.metrics import _device

NAME, UNIT, BETTER, SOURCE = "kernels_per_batch", "kernels/batch", "lower", "device_trace"
LAYER = "drivers"


def read(run):
    return _device.kernels_per_batch(run)
