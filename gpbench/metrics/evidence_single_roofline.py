"""The single-DLA evidence kernel's share of its roofline: the frozen
count's least time at the published peaks over the device time of every
kernel the call launches (``csrc/evidence.cu``: ``table_kernel`` and
``evidence_kernel<K, false>``), from the device trace."""

from gpbench.metrics import _roofline

NAME, UNIT, BETTER, SOURCE = "evidence_single_roofline", "%", "higher", "device_trace"
LAYER = "kernels"


def read(run):
    return _roofline.share(run, "single")
