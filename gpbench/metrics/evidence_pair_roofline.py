"""The pair evidence kernel's share of its roofline (``table_kernel`` and
``evidence_kernel<K, true>``), from the device trace."""

from gpbench.metrics import _roofline

NAME, UNIT, BETTER, SOURCE = "evidence_pair_roofline", "%", "higher", "device_trace"
LAYER = "kernels"


def read(run):
    return _roofline.share(run, "pair")
