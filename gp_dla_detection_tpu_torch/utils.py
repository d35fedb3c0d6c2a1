"""The synthetic flagship workload, shared with the JAX package.

``gp_dla_detection_tpu.utils.synthetic.synthetic_workload`` builds numpy
arrays only (production-shape spectra, a learned-model stand-in and the
QMC sample set), so the port uses it as it is.  A program that drives
only the port imports it from here.
"""

from gp_dla_detection_tpu.utils.synthetic import synthetic_workload

__all__ = ["synthetic_workload"]
