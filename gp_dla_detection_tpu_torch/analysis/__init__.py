"""Science statistics from lean runs: the port's ``LeanDLACatalogue``.

The classic statistics, SNRs, plots and tables are the JAX package's
jax-free ``gp_dla_detection_tpu.analysis`` modules, used as they are.
"""

from .lean_catalogue import LeanDLACatalogue, catalogue_from_run

__all__ = ["LeanDLACatalogue", "catalogue_from_run"]
