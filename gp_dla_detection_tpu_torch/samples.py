"""The DLA prior samples (QMC z_DLA offsets and N_HI draws), shared with
the JAX package.

``gp_dla_detection_tpu.samples`` is numpy-only, so the port uses it as
it is: both packages read and write the same ``dla_samples.npz``.  A
program that drives only the port imports it from here.
"""

from gp_dla_detection_tpu.samples import (
    DLASamples,
    generate_dla_samples,
    halton_rr2,
    matlab_ksdensity,
)

__all__ = ["DLASamples", "generate_dla_samples", "halton_rr2", "matlab_ksdensity"]
