"""The run parameters and physical constants, shared with the JAX package.

``gp_dla_detection_tpu.params`` is numpy-only (dataclasses and
constants), so the port uses it as it is: a ``Parameters`` built for one
package configures the other.  A program that drives only the port
imports them from here.
"""

from gp_dla_detection_tpu.params import (
    LYA_WAVELENGTH,
    LYB_WAVELENGTH,
    LYMAN_LIMIT,
    SPEED_OF_LIGHT,
    DLASamplingParams,
    InstrumentParams,
    NullModelParams,
    OptimizationParams,
    Parameters,
    emitted_wavelengths,
    kms_to_z,
    observed_wavelengths,
)

__all__ = [
    "LYA_WAVELENGTH",
    "LYB_WAVELENGTH",
    "LYMAN_LIMIT",
    "SPEED_OF_LIGHT",
    "DLASamplingParams",
    "InstrumentParams",
    "NullModelParams",
    "OptimizationParams",
    "Parameters",
    "emitted_wavelengths",
    "kms_to_z",
    "observed_wavelengths",
]
