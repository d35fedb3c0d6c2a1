"""Science analysis layer: CDDF, dN/dX, Omega_DLA, plots, tables.

Counterpart of ``gp_dla_detection_tpu/analysis``: ``cddf``,
``cosmology``, ``pb``, ``plots`` and ``tables`` are the port's own
copies of the JAX package's modules, and ``lean_catalogue`` holds the
statistics from device-reduced lean inputs (``LeanDLACatalogue``).
"""

from .cddf import DLACatalogue, compute_all_snrs, compute_pixel_noise
from .cosmology import AbsorptionPath, hubble_by_h0, path_length_integrand, rho_crit
from .lean_catalogue import LeanDLACatalogue
from .pb import (
    combine_with_poisson,
    interval,
    pdf_confidence,
    poisson_binomial_pdf,
)

__all__ = [
    "DLACatalogue",
    "LeanDLACatalogue",
    "compute_all_snrs",
    "compute_pixel_noise",
    "AbsorptionPath",
    "hubble_by_h0",
    "path_length_integrand",
    "rho_crit",
    "poisson_binomial_pdf",
    "combine_with_poisson",
    "interval",
    "pdf_confidence",
]
