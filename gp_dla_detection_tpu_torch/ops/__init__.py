"""Numerics of the port: Faddeeva/Voigt, Woodbury log-density,
interpolation, and the per-sample evidence kernel.

The JAX package's public ops are exported here as it exports them;
the other submodules are imported by name (``from ..ops import voigt``).
Nothing here compiles or loads a CUDA kernel at import time.
"""

from .faddeeva import voigt_function, wofz_real
from .low_rank_mvn import (
    batched_dla_log_likelihoods,
    log_mvnpdf_low_rank,
    pair_products,
    woodbury_log_p,
)
from .voigt import instrumental_broadening, voigt_absorption

__all__ = [
    "voigt_function",
    "wofz_real",
    "batched_dla_log_likelihoods",
    "log_mvnpdf_low_rank",
    "pair_products",
    "woodbury_log_p",
    "instrumental_broadening",
    "voigt_absorption",
]
