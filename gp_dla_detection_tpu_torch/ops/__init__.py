"""Numerics of the port: Faddeeva/Voigt, Woodbury log-density,
interpolation, and the per-sample evidence kernel.

Submodules are imported by name (``from ..ops import voigt``); nothing
here compiles or loads a CUDA kernel at import time.
"""
