"""FITS binary tables, shared with the JAX package.

``gp_dla_detection_tpu.io.fits`` is a pure-numpy reader and writer, so
the port uses it as it is (``spectra.read_spec`` reads SDSS speclite
files with it).  A program that drives only the port, for example one
that writes a synthetic release for the pipeline, imports it from here.
"""

from gp_dla_detection_tpu.io.fits import BinTable, read_bintable, write_bintable

__all__ = ["BinTable", "read_bintable", "write_bintable"]
