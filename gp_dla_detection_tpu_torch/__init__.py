"""gp_dla_detection_tpu_torch: the PyTorch/CUDA port of gp_dla_detection_tpu.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's name and layout so a reader finds one from the
other (``ops/faddeeva.py`` <-> ``ops/faddeeva.py`` and so on).  This
package imports ``torch`` and never ``jax``.  It reuses the JAX package's
jax-free modules as they are: ``params``, ``samples``, ``catalog``,
``io``, ``ascii_catalog`` and ``utils``.

Ported so far (the single-DLA slice of the production chain):
  ops.lyman_series  Lyman-series atomic constants
  ops.faddeeva      Re w(z): accurate three-branch path + fast small-y path
  ops.interp        uniform-grid linear interpolation
  ops.low_rank_mvn  masked Woodbury log-density, batched over samples
  ops.voigt         Voigt absorption profiles + instrumental broadening
  ops.evidence      per-sample DLA evidence: CUDA kernel + plain version
  models.qso_model  the learned GP null model
  inference         Bayesian model selection, ``process_spectra``

The CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at
first use (``_build.py``); importing this package compiles nothing.
"""

__version__ = "0.1.0"
