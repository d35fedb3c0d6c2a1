"""gp_dla_detection_tpu_torch: the PyTorch/CUDA port of gp_dla_detection_tpu.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's name and layout so a reader finds one from the
other (``ops/faddeeva.py`` <-> ``ops/faddeeva.py`` and so on).  This
package imports ``torch`` and never ``jax``, at load time or when a
function runs.  It reuses those JAX-package modules whose whole import
chain is jax-free, as they are: ``params``, ``catalog``, ``samples``,
``io`` (``fits``; ``matio``, its multi-DLA export called without
``samples``; ``native`` only when its library loads),
``ascii_catalog.write_ascii_catalog``, ``analysis`` (``cddf``, ``pb``,
``cosmology``, ``plots``, ``tables``) and ``utils.atomic_io``; the ones
a program that drives only the port needs are re-exported here under
their JAX names (``params``, ``samples``, ``io`` for the FITS tables,
``utils`` for the synthetic workload).  A JAX
module that reaches jax, even through an import made at call time, has
a counterpart here: ``ascii_catalog.write_ascii_multi_results`` (the JAX
one imports the JAX ``alias_flag``) and the lean branch of
``DLACatalogue.from_run`` (``analysis.lean_catalogue.catalogue_from_run``;
the JAX one imports the JAX ``cddf_inputs``).

Ported so far:
  ops.lyman_series  Lyman-series atomic constants
  ops.faddeeva      Re w(z): accurate three-branch path + fast small-y path
  ops.interp        uniform-grid linear interpolation
  ops.low_rank_mvn  masked Woodbury log-density, batched over samples
  ops.voigt         Voigt absorption profiles + instrumental broadening
  ops.evidence      per-sample DLA evidence: CUDA kernel + plain version
                    (single absorber and absorber pairs)
  ops.pca, ops.lbfgs  the training's PCA initialization and host L-BFGS
  models.qso_model  the learned GP null model
  models.training   the GP training (torch.autograd gradient)
  inference         Bayesian model selection, ``process_spectra``
  multi_dla         {0,1,2}-DLA model selection
  cddf_inputs       device-reduced CDDF inputs of the lean chain
  parallel          one-device drivers with checkpoints, the fused lean chain
  spectra           FITS spectra loading and preprocessing
  alias_flag, ascii_catalog  the catalogue's flag and text output
  analysis          lean-input statistics (``LeanDLACatalogue``)
  pipeline          the stages and the CLI (``python -m ...pipeline``)

The CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at
first use (``_build.py``); importing this package compiles nothing.
"""

__version__ = "0.1.0"
