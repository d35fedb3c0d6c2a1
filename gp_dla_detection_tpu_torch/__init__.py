"""gp_dla_detection_tpu_torch: the PyTorch/CUDA port of gp_dla_detection_tpu.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's name and layout so a reader finds one from the
other (``ops/faddeeva.py`` <-> ``ops/faddeeva.py`` and so on).  This
package imports ``torch`` and never ``jax``, and nothing of the JAX
package: the JAX package's numpy-only modules it needs are copied here,
in the same layout (``params``, ``catalog``, ``samples``, ``download``,
``io.{fits,matio,native}``, ``utils.{atomic_io,synthetic,observability}``,
``analysis.{cddf,cosmology,pb,plots,tables}``, ``ascii_catalog``).

Its entry points run on the CUDA device, in float32, through the
hand-written kernels unless the caller names the CPU, float64 or
``backend="torch"``; a default that finds no card raises.

Layer map:
  ops.lyman_series  Lyman-series atomic constants
  ops.faddeeva      Re w(z): accurate three-branch path + fast small-y path
  ops.interp        uniform-grid linear interpolation
  ops.low_rank_mvn  masked Woodbury log-density, batched over samples
  ops.voigt         Voigt absorption profiles + instrumental broadening
  ops.evidence      per-sample DLA evidence: CUDA kernel + plain version
                    (single absorber and absorber pairs)
  ops.pca, ops.lbfgs, ops.lbfgs_device  the training's PCA
                    initialization, host L-BFGS and on-device L-BFGS
  models.qso_model  the learned GP null model
  models.training   the GP training (torch.autograd gradient)
  inference         Bayesian model selection, ``process_spectra``
  multi_dla         {0,1,2}-DLA model selection
  cddf_inputs       device-reduced CDDF inputs of the lean chain
  parallel          the (data, sample) mesh over torch.distributed ranks,
                    the drivers with checkpoints, the fused lean chain
  spectra           FITS spectra loading and preprocessing
  alias_flag, ascii_catalog  the catalogue's flag and text output
  params, catalog, samples, download, io, utils  host modules (copies)
  analysis          CDDF statistics, classic and lean (``LeanDLACatalogue``)
  pipeline          the stages and the CLI (``python -m ...pipeline``)

The CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at
first use (``_build.py``); importing this package compiles nothing.
"""

from .params import (
    LYA_WAVELENGTH,
    LYB_WAVELENGTH,
    LYMAN_LIMIT,
    SPEED_OF_LIGHT,
    Parameters,
    emitted_wavelengths,
    kms_to_z,
    observed_wavelengths,
)

__version__ = "0.1.0"

__all__ = [
    "Parameters",
    "kms_to_z",
    "emitted_wavelengths",
    "observed_wavelengths",
    "LYA_WAVELENGTH",
    "LYB_WAVELENGTH",
    "LYMAN_LIMIT",
    "SPEED_OF_LIGHT",
    "__version__",
]
