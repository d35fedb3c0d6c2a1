"""Maximum-likelihood training of the low-rank GP null model, in PyTorch.

Counterpart of ``gp_dla_detection_tpu/models/training.py``
(learn_qso_model.m + objective.m + spectrum_loss.m).  The per-spectrum
Woodbury NLL is one batched masked computation over the (N, R) training
matrices (the port's ``ops/low_rank_mvn.{pair_products,
woodbury_log_p}``), differentiated with ``torch.autograd`` on one flat
parameter vector laid out as the JAX package's ``ravel_pytree`` lays out
its parameter dict, and minimized by the host L-BFGS (``ops/lbfgs.py``,
a copy of the JAX package's) or the on-device one
(``ops/lbfgs_device.py``).  On a mesh each data rank holds its rows of
the training matrices and the value and gradient are summed over the
ranks.  The data preparation and the PCA initialization are the JAX
package's numpy, copied.

As in the JAX package, the Kim et al. (2007) Gaussian priors on tau_0
and beta enter the objective value as well as the gradient (the
reference adds them to the gradient only, objective.m:59-71);
``prior_in_value=False`` reproduces the reference's value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import LYA_WAVELENGTH, Parameters

from ..ops.lbfgs import LBFGSResult, minimize_lbfgs
from ..ops.lbfgs_device import minimize_lbfgs_device
from ..ops.low_rank_mvn import pair_products, woodbury_log_p
from ..ops.pca import pairwise_pca
from ..parallel.mesh import DATA_AXIS, all_reduce_sum, rank_device
from ..runtime import default_device
from .qso_model import GPModel

__all__ = [
    "TrainingData",
    "prepare_training_data",
    "objective",
    "initialize_model_params",
    "learn_gp_model",
    "TAU_0_MU",
    "TAU_0_SIGMA",
    "BETA_MU",
    "BETA_SIGMA",
]

# Kim et al. (2007) priors (objective.m:59-71)
TAU_0_MU, TAU_0_SIGMA = 0.0023, 0.0007
BETA_MU, BETA_SIGMA = 3.65, 0.21


@dataclass
class TrainingData:
    """Fixed-width training matrices on the rest grid (masked, filled)."""

    centered_flux: np.ndarray   # (N, R), 0 where masked
    lya_1pzs: np.ndarray        # (N, R), 1 where masked
    noise_variance: np.ndarray  # (N, R), 0 where masked
    mask: np.ndarray            # (N, R) bool
    mu: np.ndarray              # (R,) empirical mean used for centering

    @property
    def num_quasars(self) -> int:
        return self.centered_flux.shape[0]

    def centered_with_nans(self) -> np.ndarray:
        return np.where(self.mask, self.centered_flux, np.nan)


def _interp_nan(x, y, grid):
    """MATLAB interp1 semantics: linear, NaN outside the data range,
    NaN-propagating from NaN samples (learn_qso_model.m:50-59)."""
    out = np.interp(grid, x, y)
    out[(grid < x[0]) | (grid > x[-1])] = np.nan
    return out


def prepare_training_data(
    wavelengths: list[np.ndarray],
    flux: list[np.ndarray],
    noise_variance: list[np.ndarray],
    pixel_mask: list[np.ndarray],
    z_qsos: np.ndarray,
    params: Parameters | None = None,
) -> TrainingData:
    """Interpolate selected spectra onto the rest grid and build the
    masked training matrices (learn_qso_model.m:29-70)."""
    if params is None:
        params = Parameters()
    grid = params.null_model.rest_wavelengths()
    R = grid.size
    N = len(wavelengths)

    lya_1pzs = np.full((N, R), np.nan)
    rest_fluxes = np.full((N, R), np.nan)
    rest_noise = np.full((N, R), np.nan)

    for i in range(N):
        lam = np.asarray(wavelengths[i], np.float64)
        fl = np.asarray(flux[i], np.float64).copy()
        nv = np.asarray(noise_variance[i], np.float64).copy()
        pm = np.asarray(pixel_mask[i], bool)
        fl[pm] = np.nan
        nv[pm] = np.nan
        rest = lam / (1.0 + z_qsos[i])
        lya_1pzs[i] = _interp_nan(rest, 1.0 + (lam - LYA_WAVELENGTH) / LYA_WAVELENGTH, grid)
        rest_fluxes[i] = _interp_nan(rest, fl, grid)
        rest_noise[i] = _interp_nan(rest, nv, grid)

    # mask noisy pixels (learn_qso_model.m:63-67)
    noisy = rest_noise > params.null_model.max_noise_variance
    lya_1pzs[noisy] = np.nan
    rest_fluxes[noisy] = np.nan
    rest_noise[noisy] = np.nan

    # empirical mean + centering (learn_qso_model.m:70-71)
    with np.errstate(invalid="ignore"):
        mu = np.nanmean(rest_fluxes, axis=0)
    centered = rest_fluxes - mu

    mask = np.isfinite(centered) & np.isfinite(lya_1pzs) & np.isfinite(rest_noise)
    return TrainingData(
        centered_flux=np.where(mask, centered, 0.0),
        lya_1pzs=np.where(mask, lya_1pzs, 1.0),
        noise_variance=np.where(mask, rest_noise, 0.0),
        mask=mask,
        mu=mu,
    )


def objective(
    model_params: dict,
    centered_flux,
    lya_1pzs,
    noise_variance,
    mask,
    prior_in_value: bool = True,
):
    """Negative log likelihood of the training set (objective.m:12-74).

    model_params: {"M": (R, k), "log_omega": (R,), "log_c_0": (),
    "log_tau_0": (), "log_beta": ()} tensors; the data are (N, R)
    tensors on the same device.  The per-spectrum density is

        N(y_i; 0, M M' + diag(sigma_i^2 + omega^2 (1 - exp(-tau_0
            (1+z_i)^beta) + c_0)^2))

    restricted to unmasked pixels (spectrum_loss.m:1-12).
    """
    M = model_params["M"]
    log_omega = model_params["log_omega"]
    c_0 = torch.exp(model_params["log_c_0"])
    tau_0 = torch.exp(model_params["log_tau_0"])
    beta = torch.exp(model_params["log_beta"])
    dtype = M.dtype

    omega2 = torch.exp(2.0 * log_omega)
    optical_depth = tau_0 * lya_1pzs**beta
    scaling = 1.0 - torch.exp(-optical_depth) + c_0
    d = noise_variance + omega2 * scaling**2            # (N, R)

    valid = mask
    one = torch.ones((), dtype=dtype, device=M.device)
    zero = torch.zeros((), dtype=dtype, device=M.device)
    d_safe = torch.where(valid, d, one)
    inv_d = torch.where(valid, 1.0 / d_safe, zero)
    u = centered_flux * inv_d
    quad0 = torch.sum(centered_flux * u, dim=-1)
    logdet_d = torch.sum(torch.where(valid, torch.log(d_safe), zero), dim=-1)
    n_eff = torch.sum(valid, dim=-1).to(dtype)

    lls = woodbury_log_p(M, pair_products(M), inv_d, u, quad0, logdet_d, n_eff)
    nll = -torch.sum(lls)

    if prior_in_value:
        nll = nll + 0.5 * ((tau_0 - TAU_0_MU) / TAU_0_SIGMA) ** 2
        nll = nll + 0.5 * ((beta - BETA_MU) / BETA_SIGMA) ** 2
    return nll


def initialize_model_params(data: TrainingData, params: Parameters) -> dict:
    """PCA + nanstd initialization (learn_qso_model.m:74-97)."""
    k = params.null_model.k
    centered_nan = data.centered_with_nans()
    coeff, latent = pairwise_pca(centered_nan, k)
    initial_M = coeff * np.sqrt(np.maximum(latent, 0.0))[None, :]
    with np.errstate(invalid="ignore"):
        initial_log_omega = np.log(np.nanstd(centered_nan, axis=0, ddof=1))
    initial_log_omega = np.where(
        np.isfinite(initial_log_omega), initial_log_omega, 0.0
    )
    opt = params.optimization
    return {
        "M": initial_M,
        "log_omega": initial_log_omega,
        "log_c_0": np.float64(np.log(opt.initial_c_0)),
        "log_tau_0": np.float64(np.log(opt.initial_tau_0)),
        "log_beta": np.float64(np.log(opt.initial_beta)),
    }


def flat_layout(params_dict: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of each parameter in the flat vector: sorted by
    name, each raveled in C order — the layout of the JAX package's
    ``ravel_pytree``, so that both optimizers walk the same vector."""
    return [(k, np.shape(params_dict[k])) for k in sorted(params_dict)]


def ravel(params_dict: dict) -> np.ndarray:
    return np.concatenate(
        [np.ravel(np.asarray(params_dict[k], np.float64)) for k, _ in flat_layout(params_dict)]
    )


def unravel(flat, layout) -> dict:
    """The parameter dict of a flat vector (views of ``flat``)."""
    out, i = {}, 0
    for name, shape in layout:
        size = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[i : i + size].reshape(shape)
        i += size
    return out


def learn_gp_model(
    data: TrainingData,
    params: Parameters | None = None,
    dtype: torch.dtype = torch.float64,
    prior_in_value: bool = True,
    callback=None,
    mesh=None,
    checkpoint_path=None,
    optimizer: str = "host",
    device=None,
) -> tuple[GPModel, LBFGSResult]:
    """Fit the GP null model by L-BFGS (learn_qso_model.m:100-123).

    The training matrices and every objective evaluation live on
    ``device`` (default: the mesh's card for this rank, else the CUDA
    device; raises without a card) at ``dtype``.

    ``optimizer``: ``"host"``, the strong-Wolfe two-loop L-BFGS of
    ``ops/lbfgs.py`` (its state float64 on the host, the gradient
    brought to the host per evaluation), or ``"device"``, the
    backtracking-Armijo L-BFGS of ``ops/lbfgs_device.py`` (its state at
    ``dtype`` on the device, scalars read per evaluation).

    ``mesh`` (``parallel.mesh.Mesh``): each data rank holds its rows of
    the four training matrices, padded to a multiple of the data axis
    with fully masked rows (which contribute exactly zero); value and
    gradient are summed over the data axis, so every rank runs the same
    optimizer to the same model.  The Kim et al. priors enter once (on
    data rank 0).  Only the coordinator writes ``checkpoint_path``;
    every rank resumes from it.
    """
    if params is None:
        params = Parameters()
    if optimizer not in ("host", "device"):
        raise ValueError(f"unknown optimizer {optimizer!r} (host|device)")
    device = default_device(rank_device(device, mesh))

    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    init = initialize_model_params(data, params)
    layout = flat_layout(init)
    arrays = (data.centered_flux, data.lya_1pzs, data.noise_variance, data.mask)
    prior = prior_in_value
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        n_data = mesh.shape[DATA_AXIS]
        pad = (-len(arrays[0])) % n_data
        # masked-pixel fill values: a padded row contributes exactly zero
        arrays = tuple(
            np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            for a, fill in zip(arrays, (0.0, 1.0, 0.0, False))
        )
        per = len(arrays[0]) // n_data
        arrays = tuple(a[mesh.data_index * per : (mesh.data_index + 1) * per] for a in arrays)
        prior = prior_in_value and mesh.data_index == 0
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    args = (
        put(arrays[0]).to(dtype),
        put(arrays[1]).to(dtype),
        put(arrays[2]).to(dtype),
        put(arrays[3]),
    )

    def value_and_grad(flat, *data_args):
        flat = flat.detach().requires_grad_(True)
        f = objective(unravel(flat, layout), *data_args, prior_in_value=prior)
        (g,) = torch.autograd.grad(f, flat)
        return all_reduce_sum(f.detach(), mesh), all_reduce_sum(g, mesh)

    opt = params.optimization
    budget = dict(
        max_iterations=opt.max_iterations,
        max_fun_evals=opt.max_fun_evals,
        callback=callback,
        checkpoint_path=checkpoint_path,
        write_checkpoints=mesh is None or mesh.is_coordinator,
    )
    if optimizer == "device":
        result = minimize_lbfgs_device(
            value_and_grad, put(ravel(init)).to(dtype), *args, **budget
        )
    else:

        def host_value_and_grad(x):
            f, g = value_and_grad(put(x).to(dtype), *args)
            return float(f), g.cpu().numpy().astype(np.float64)

        result = minimize_lbfgs(
            host_value_and_grad,
            # the starting point at the run dtype, as the JAX package casts it
            ravel(init).astype(np_dtype).astype(np.float64),
            **budget,
        )

    # the fitted values at the run dtype, as the JAX package reads them
    fitted = unravel(np.asarray(result.x, np.float64).astype(np_dtype), layout)
    model = GPModel.from_numpy(
        rest_wavelengths=params.null_model.rest_wavelengths(),
        mu=np.asarray(data.mu),
        M=np.asarray(fitted["M"], np.float64),
        log_omega=np.asarray(fitted["log_omega"], np.float64),
        log_c_0=float(fitted["log_c_0"]),
        log_tau_0=float(fitted["log_tau_0"]),
        log_beta=float(fitted["log_beta"]),
        metadata={
            "log_likelihood": -result.f,
            "iterations": result.iterations,
            "fun_evals": result.fun_evals,
            "termination": result.message,
            "max_noise_variance": params.null_model.max_noise_variance,
        },
        device=device,
        dtype=torch.float64,
    )
    return model, result
