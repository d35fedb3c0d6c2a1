"""Bayesian DLA model selection (single DLA) in PyTorch.

Counterpart of ``gp_dla_detection_tpu/inference.py`` (process_qsos.m).
For each spectrum: interpolate the learned model, compute the null-model
Woodbury evidence, then the DLA-model evidence of every QMC
(z_DLA, N_HI) sample, and combine them into model posteriors.

Where the JAX package vmaps over spectra the batch axis is written out
here, and its lax.map over sample chunks is a Python loop.  Two
backends evaluate the sample evidences:

- ``backend="torch"``: the plain PyTorch path (any dtype, any device),
  the counterpart of the JAX ``"xla"`` backend;
- ``backend="cuda"``: the hand-written CUDA kernel (float32, CUDA
  tensors only), the counterpart of ``"pallas"``.  A request it cannot
  serve raises; nothing falls back to the plain path.

:func:`process_spectra` runs on the CUDA device, in float32, through the
kernel unless the caller names another device, dtype or backend
(``runtime.resolve_run``).

As in the JAX package, the absorption profile is aligned with the pixels
it was computed for; ``reference_misaligned_absorption=True`` reproduces
the reference's misalignment quirk (process_qsos.m:180) on the plain
path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .params import LYA_WAVELENGTH, LYMAN_LIMIT, Parameters

from .models.qso_model import GPModel
from .ops import evidence
from .ops.interp import interp_stack_uniform
from .ops.low_rank_mvn import (
    full_fp32_matmul,
    null_log_likelihoods,
    null_log_likelihoods_reference,
)
from .ops.voigt import WINDOW_MARGIN
from .runtime import BACKENDS, resolve_backend, resolve_run

__all__ = [
    "BACKENDS",
    "PaddedSpectra",
    "InferenceResults",
    "dla_rate_priors",
    "correct_prior_dla_flags",
    "compute_sample_window",
    "kernel_sample_window",
    "kernel_span_ids",
    "spectrum_log_likelihoods",
    "batch_log_likelihoods",
    "finalize_posteriors",
    "posteriors_from_evidence",
    "process_spectra",
]

# compute_sample_window declines to window above this many lines, the
# JAX package's gate (evidence_pallas.UNROLL_LINES), kept so that both
# packages take the same path
WINDOW_MAX_LINES = 8


@dataclass
class PaddedSpectra:
    """A batch of spectra as fixed-width padded numpy arrays.

    wavelengths must be strictly increasing along the pixel axis for
    every spectrum (real pixels continue in uniform log-lambda spacing
    into the padded tail).
    """

    wavelengths: np.ndarray     # (B, P) observed-frame [Å]
    flux: np.ndarray            # (B, P) normalized flux
    noise_variance: np.ndarray  # (B, P) normalized noise variance
    mask: np.ndarray            # (B, P) bool; True = real, unmasked pixel
    z_qso: np.ndarray           # (B,)

    def __len__(self) -> int:
        return self.wavelengths.shape[0]

    def slice(self, sl) -> "PaddedSpectra":
        return PaddedSpectra(
            self.wavelengths[sl],
            self.flux[sl],
            self.noise_variance[sl],
            self.mask[sl],
            self.z_qso[sl],
        )

    def pad_to(self, size: int) -> "PaddedSpectra":
        """Pad the batch axis to ``size`` by repeating the final
        spectrum (results for padded rows are discarded by callers)."""
        pad = size - len(self)
        if pad <= 0:
            return self
        return PaddedSpectra(
            *(
                np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                for a in (
                    self.wavelengths,
                    self.flux,
                    self.noise_variance,
                    self.mask,
                    self.z_qso,
                )
            )
        )


# ---------------------------------------------------------------------------
# model prior (process_qsos.m:4-27, 122-132); host numpy, as in the JAX package
# ---------------------------------------------------------------------------


def correct_prior_dla_flags(prior_z_qsos, prior_dla_flags, prior_z_dlas):
    """Drop prior DLAs whose Lyα line falls below the QSO's Lyman limit
    (process_qsos.m:15-27).  The flag is cleared only when *all* of a
    quasar's DLAs fail the cut; None marks "no DLA"."""
    flags = np.array(prior_dla_flags, bool).copy()
    for i in np.flatnonzero(flags):
        entry = prior_z_dlas[i]
        if entry is None:
            continue
        z_dlas = np.atleast_1d(np.asarray(entry, dtype=float))
        if z_dlas.size and np.all(
            LYA_WAVELENGTH * (1 + z_dlas) < LYMAN_LIMIT * (1 + prior_z_qsos[i])
        ):
            flags[i] = False
    return flags


def dla_rate_priors(z_qsos, prior_z_qsos, prior_dla_flags, params: Parameters):
    """z-dependent counting prior (process_qsos.m:122-132), vectorized.

    For each test quasar: among prior quasars with z < z_qso + dz
    (dz = 30000 km/s), the fraction hosting a DLA.  With no prior quasar
    below the cut, log p_dla = -inf and log p_no_dla = 0.

    Returns (log_priors_dla, log_priors_no_dla), each (B,).
    """
    order = np.argsort(prior_z_qsos, kind="stable")
    z_sorted = np.asarray(prior_z_qsos)[order]
    dla_sorted = np.asarray(prior_dla_flags, dtype=np.int64)[order]
    cum_dlas = np.concatenate([[0], np.cumsum(dla_sorted)])

    counts = np.searchsorted(z_sorted, np.asarray(z_qsos) + params.prior_z_qso_increase, side="left")
    num_dlas = cum_dlas[counts]
    safe_counts = np.maximum(counts, 1)
    with np.errstate(divide="ignore"):
        log_p_dla = np.log(num_dlas) - np.log(safe_counts)
        log_p_no_dla = np.log(counts - num_dlas) - np.log(safe_counts)
    log_p_dla = np.where(counts > 0, log_p_dla, -np.inf)
    log_p_no_dla = np.where(counts > 0, log_p_no_dla, 0.0)
    return log_p_dla, log_p_no_dla


# ---------------------------------------------------------------------------
# per-spectrum likelihoods (process_qsos.m:102-209)
# ---------------------------------------------------------------------------


def _extend_wavelengths(wavelengths, width: int, pixel_spacing: float):
    """Append `width` log-continuation pixels at each end of (..., P)
    wavelengths (process_qsos.m:169-177)."""
    steps = torch.arange(1, width + 1, dtype=wavelengths.dtype, device=wavelengths.device)
    dex = torch.pow(10.0, pixel_spacing * steps)
    left = wavelengths[..., :1] / torch.flip(dex, dims=(0,))
    right = wavelengths[..., -1:] * dex
    return torch.cat([left, wavelengths, right], dim=-1)


def compute_sample_window(
    offset_samples, sample_chunk: int, num_pixels: int, num_lines: int = 3,
    pixel_spacing: float | None = None,
):
    """Static window size (pixels) for the windowed Voigt fast path: the
    largest line-center spread of any ``sample_chunk`` consecutive
    z-sorted samples plus WINDOW_MARGIN on each side, rounded up to 8.
    None when windowing would not help (window >= grid) or above
    WINDOW_MAX_LINES lines.  The same computation as the JAX package.
    """
    if num_lines > WINDOW_MAX_LINES:
        return None
    off = np.sort(np.asarray(offset_samples))
    m = min(sample_chunk, len(off))
    if m <= 1 or len(off) == 0:
        return None
    spread = float(np.max(off[m - 1 :] - off[: len(off) - m + 1]))
    if pixel_spacing is None:
        from .params import InstrumentParams

        pixel_spacing = InstrumentParams().pixel_spacing
    ratio = LYA_WAVELENGTH / LYMAN_LIMIT - 1.0
    exact = np.log10(1.0 + spread * ratio) / pixel_spacing
    window = int(np.ceil(max(spread * num_pixels, exact))) + 2 * WINDOW_MARGIN
    window = -(-window // 8) * 8
    return window if window < num_pixels else None


def kernel_sample_window(offset_samples, num_pixels: int, params: Parameters):
    """The evidence kernel's sample window for ``num_pixels``-pixel
    padded spectra: :func:`compute_sample_window` at the kernel's tile
    (``evidence.SAMPLE_TILE``) over the extended grid (both
    instrumental-broadening margins) and ``params``' lines and pixel
    spacing.  The one window every kernel caller uses."""
    return compute_sample_window(
        offset_samples, evidence.SAMPLE_TILE, num_pixels + 2 * params.instrument.width,
        num_lines=params.num_lines, pixel_spacing=params.instrument.pixel_spacing,
    )


def kernel_span_ids(params: Parameters, window) -> dict:
    """The evidence stages' span ids (``utils/observability.trace``): the
    Lyman lines and the kernel's sample window in pixels, 0 for the full
    grid."""
    return {"lines": params.num_lines, "window": window or 0}


def _prepare_spectrum(
    wavelengths,       # (B, P)
    flux,              # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_qso,             # (B,)
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    params: Parameters,
    backend: str = "torch",
    null_evidence: bool = True,
):
    """Per-spectrum preparation over a batch: model interpolation,
    forest scaling, validity mask, null evidence, z_DLA search range,
    and the convolution-extended wavelength grid (process_qsos.m:102-177).
    Shared by both backends; under ``"cuda"`` the null evidence is the
    kernel of ``ops.low_rank_mvn.null_log_likelihoods``, whose rows do not
    depend on the batch.  ``null_evidence=False`` (the pair stage, which
    has it from the single stage) leaves it out: None."""
    dtype, device = flux.dtype, flux.device
    # filled on the device: a tensor made from host data would copy it
    # over and wait for the copy (a host sync on the drivers' issue path)
    const = lambda v: torch.full((), v, dtype=dtype, device=device)
    wavelengths = wavelengths.to(dtype)

    rest = wavelengths / (1.0 + z_qso[:, None])
    nm = params.null_model
    in_range = (rest >= nm.min_lambda) & (rest <= nm.max_lambda)
    valid = mask & in_range

    # the model rest grid is arange-built, so the uniform-grid bracketing
    # applies; mu, log_omega and M share one bracketing
    mu, log_omega, M = interp_stack_uniform(
        model_grid.to(dtype),
        (model_mu.to(dtype), model_log_omega.to(dtype), model_M.to(dtype)),
        rest,
    )

    # Lyα-forest scaling of omega^2 (process_qsos.m:145-147)
    c_0 = torch.exp(const(log_c_0))
    tau_0 = torch.exp(const(log_tau_0))
    beta = torch.exp(const(log_beta))
    lya_zs = (wavelengths - LYA_WAVELENGTH) / LYA_WAVELENGTH
    scaling = 1.0 - torch.exp(-tau_0 * (1.0 + lya_zs) ** beta) + c_0
    omega2 = torch.exp(2.0 * log_omega) * scaling**2

    # null-model evidence (process_qsos.m:149-152)
    log_likelihood_no_dla = None
    if null_evidence:
        null = null_log_likelihoods if backend == "cuda" else null_log_likelihoods_reference
        log_likelihood_no_dla = null(flux, mu, M, omega2 + noise_variance, valid)

    # z_DLA search range over unmasked modelled pixels (process_qsos.m:
    # 160-165; the policy of Parameters.max/min_z_dla_from_*)
    big = const(np.inf)
    wmin = torch.amin(torch.where(valid, wavelengths, big), dim=-1)
    wmax = torch.amax(torch.where(valid, wavelengths, -big), dim=-1)
    max_z_dla = params.max_z_dla_from_wmax(wmax)
    lyman_limit_bound = (
        LYMAN_LIMIT * (1.0 + z_qso) / LYA_WAVELENGTH - 1.0 + params.min_z_cut
    )
    min_z_dla = torch.maximum(wmin / LYA_WAVELENGTH - 1.0, lyman_limit_bound)

    return {
        "mu": mu,
        "M": M,
        "omega2": omega2,
        "valid": valid,
        "log_likelihood_no_dla": log_likelihood_no_dla,
        "min_z_dla": min_z_dla,
        "max_z_dla": max_z_dla,
        "padded_wavelengths": _extend_wavelengths(
            wavelengths, params.instrument.width, params.instrument.pixel_spacing
        ),
    }


def _misaligned_index(wavelengths, z_qso, valid, params: Parameters):
    """Pixel map of the reference's absorption-alignment quirk
    (process_qsos.m:180): valid pixel j reads the profile of in-range
    pixel i0 + j, i0 the first in-range pixel.  (B, P) int64."""
    rest = wavelengths / (1.0 + z_qso[:, None])
    nm = params.null_model
    in_range = (rest >= nm.min_lambda) & (rest <= nm.max_lambda)
    i0 = torch.argmax(in_range.to(torch.int32), dim=-1)  # first in-range pixel
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    return torch.clamp(i0[:, None] + rank, 0, wavelengths.shape[-1] - 1)


def batch_log_likelihoods(
    wavelengths,       # (B, P)
    flux,              # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_qso,             # (B,)
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    offset_samples,    # (S,)
    nhi_samples,       # (S,)
    *,
    params: Parameters,
    sample_chunk: int = 1000,
    backend: str | None = None,
    sample_window: int | None = None,
    reference_misaligned_absorption: bool = False,
    samples_sorted: bool = False,
):
    """Null + per-sample DLA log likelihoods for a batch of spectra.

    All tensors on one device; the working dtype is ``flux.dtype``.
    ``sample_window`` (float32 only) selects the windowed Voigt path;
    its samples must then be z-ascending: ``samples_sorted=True``
    asserts they already are, otherwise they are sorted here and the
    columns un-sorted after.  ``backend`` None: the kernel on CUDA
    tensors, the plain version on CPU tensors.

    Returns a dict of tensors: log_likelihood_no_dla (B,),
    sample_log_likelihoods_dla (B, S), min_z_dla (B,), max_z_dla (B,).
    """
    backend = resolve_backend(backend, flux.device, flux.dtype)
    dtype = flux.dtype
    if backend == "cuda" and reference_misaligned_absorption:
        raise ValueError(
            "reference_misaligned_absorption is a MATLAB-parity mode "
            "of the plain path only (backend='torch')"
        )
    if flux.is_cuda:
        full_fp32_matmul()

    prep = _prepare_spectrum(
        wavelengths, flux, noise_variance, mask, z_qso,
        model_grid, model_mu, model_M, model_log_omega,
        log_c_0, log_tau_0, log_beta, params, backend=backend,
    )
    offsets = offset_samples.to(dtype)
    nhis = nhi_samples.to(dtype)
    windowed = sample_window is not None and dtype == torch.float32
    sort_here = windowed and not samples_sorted
    if sort_here:
        # z-sort the samples so each chunk spans a narrow pixel window
        order = torch.argsort(offsets, stable=True)
        unsort = torch.argsort(order, stable=True)
        offsets = offsets[order]
        nhis = nhis[order]

    min_z, max_z = prep["min_z_dla"], prep["max_z_dla"]
    z_dlas = min_z[:, None] + (max_z - min_z)[:, None] * offsets[None, :]
    nhi_b = nhis[None, :].expand(z_dlas.shape)
    args = (
        prep["padded_wavelengths"], flux, prep["mu"], prep["M"],
        prep["omega2"], noise_variance, prep["valid"], z_dlas, nhi_b,
    )
    window = sample_window if windowed else None
    if backend == "cuda":
        sample_lls = evidence.sample_log_likelihoods(
            *args[:-1], nhi_b.contiguous(), num_lines=params.num_lines,
            instrument=params.instrument, window=window,
        )
    else:
        misalign = (
            _misaligned_index(wavelengths.to(dtype), z_qso, prep["valid"], params)
            if reference_misaligned_absorption
            else None
        )
        sample_lls = evidence.sample_log_likelihoods_reference(
            *args, num_lines=params.num_lines, instrument=params.instrument,
            window=window, sample_chunk=sample_chunk, absorption_index=misalign,
        )
    if sort_here:
        sample_lls = sample_lls[:, unsort]
    return {
        "log_likelihood_no_dla": prep["log_likelihood_no_dla"],
        "sample_log_likelihoods_dla": sample_lls,
        "min_z_dla": min_z,
        "max_z_dla": max_z,
    }


def spectrum_log_likelihoods(
    wavelengths, flux, noise_variance, mask, z_qso, *model_and_samples, **kwargs
):
    """:func:`batch_log_likelihoods` for ONE spectrum: (P,) tensors and a
    scalar z_qso in, (S,) sample evidences and scalars out."""
    out = batch_log_likelihoods(
        wavelengths[None], flux[None], noise_variance[None], mask[None],
        torch.as_tensor(z_qso, dtype=flux.dtype, device=flux.device).reshape(1),
        *model_and_samples, **kwargs,
    )
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# results container + host loop (process_qsos.m:73-86, 200-249)
# ---------------------------------------------------------------------------


@dataclass
class InferenceResults:
    """Everything processed_qsos_<set>.mat stores (process_qsos.m:235-243),
    with the JAX package's field names and npz keys."""

    min_z_dlas: np.ndarray
    max_z_dlas: np.ndarray
    log_priors_no_dla: np.ndarray
    log_priors_dla: np.ndarray
    log_likelihoods_no_dla: np.ndarray
    log_likelihoods_dla: np.ndarray
    sample_log_likelihoods_dla: np.ndarray | None  # (N, num_dla_samples)
    log_posteriors_no_dla: np.ndarray
    log_posteriors_dla: np.ndarray
    model_posteriors: np.ndarray            # (N, 2): [no_dla, dla]
    p_no_dlas: np.ndarray
    p_dlas: np.ndarray
    map_sample_inds: np.ndarray | None = None

    # the only fields save() may omit; any other missing key is a corrupt
    # or incompatible artifact
    _OPTIONAL_FIELDS = ("sample_log_likelihoods_dla", "map_sample_inds")

    def save(self, path: str | Path) -> None:
        from .utils.atomic_io import atomic_savez

        # atomic and uncompressed, as the JAX package writes it; None
        # fields are omitted and restored as None by load()
        atomic_savez(
            path,
            compress=False,
            **{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    @classmethod
    def load(cls, path: str | Path) -> "InferenceResults":
        with np.load(Path(path)) as f:
            data = {k: f[k] for k in f.files}
        for name in cls._OPTIONAL_FIELDS:
            data.setdefault(name, None)
        missing = [
            fld.name for fld in dataclasses.fields(cls) if fld.name not in data
        ]
        if missing:
            raise ValueError(f"{path} is not a results artifact: missing {missing}")
        return cls(**data)


def finalize_posteriors(
    log_priors_no_dla,
    log_priors_dla,
    log_likelihoods_no_dla,
    sample_log_likelihoods_dla,
):
    """Evidence aggregation + model posteriors (process_qsos.m:200-232).

    DLA evidence is the sample mean in a numerically safe form:
    max + log(mean(exp(ll - max))).
    """
    sample_lls = np.asarray(sample_log_likelihoods_dla)
    max_ll = np.max(sample_lls, axis=-1)
    log_likelihoods_dla = max_ll + np.log(
        np.mean(np.exp(sample_lls - max_ll[:, None]), axis=-1)
    )
    return posteriors_from_evidence(
        log_priors_no_dla,
        log_priors_dla,
        log_likelihoods_no_dla,
        log_likelihoods_dla,
    )


def posteriors_from_evidence(
    log_priors_no_dla,
    log_priors_dla,
    log_likelihoods_no_dla,
    log_likelihoods_dla,
):
    """Model posteriors from already-aggregated evidences."""
    log_likelihoods_dla = np.asarray(log_likelihoods_dla)
    log_posteriors_no_dla = log_priors_no_dla + log_likelihoods_no_dla
    log_posteriors_dla = log_priors_dla + log_likelihoods_dla

    both = np.stack([log_posteriors_no_dla, log_posteriors_dla], axis=-1)
    both_max = np.max(both, axis=-1, keepdims=True)
    model_posteriors = np.exp(both - both_max)
    model_posteriors /= model_posteriors.sum(axis=-1, keepdims=True)

    return {
        "log_likelihoods_dla": log_likelihoods_dla,
        "log_posteriors_no_dla": log_posteriors_no_dla,
        "log_posteriors_dla": log_posteriors_dla,
        "model_posteriors": model_posteriors,
        "p_no_dlas": model_posteriors[:, 0],
        "p_dlas": 1.0 - model_posteriors[:, 0],
    }


_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def process_spectra(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_dla_flags,
    params: Parameters | None = None,
    batch_size: int = 16,
    sample_chunk: int = 1000,
    dtype: torch.dtype | None = None,
    device=None,
    progress: bool = False,
    backend: str | None = None,
    reference_misaligned_absorption: bool = False,
) -> InferenceResults:
    """Single-device inference over a set of spectra.

    Runs fixed-size batches in order on ``device``, padding the final
    partial batch.  ``device``, ``dtype`` and ``backend`` default to the
    CUDA device, float32 and the kernel (``runtime.resolve_run``); a
    default that finds no card raises.  ``backend="cuda"`` (float32 on a
    CUDA device) places a core window per sample tile, so the samples
    are sorted by offset once on the host and the result columns
    un-sorted on the host.
    """
    device, dtype, backend = resolve_run(device, dtype, backend)
    if reference_misaligned_absorption and backend != "torch":
        raise ValueError("reference_misaligned_absorption requires backend='torch'")
    if params is None:
        params = Parameters()
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")

    n = len(spectra)
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_dla_flags, params
    )
    np_dtype = _NUMPY_DTYPES[dtype]
    num_samples = len(np.asarray(offset_samples))
    out_null = np.empty(n)
    # the (N, S) sample matrix dominates host memory at survey scale:
    # store it at the run dtype
    out_samples = np.empty((n, num_samples), np_dtype)
    out_min_z = np.empty(n)
    out_max_z = np.empty(n)

    sample_window = None
    unsort_cols = None
    offsets_host = np.asarray(offset_samples, np_dtype)
    nhis_host = np.asarray(nhi_samples, np_dtype)
    if backend == "cuda":
        sample_window = kernel_sample_window(
            offset_samples, spectra.wavelengths.shape[1], params
        )
        if sample_window is not None:
            # sort ONCE on the host (the sample set is static) and
            # un-sort the result columns on the host
            order = np.argsort(offsets_host, kind="stable")
            unsort_cols = np.argsort(order, kind="stable")
            offsets_host = offsets_host[order]
            nhis_host = nhis_host[order]

    on_device = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    model_args = (
        *model.evidence_args(device, dtype), on_device(offsets_host), on_device(nhis_host),
    )

    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        batch = spectra.slice(slice(start, stop)).pad_to(batch_size)
        out = batch_log_likelihoods(
            on_device(batch.wavelengths),
            on_device(batch.flux),
            on_device(batch.noise_variance),
            torch.as_tensor(np.asarray(batch.mask, bool), device=device),
            on_device(batch.z_qso),
            *model_args,
            params=params,
            sample_chunk=sample_chunk,
            backend=backend,
            sample_window=sample_window,
            reference_misaligned_absorption=reference_misaligned_absorption,
            samples_sorted=unsort_cols is not None,
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
        keep = stop - start
        out_null[start:stop] = out["log_likelihood_no_dla"][:keep]
        rows = out["sample_log_likelihoods_dla"][:keep]
        out_samples[start:stop] = rows[:, unsort_cols] if unsort_cols is not None else rows
        out_min_z[start:stop] = out["min_z_dla"][:keep]
        out_max_z[start:stop] = out["max_z_dla"][:keep]
        if progress:
            print(f"processed {stop}/{n} spectra", flush=True)

    post = finalize_posteriors(log_p_no_dla, log_p_dla, out_null, out_samples)
    return InferenceResults(
        min_z_dlas=out_min_z,
        max_z_dlas=out_max_z,
        log_priors_no_dla=log_p_no_dla,
        log_priors_dla=log_p_dla,
        log_likelihoods_no_dla=out_null,
        log_likelihoods_dla=post["log_likelihoods_dla"],
        sample_log_likelihoods_dla=out_samples,
        log_posteriors_no_dla=post["log_posteriors_no_dla"],
        log_posteriors_dla=post["log_posteriors_dla"],
        model_posteriors=post["model_posteriors"],
        p_no_dlas=post["p_no_dlas"],
        p_dlas=post["p_dlas"],
    )
