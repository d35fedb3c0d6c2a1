"""Batched Voigt absorption profiles for DLAs.

Counterpart of ``gp_dla_detection_tpu/ops/voigt.py`` (voigt.c:253-304):

 - per-pixel velocity relative to each redshifted Lyman line
   (voigt.c:277-287): v = lambda * c / (lambda_t * (1+z)) - c
 - optical depth tau = N_HI * sum_j leading_const_j * voigt(v_j, sigma,
   gamma_j), absorption = exp(-tau) (voigt.c:282-291)
 - 7-tap Gaussian instrumental broadening, a "valid" convolution that
   drops ``width`` pixels at each edge (voigt.c:294-299).

Where the JAX functions take one spectrum's (n,) wavelengths and (S,)
samples, these also take leading batch axes: wavelengths (..., n) with
samples (..., S) give profiles (..., S, n - 2*width).
"""

from __future__ import annotations

import numpy as np
import torch

from gp_dla_detection_tpu.params import InstrumentParams

from . import lyman_series as lines
from .faddeeva import _SQRT_PI, g_function, wofz_real, wofz_real_fast

__all__ = [
    "voigt_absorption",
    "voigt_absorption_windowed",
    "pair_absorption",
    "instrumental_broadening",
    "extend_wavelengths",
    "WINDOW_MARGIN",
]

# Slack reserved on EACH side of a z-sorted chunk's line-center spread in
# the windowed fast paths (Doppler core, convolution reach, rounding,
# QMC non-uniformity); compute_sample_window sizes windows as
# spread + 2*WINDOW_MARGIN and consumers offset starts by WINDOW_MARGIN.
WINDOW_MARGIN = 40

_SQRT_2 = float(np.sqrt(2.0))
_SQRT_2PI = float(np.sqrt(2.0 * np.pi))


def extend_wavelengths(
    wavelengths: np.ndarray, instrument: InstrumentParams | None = None
) -> np.ndarray:
    """Host-side convolution padding: ``width`` log-continuation pixels
    at each end (process_qsos.m:169-177)."""
    if instrument is None:
        instrument = InstrumentParams()
    w, dex = instrument.width, instrument.pixel_spacing
    lam = np.asarray(wavelengths)
    left = lam[..., :1] * 10.0 ** (-dex * np.arange(w, 0, -1))
    right = lam[..., -1:] * 10.0 ** (dex * np.arange(1, w + 1))
    return np.concatenate([left, lam, right], axis=-1)


def instrumental_broadening(raw_profile, instrument: InstrumentParams):
    """'Valid' convolution with the instrument kernel along the last axis
    (voigt.c:294-299): (..., n) -> (..., n - 2*width)."""
    taps = instrument.profile()
    n_out = raw_profile.shape[-1] - 2 * instrument.width
    out = None
    for j, tap in enumerate(taps):
        t = torch.tensor(tap, dtype=raw_profile.dtype, device=raw_profile.device)
        piece = t * raw_profile[..., j : j + n_out]
        out = piece if out is None else out + piece
    return out


class _LineConstants:
    """Per-dtype scalar constants shared by both absorption functions,
    rounded the way the JAX package rounds them (0-d arrays of the
    working dtype)."""

    def __init__(self, dtype, device):
        const = lambda v: torch.tensor(v, dtype=dtype, device=device)
        self.const = const
        sigma = const(lines.DOPPLER_SIGMA)
        self.inv_sqrt2_sigma = 1.0 / (_SQRT_2 * sigma)
        self.voigt_norm = 1.0 / (sigma * _SQRT_2PI)
        self.c = const(lines.C_CGS)
        # divisors are 0-d tensors, not Python scalars: PyTorch divides by
        # a Python scalar as a multiply by its rounded reciprocal, which is
        # not the correctly rounded quotient the JAX package (and the CUDA
        # kernel) compute, and x = lambda * multiplier - c amplifies that
        # last-bit difference ~1e3 times
        self.angstrom_per_cm = const(1e8)

    def line(self, j):
        """(lambda_t, y, lead_j) of Lyman line j."""
        lambda_t = self.const(lines.TRANSITION_WAVELENGTHS[j])
        gamma_j = self.const(lines.LORENTZIAN_WIDTHS[j])
        lead_j = self.const(lines.LEADING_CONSTANTS[j])
        return lambda_t, gamma_j * self.inv_sqrt2_sigma, lead_j


def _samples(wavelengths, z_dla, nhi):
    dtype, device = wavelengths.dtype, wavelengths.device
    z = torch.as_tensor(z_dla, dtype=dtype, device=device)
    n = torch.as_tensor(nhi, dtype=dtype, device=device)
    scalar_sample = z.ndim == 0 and n.ndim == 0
    z, column = torch.broadcast_tensors(torch.atleast_1d(z), torch.atleast_1d(n))
    return z[..., :, None], column[..., :, None], scalar_sample


def voigt_absorption(
    padded_wavelengths,
    z_dla,
    nhi,
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    broaden: bool = True,
    fast: bool | None = None,
):
    """Absorption profile(s) of DLA(s) at (z_dla, nhi).

    Args:
      padded_wavelengths: (..., n) observed-frame wavelengths [Å],
        including ``width`` convolution-padding pixels at each edge.
      z_dla: scalar or (..., S) absorber redshifts.
      nhi: scalar or (..., S) column densities [cm^-2] (linear).
      num_lines: number of Lyman-series members (set_parameters.m:63).
      broaden: apply instrumental broadening (dropping 2*width pixels).
      fast: small-y fast Faddeeva path; default: fast for float32,
        accurate for float64.

    Returns:
      (n - 2*width,) for scalar samples, else (..., S, n - 2*width).
    """
    if instrument is None:
        instrument = InstrumentParams()
    wavelengths = torch.as_tensor(padded_wavelengths)
    z, column, scalar_sample = _samples(wavelengths, z_dla, nhi)
    raw_profile = torch.exp(column * _depth(wavelengths, z, num_lines, fast))
    profile = (
        instrumental_broadening(raw_profile, instrument) if broaden else raw_profile
    )
    if scalar_sample:
        profile = profile[..., 0, :]
    return profile


def window_starts(padded_wavelengths, z_first, lambda_t, window, pixel_spacing):
    """First pixel of each row's core window for one line: the pixel of
    the line center at the chunk's lowest z, less WINDOW_MARGIN, clipped
    so the window stays on the grid.  Integer tensor of z_first's shape."""
    P6 = padded_wavelengths.shape[-1]
    W = min(window, P6)
    spacing = torch.tensor(pixel_spacing, dtype=z_first.dtype, device=z_first.device)
    center_lo = torch.log10(lambda_t * 1e8 * (1.0 + z_first))
    log_lam0 = torch.log10(padded_wavelengths[..., 0])
    start = (
        torch.floor((center_lo - log_lam0) / spacing).to(torch.int64)
        - WINDOW_MARGIN
    )
    return torch.clamp(start, 0, P6 - W)


def voigt_absorption_windowed(
    padded_wavelengths,
    z_dla_sorted,
    nhi,
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int = 128,
):
    """Windowed fast absorption for a z-ASCENDING chunk of samples.

    The Lorentzian term (global G) is computed on the whole grid; the
    full fast-path value replaces it on a ``window``-pixel slice per line
    placed from the chunk's lowest z (the Gaussian core is below 1.4e-11
    relative outside it).  Each batch row places its own windows.

    Caller contract: samples ascending along the last axis, ``window`` at
    least the chunk's line-center spread in pixels plus 2*WINDOW_MARGIN
    (inference.compute_sample_window).  float32 only, as in the JAX
    package.
    """
    if instrument is None:
        instrument = InstrumentParams()
    wavelengths = torch.as_tensor(padded_wavelengths)
    z, column, _ = _samples(wavelengths, z_dla_sorted, nhi)
    total = _depth_windowed(wavelengths, z, num_lines, instrument, window)
    return instrumental_broadening(torch.exp(column * total), instrument)


def pair_absorption(
    padded_wavelengths,
    z_dla,
    nhi,
    z_dla2,
    nhi2,
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int | None = None,
):
    """Broadened absorption of absorber PAIRS, (..., S, n - 2*width).

    Optical depths add before one exp: exp(N1 t(z1) + N2 t(z2)), the
    product of the two raw profiles, broadened once (the instrument sees
    the product; gp_dla_detection_tpu/multi_dla.py::_second_dla_chunk).
    ``window`` set (float32 only): the first axis is z-ascending and
    takes the windowed core, as :func:`voigt_absorption_windowed`; the
    second axis need not be sorted and always takes the full grid.  float32
    uses the fast Faddeeva path, float64 the accurate one.
    """
    if instrument is None:
        instrument = InstrumentParams()
    wavelengths = torch.as_tensor(padded_wavelengths)
    z, column, _ = _samples(wavelengths, z_dla, nhi)
    z2, column2, _ = _samples(wavelengths, z_dla2, nhi2)
    if window is None:
        total = _depth(wavelengths, z, num_lines)
    else:
        total = _depth_windowed(wavelengths, z, num_lines, instrument, window)
    total2 = _depth(wavelengths, z2, num_lines)
    return instrumental_broadening(
        torch.exp(column * total + column2 * total2), instrument
    )


def _depth(wavelengths, z, num_lines: int, fast: bool | None = None):
    """-sum_lines lead_j voigt(x_j) on the whole grid, per unit column
    density: (..., S, n) for z (..., S, 1).  ``fast``: the small-y
    Faddeeva path; default fast for float32, accurate for float64."""
    dtype = wavelengths.dtype
    k = _LineConstants(dtype, wavelengths.device)
    if fast is None:
        fast = dtype == torch.float32
    wofz_fn = wofz_real_fast if fast else wofz_real

    lam = wavelengths[..., None, :]
    total = None
    for j in range(num_lines):
        lambda_t, y, lead_j = k.line(j)
        # velocity relative to the redshifted line [cm/s]; wavelengths
        # in Å, transition wavelengths in cm (1 Å = 1e-8 cm)
        multiplier = k.c / (lambda_t * (1.0 + z)) / k.angstrom_per_cm
        x = (lam * multiplier - k.c) * k.inv_sqrt2_sigma
        term = (lead_j * k.voigt_norm) * wofz_fn(x, y.expand(x.shape))
        total = -term if total is None else total - term
    return total


def _depth_windowed(wavelengths, z, num_lines: int, instrument, window: int):
    """:func:`_depth` with the Gaussian core on a ``window``-pixel slice
    per line and row (z ascending along the sample axis; float32)."""
    dtype = wavelengths.dtype
    if dtype != torch.float32:
        raise ValueError(
            "voigt_absorption_windowed is the float32 fast path; use "
            f"voigt_absorption for dtype={dtype} (accurate Faddeeva)"
        )
    P6 = wavelengths.shape[-1]
    W = min(window, P6)
    k = _LineConstants(dtype, wavelengths.device)
    cols = torch.arange(W, device=wavelengths.device)

    lam = wavelengths[..., None, :]
    total = None
    for j in range(num_lines):
        lambda_t, y, lead_j = k.line(j)
        multiplier = k.c / (lambda_t * (1.0 + z)) / k.angstrom_per_cm
        x = (lam * multiplier - k.c) * k.inv_sqrt2_sigma
        h = (2.0 / _SQRT_PI) * y * g_function(x)

        start = window_starts(
            wavelengths, z[..., 0, 0], lambda_t, W, instrument.pixel_spacing
        )
        idx = start[..., None] + cols                         # (..., W)
        lam_win = torch.gather(wavelengths, -1, idx)
        x_win = (lam_win[..., None, :] * multiplier - k.c) * k.inv_sqrt2_sigma
        h_win = wofz_real_fast(x_win, y.expand(x_win.shape))
        h = h.scatter(-1, idx[..., None, :].expand(h_win.shape), h_win)

        term = (lead_j * k.voigt_norm) * h
        total = -term if total is None else total - term
    return total
