"""Plain physics of the DLA model: Lyman-series constants, the
instrument, the accurate Faddeeva function and the broadened Voigt
absorption profile.

A frozen copy, in plain PyTorch, of the mathematics of Garnett et al.
2017 (arXiv:1605.04460; voigt.c, set_parameters.m) as the port states
it: the same constants and the same three-branch Re w(z) (Gautschi's
continued fraction for |z| >= 7, Weideman's N = 64 rational
approximation, an order-4 Taylor series in y below y = 1e-3).  It is
evaluated on the full pixel grid, with no window and no small-y
shortcut, at whatever dtype its inputs carry (float64 for the
reference).  Nothing here imports the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# CGS constants (voigt.c:22-28) and the gas temperature (voigt.c:137)
C_CGS = 2.99792458e10
K_B = 1.38064852e-16
M_P = 1.672621898e-24
M_E = 9.10938356e-28
E_CHARGE = 1.6021766208e-19 * C_CGS / 10.0
GAS_TEMPERATURE = 1.0e4

# the first three members of the Lyman series: wavelength [cm],
# oscillator strength, transition rate [1/s]
TRANSITION_WAVELENGTHS = np.array([1.2156701e-05, 1.0257223e-05, 9.725368e-06])
OSCILLATOR_STRENGTHS = np.array([0.416400, 0.079120, 0.029000])
TRANSITION_RATES = np.array([6.265e08, 1.897e08, 8.127e07])
LEADING_CONSTANTS = (
    np.pi * E_CHARGE**2 * OSCILLATOR_STRENGTHS * TRANSITION_WAVELENGTHS / (M_E * C_CGS)
)
LORENTZIAN_WIDTHS = TRANSITION_RATES * TRANSITION_WAVELENGTHS / (4.0 * np.pi)
DOPPLER_SIGMA = float(np.sqrt(K_B * GAS_TEMPERATURE / M_P))

LYA_WAVELENGTH = 1215.6701   # [Å]
LYMAN_LIMIT = 911.7633       # [Å]
SPEED_OF_LIGHT_KMS = 299792.458

WEIDEMAN_N = 64
BRANCH_RADIUS = 7.0
SMALL_Y = 1e-3
CF_DEPTH = 12
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))


def kms_to_z(kms: float) -> float:
    """A velocity [km/s] as a redshift difference (set_parameters.m:11)."""
    return kms / SPEED_OF_LIGHT_KMS


def instrument_taps(width: int, pixel_spacing: float, resolving_power: float) -> np.ndarray:
    """The normalized (2 width + 1)-tap Gaussian of the spectrograph
    (voigt.c:232-251)."""
    pixel_sigma = 1.0 / (
        resolving_power * 2.0 * np.sqrt(2.0 * np.log(2.0)) * (10.0**pixel_spacing - 1.0)
    )
    offsets = np.arange(-width, width + 1, dtype=np.float64)
    taps = np.exp(-0.5 * offsets**2 / pixel_sigma**2)
    return taps / taps.sum()


@functools.lru_cache(maxsize=None)
def _weideman_constants(n: int):
    m = 2 * n
    k = np.arange(-m + 1, m)
    ell = np.sqrt(n / np.sqrt(2.0))
    t = ell * np.tan(k * np.pi / m / 2.0)
    f = np.concatenate([[0.0], np.exp(-(t**2)) * (ell**2 + t**2)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return float(ell), tuple(float(c) for c in a[1 : n + 1][::-1])


def _w_weideman(x, y):
    ell, coeffs = _weideman_constants(WEIDEMAN_N)
    dr, di = ell + y, -x
    inv_norm = 1.0 / (dr * dr + di * di)
    rr, ri = dr * inv_norm, -di * inv_norm
    nr, ni = ell - y, x
    zr, zi = nr * rr - ni * ri, nr * ri + ni * rr
    pr, pi = torch.full_like(x, coeffs[0]), torch.zeros_like(x)
    for c in coeffs[1:]:
        pr, pi = pr * zr - pi * zi + c, pr * zi + pi * zr
    r2r, r2i = rr * rr - ri * ri, 2.0 * rr * ri
    wr = 2.0 * (pr * r2r - pi * r2i) + _INV_SQRT_PI * rr
    wi = 2.0 * (pr * r2i + pi * r2r) + _INV_SQRT_PI * ri
    return wr, wi


def _w_continued_fraction(x, y):
    rr, ri = torch.zeros_like(x), torch.zeros_like(x)
    for m in range(CF_DEPTH, 0, -1):
        dr, di = x - rr, y - ri
        scale = (m / 2.0) / (dr * dr + di * di)
        rr, ri = scale * dr, -scale * di
    dr, di = x - rr, y - ri
    return di * _INV_SQRT_PI / (dr * dr + di * di)


def wofz_real(x, y):
    """Re w(x + iy) for y >= 0, elementwise (x and y of one shape)."""
    ax = torch.abs(x)
    outer = ax * ax + y * y >= BRANCH_RADIUS**2
    w_cf = _w_continued_fraction(torch.where(outer, ax, torch.full_like(ax, BRANCH_RADIUS)), y)
    small = y < SMALL_Y
    w_in, w_axis_im = _w_weideman(ax, torch.where(small, torch.zeros_like(y), y))
    # Taylor in y about the real axis: w' = -2x w + 2i/sqrt(pi)
    prev_r, prev_i = torch.exp(-ax * ax), w_axis_im
    cur_r, cur_i = -2.0 * ax * prev_r, -2.0 * ax * prev_i + 2.0 * _INV_SQRT_PI
    series = prev_r
    pow_r, pow_i = torch.ones_like(y), torch.zeros_like(y)
    factorial = 1.0
    for m in range(1, 5):
        pow_r, pow_i = -pow_i * y, pow_r * y
        factorial *= m
        series = series + (pow_r * cur_r - pow_i * cur_i) / factorial
        nxt_r = -2.0 * ax * cur_r - 2.0 * m * prev_r
        nxt_i = -2.0 * ax * cur_i - 2.0 * m * prev_i
        prev_r, prev_i, cur_r, cur_i = cur_r, cur_i, nxt_r, nxt_i
    return torch.where(outer, w_cf, torch.where(small, series, w_in))


def extend_wavelengths(wavelengths, width: int, pixel_spacing: float):
    """``width`` log-continuation pixels at each end of (..., P)
    wavelengths (process_qsos.m:169-177)."""
    steps = torch.arange(1, width + 1, dtype=wavelengths.dtype, device=wavelengths.device)
    dex = torch.pow(10.0, pixel_spacing * steps)
    return torch.cat(
        [wavelengths[..., :1] / torch.flip(dex, (0,)), wavelengths, wavelengths[..., -1:] * dex],
        dim=-1,
    )


def optical_depth(ext_wavelengths, z, num_lines: int):
    """Optical depth per unit column density, (..., S, P6), of absorbers
    at redshifts z (..., S) on the extended grid (..., P6): the sum over
    Lyman lines of lead_j * Voigt(v_j) (voigt.c:277-291)."""
    dt, dev = ext_wavelengths.dtype, ext_wavelengths.device
    const = lambda v: torch.tensor(v, dtype=dt, device=dev)
    sigma = const(DOPPLER_SIGMA)
    inv_sqrt2_sigma = 1.0 / (np.sqrt(2.0) * sigma)
    norm = 1.0 / (sigma * np.sqrt(2.0 * np.pi))
    c = const(C_CGS)
    lam = ext_wavelengths[..., None, :]
    total = torch.zeros(z.shape + ext_wavelengths.shape[-1:], dtype=dt, device=dev)
    for j in range(num_lines):
        lambda_t = const(TRANSITION_WAVELENGTHS[j])
        y = const(LORENTZIAN_WIDTHS[j]) * inv_sqrt2_sigma
        multiplier = c / (lambda_t * (1.0 + z[..., None])) / const(1e8)
        x = (lam * multiplier - c) * inv_sqrt2_sigma
        total = total + const(LEADING_CONSTANTS[j]) * norm * wofz_real(x, y.expand(x.shape))
    return total


def broaden(raw, taps):
    """'Valid' convolution with the instrument's taps along the last
    axis: (..., P6) -> (..., P6 - len(taps) + 1)."""
    n_out = raw.shape[-1] - len(taps) + 1
    out = None
    for j, tap in enumerate(taps):
        piece = float(tap) * raw[..., j : j + n_out]
        out = piece if out is None else out + piece
    return out


def absorption(ext_wavelengths, absorbers, num_lines: int, taps):
    """Broadened absorption exp(-sum_a N_a tau(z_a)) of one or more
    absorbers per sample: ``absorbers`` is a list of (z, N_HI) pairs of
    (..., S) tensors, whose optical depths add before one exp.
    Returns (..., S, P6 - 2 width)."""
    tau = None
    for z, nhi in absorbers:
        t = nhi[..., None] * optical_depth(ext_wavelengths, z, num_lines)
        tau = t if tau is None else tau + t
    return broaden(torch.exp(-tau), taps)
