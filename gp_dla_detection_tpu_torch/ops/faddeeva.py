"""Faddeeva function (real part) in plain PyTorch.

Counterpart of ``gp_dla_detection_tpu/ops/faddeeva.py``; the same
formulas, branch for branch, on torch tensors of any float dtype and
device.  The complex arithmetic stays in explicit (real, imag) pairs as
in the JAX package, although torch has complex dtypes: the same formulas
feed the CUDA evidence kernel, which works in real pairs.

``wofz_real`` is the accurate three-branch path (continued fraction for
|z| >= 7, Weideman N=64 rational approximation, order-4 Taylor in y
about the real axis for y < 1e-3), used in float64.  ``wofz_real_fast``
= ``exp_core`` + (2y/sqrt(pi)) ``g_function`` is the small-y fast path
used in float32 and by the kernel.  See the JAX module for the error
budget of each branch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "wofz_real",
    "wofz_real_fast",
    "g_function",
    "exp_core",
    "WEIDEMAN_N",
    "BRANCH_RADIUS",
]

WEIDEMAN_N = 64
BRANCH_RADIUS = 7.0   # |z| cutoff between rational and continued fraction
SMALL_Y = 1e-3        # y cutoff for the Taylor-in-y branch
CF_DEPTH = 12
_SQRT_PI = float(np.sqrt(np.pi))
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))


@functools.lru_cache(maxsize=None)
def _weideman_constants(n: int) -> tuple[float, tuple[float, ...]]:
    """Weideman (1994) scale L and polynomial coefficients (highest first),
    computed in float64 numpy exactly as the JAX package does."""
    m = 2 * n
    m2 = 2 * m
    k = np.arange(-m + 1, m)
    ell = np.sqrt(n / np.sqrt(2.0))
    theta = k * np.pi / m
    t = ell * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (ell**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = a[1 : n + 1][::-1]  # highest-degree coefficient first
    return float(ell), tuple(float(c) for c in a)


def _as_pair(x, y):
    """Broadcast x and y to one float tensor shape and dtype."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    return torch.broadcast_tensors(x.to(dtype), y.to(dtype))


def _w_weideman(x, y, n: int = WEIDEMAN_N):
    """Complex w(x + iy) as a (re, im) pair via Weideman's rational
    approximation (Im z >= 0).  Real arithmetic only."""
    ell, coeffs = _weideman_constants(n)
    # recip = 1 / (L - iz) = 1 / ((L + y) - i x)
    dr = ell + y
    di = -x
    inv_norm = 1.0 / (dr * dr + di * di)
    rr = dr * inv_norm
    ri = -di * inv_norm
    # Z = (L + iz) * recip;  L + iz = (L - y) + i x
    nr = ell - y
    ni = x
    zr = nr * rr - ni * ri
    zi = nr * ri + ni * rr
    # Horner in Z with real coefficients
    pr = torch.full_like(x, coeffs[0])
    pi = torch.zeros_like(x)
    for c in coeffs[1:]:
        pr, pi = pr * zr - pi * zi + c, pr * zi + pi * zr
    # w = 2 * p * recip^2 + (1/sqrt(pi)) * recip
    r2r = rr * rr - ri * ri
    r2i = 2.0 * rr * ri
    wr = 2.0 * (pr * r2r - pi * r2i) + _INV_SQRT_PI * rr
    wi = 2.0 * (pr * r2i + pi * r2r) + _INV_SQRT_PI * ri
    return wr, wi


def _w_continued_fraction(x, y, depth: int = CF_DEPTH):
    """Re w(x+iy) by the Gautschi continued fraction; accurate |z| >= ~6.

    r <- (m/2) / (z - r), then w = (i/sqrt(pi)) / (z - r), as real pairs.
    """
    rr = torch.zeros_like(x)
    ri = torch.zeros_like(x)
    for m in range(depth, 0, -1):
        dr = x - rr
        di = y - ri
        scale = (m / 2.0) / (dr * dr + di * di)
        rr = scale * dr
        ri = -scale * di
    dr = x - rr
    di = y - ri
    inv_norm = _INV_SQRT_PI / (dr * dr + di * di)
    # i / (dr + i di) = (di + i dr) / |d|^2
    return di * inv_norm, dr * inv_norm


def wofz_real(x, y):
    """Re w(x + iy) for y >= 0, elementwise, dtype-preserving.

    ``x`` and ``y`` broadcast against each other.  ~1e-12 relative to
    scipy.special.wofz in the small-y DLA regime in float64.
    """
    x, y = _as_pair(x, y)

    ax = torch.abs(x)  # Re w is even in x
    r2 = ax * ax + y * y
    outer = r2 >= BRANCH_RADIUS * BRANCH_RADIUS

    # branch 1: continued fraction (clamp inner z to avoid 0-division)
    safe_ax = torch.where(outer, ax, torch.full_like(ax, BRANCH_RADIUS))
    w_cf, _ = _w_continued_fraction(safe_ax, y)

    # branches 2 and 3 share ONE Weideman Horner: branch 2 reads Re w at
    # (|x|, y) where y >= SMALL_Y, branch 3 reads Im w at (|x|, 0) where
    # y < SMALL_Y
    small = y < SMALL_Y
    w_in_re, w_axis_im = _w_weideman(ax, torch.where(small, torch.zeros_like(y), y))

    # branch 3: small-y Taylor about the real axis (order 4)
    wm_prev_r = torch.exp(-ax * ax)
    wm_prev_i = w_axis_im
    # w'(x) = -2x w(x) + 2i/sqrt(pi)
    wm_r = -2.0 * ax * wm_prev_r
    wm_i = -2.0 * ax * wm_prev_i + 2.0 * _INV_SQRT_PI
    # sum_m (iy)^m w_m / m!; (iy)^m cycles {1, iy, -y^2, -iy^3, y^4}
    series = wm_prev_r
    pow_r = torch.ones_like(y)
    pow_i = torch.zeros_like(y)
    factorial = 1.0
    for m in range(1, 5):
        pow_r, pow_i = -pow_i * y, pow_r * y  # multiply by iy
        factorial *= m
        series = series + (pow_r * wm_r - pow_i * wm_i) / factorial
        next_r = -2.0 * ax * wm_r - 2.0 * m * wm_prev_r
        next_i = -2.0 * ax * wm_i - 2.0 * m * wm_prev_i
        wm_prev_r, wm_prev_i = wm_r, wm_i
        wm_r, wm_i = next_r, next_i

    inner_val = torch.where(small, series, w_in_re)
    return torch.where(outer, w_cf, inner_val)


# --- the global G(x) polynomial fit -----------------------------------
#
# G(x) = 2x F(x) - 1 (F = Dawson), fitted for ALL real x in the
# compactifying variable s = 1/(1 + x^2/_G_A) as G = s * P(s); degree 12
# in production.  See the JAX module for the fit's derivation and error.
_G_A = 6.0
_G_NUM_DEG = 12


@functools.lru_cache(maxsize=None)
def _g_global_coeffs(degree: int = _G_NUM_DEG) -> tuple[float, ...]:
    """Power coefficients (ascending, in s) of the global G fit.

    The same float64 numpy fit as the JAX package (iteratively
    reweighted least squares against the Weideman evaluation of
    G = sqrt(pi) x Im w(x + i0) - 1), so the tuple is bit-equal to the
    JAX one.
    """
    x = np.concatenate(
        [
            np.linspace(0.0, 12.0, 24001)[1:],
            10 ** np.linspace(np.log10(12.0), 5.0, 8001),
        ]
    )
    ell, coeffs = _weideman_constants(WEIDEMAN_N)
    iz = 1j * x
    recip = 1.0 / (ell - iz)
    big_z = (ell + iz) * recip
    p = np.polyval(np.asarray(coeffs), big_z)
    w = 2.0 * p * recip**2 + _INV_SQRT_PI * recip
    g = _SQRT_PI * x * np.imag(w) - 1.0

    y_max = 4.8e-4  # largest Lyman-series gamma/(sigma sqrt 2)
    slack = (_SQRT_PI / (2 * y_max)) * np.exp(-np.minimum(x * x, 200.0))
    den = np.maximum(np.abs(g), slack)
    s = 1.0 / (1.0 + x * x / _G_A)
    vm = np.vander(s, degree + 1, increasing=True)
    extra = np.ones_like(s)
    best = None
    # one plain weighted solve, then 70 peak-reweighted refinements
    for it in range(71):
        wgt = extra / den
        a = wgt[:, None] * vm * s[:, None]
        sol, *_ = np.linalg.lstsq(a, wgt * g, rcond=None)
        err = np.abs(s * (vm @ sol) - g) / den
        mx = err.max()
        if best is None or mx < best[0]:
            best = (mx, sol.copy())
        extra *= np.sqrt(1.0 + err / mx)
        extra /= extra.mean()
    _, p_c = best
    return tuple(float(c) for c in p_c)


def g_function(x, degree: int | None = None):
    """G(x) = 2x F(x) - 1 for all real x by the global polynomial fit
    (one reciprocal, even in x).  wofz_real_fast = exp_core +
    (2y/sqrt(pi)) g_function, and the windowed paths complete exactly
    this function inside their windows."""
    p_c = _g_global_coeffs(_G_NUM_DEG if degree is None else degree)
    x2 = x * x
    one = torch.ones_like(x2)
    s = one / (one + x2 * (1.0 / _G_A))
    num = torch.full_like(s, p_c[-1])
    for c in p_c[-2::-1]:
        num = num * s + c
    return s * num


def exp_core(x2, y):
    """The Gaussian-core term of the small-y expansion of Re w:
    e^{-x^2} (1 + y^2 (2x^2 - 1)).  Below 1.4e-11 of the Lorentzian term
    for |x| > ~5, so windowed consumers add it only inside windows."""
    return torch.exp(-torch.clamp(x2, max=90.0)) * (
        1.0 + y * y * (2.0 * x2 - 1.0)
    )


FAST_MAX_Y = 1e-2  # validity bound of the small-y expansion


def wofz_real_fast(x, y):
    """Fast-path Re w(x + iy) for small y (y < ~1e-2), the DLA regime:

        Re w = e^{-x^2} (1 + y^2 (2x^2 - 1)) + (2y/sqrt(pi)) G(x)

    Worst relative error 1.3e-5 at the largest Lyman-series y.
    """
    x, y = _as_pair(x, y)
    return exp_core(x * x, y) + (2.0 / _SQRT_PI) * y * g_function(x)
