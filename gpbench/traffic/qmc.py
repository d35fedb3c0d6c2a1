"""The QMC prior samples of (z offset, N_HI) (generate_dla_samples.m:8-63).

A frozen copy of the sampler the configuration states: the first S
points of the RR2-scrambled Halton sequence in bases 2 and 3; the first
coordinate is the z offset, the second is pushed through the inverse CDF
of a mixture of a quadratic fit to the log KDE of a catalogue's log N_HI
(weight alpha) and a uniform on [uniform_min, uniform_max].
"""

from __future__ import annotations

import numpy as np


def _rr2_permutation(base: int) -> np.ndarray:
    nbits = max(1, int(np.ceil(np.log2(base))))
    v = np.arange(2**nbits)
    rev = np.zeros_like(v)
    for _ in range(nbits):
        rev = (rev << 1) | (v & 1)
        v = v >> 1
    return rev[rev < base]


def halton_rr2(n: int, dims: int = 2) -> np.ndarray:
    """The first n points of the RR2-scrambled Halton sequence, (n, dims);
    point 0 is the origin."""
    primes = [2, 3, 5, 7, 11, 13]
    out = np.zeros((n, dims))
    for d in range(dims):
        base, perm = primes[d], _rr2_permutation(primes[d])
        i = np.arange(n, dtype=np.int64)
        factor, value = 1.0 / base, np.zeros(n)
        while np.any(i > 0):
            value += perm[i % base] * factor
            factor /= base
            i //= base
        out[:, d] = value
    return out


def _ksdensity(data: np.ndarray, points: np.ndarray) -> np.ndarray:
    """A Gaussian KDE with MATLAB ksdensity's default bandwidth."""
    n = data.size
    med = np.median(data)
    sig = np.median(np.abs(data - med)) / 0.6745
    if sig <= 0:
        sig = np.std(data, ddof=1)
    bw = sig * (4.0 / (3.0 * n)) ** 0.2
    z = (points[:, None] - data[None, :]) / bw
    return np.exp(-0.5 * z**2).sum(axis=1) / (n * bw * np.sqrt(2 * np.pi))


def _cumulative(y: np.ndarray, dx: float) -> np.ndarray:
    dy = np.gradient(y, dx)
    seg = 0.5 * dx * (y[1:] + y[:-1]) - dx**2 / 12.0 * (dy[1:] - dy[:-1])
    return np.concatenate([[0.0], np.cumsum(seg)])


def dla_samples(num_samples: int, observed_log_nhis: np.ndarray, alpha: float,
                uniform_min: float, uniform_max: float, fit_min: float, fit_max: float,
                grid_points: int = 200_001):
    """(offsets (S,), log10 N_HI (S,)), float64."""
    seq = halton_rr2(num_samples, 2)
    x = np.linspace(fit_min, fit_max, 1000)
    coeffs = np.polyfit(x, np.log(_ksdensity(np.asarray(observed_log_nhis, float), x)), 2)
    grid = np.linspace(fit_min, 25.0, grid_points)
    dx = grid[1] - grid[0]
    unnorm = np.exp(np.polyval(coeffs, grid))
    uniform = np.where((grid >= uniform_min) & (grid <= uniform_max),
                       1.0 / (uniform_max - uniform_min), 0.0)
    mixture = alpha * unnorm / _cumulative(unnorm, dx)[-1] + (1.0 - alpha) * uniform
    cdf = np.maximum.accumulate(_cumulative(mixture, dx))
    cdf /= cdf[-1]
    return seq[:, 0], np.interp(seq[:, 1], cdf, grid)
