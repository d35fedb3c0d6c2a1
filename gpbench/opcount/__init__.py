"""The frozen count of the work the configuration's mathematics needs,
from shapes alone, and the least time one NVIDIA H100 SXM needs for it
at its published peaks.

It counts what any implementation of the same mathematics has to do,
not the instructions of today's kernels:

- the Voigt profile at every (sample, extended pixel, line): the
  velocity, x^2 and the Lorentzian wing, PROFILE_FLOPS; its Gaussian
  core at every (sample, window pixel, line) inside the configuration's
  window, CORE_FLOPS (the base axis of the pair, which no window
  covers, at every extended pixel);
- the optical depth's exp at every (sample, extended pixel), and for the
  pair the sum of the two depths;
- the instrument's convolution, one multiply-add per tap and pixel;
- the Woodbury weights at every (sample, pixel), WEIGHT_FLOPS;
- the rank-k Gram (k(k+1)/2 multiply-adds) and projection (k) at every
  (sample, pixel), counted once as multiply-adds: the matrix products;
- the k x k Cholesky and solve of every sample;
- the pair's base axis once per draw of the R-replicated layout;
- each input byte read once and each output byte written once.

Peaks (NVIDIA's H100 SXM data sheet, dense): 67e12 FP32 FLOP/s outside
the tensor cores, 495e12 TF32 FLOP/s for the matrix products, 34e12
FP64 FLOP/s outside the tensor cores, 3.35e12 B/s.  The pipes run side
by side, so the least time is the largest of the four.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PEAK_FP32 = 67e12
PEAK_MATRIX = 495e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12

PROFILE_FLOPS = 8   # velocity (2), x^2 (1), wing 1/(1 + x^2/a) and its scale (3), accumulate (2)
CORE_FLOPS = 6      # exp(-x^2) (2), (1 + y^2 (2x^2 - 1)) (3), add (1)
EXP_FLOPS = 2       # N tau and its exp
WEIGHT_FLOPS = 12   # a^2, d, 1/d, y - mu a, w, u, yc^2/d, log d
REDRAW_FLOPS = 6    # exp, the running sum, the normalization, the grid cell
CDDF_FLOPS = 40     # the weights, the masses, the bins, the moments
SAMPLE_TILE = 256   # the sample tile the configuration's window is sized for
WINDOW_MARGIN = 40  # pixels each side of a tile's line-centre spread


@dataclass(frozen=True)
class Work:
    fp32: float = 0.0
    matrix: float = 0.0
    fp64: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.fp32 + o.fp32, self.matrix + o.matrix, self.fp64 + o.fp64,
                    self.bytes + o.bytes)

    def __mul__(self, c: float) -> "Work":
        return Work(self.fp32 * c, self.matrix * c, self.fp64 * c, self.bytes * c)

    def least_seconds(self) -> float:
        return max(self.fp32 / PEAK_FP32, self.matrix / PEAK_MATRIX, self.fp64 / PEAK_FP64,
                   self.bytes / PEAK_BYTES)


def sample_window(offsets, pixels_ext: int, num_lines: int, pixel_spacing: float,
                  lya: float = 1215.6701, lyman_limit: float = 911.7633):
    """The configuration's window in pixels: the widest line-centre
    spread of SAMPLE_TILE consecutive z-sorted samples, plus the margin
    each side, rounded up to 8; None when it would cover the grid."""
    off = np.sort(np.asarray(offsets, np.float64))
    m = min(SAMPLE_TILE, len(off))
    if m <= 1 or num_lines > 8:
        return None
    spread = float(np.max(off[m - 1 :] - off[: len(off) - m + 1]))
    exact = np.log10(1.0 + spread * (lya / lyman_limit - 1.0)) / pixel_spacing
    window = int(np.ceil(max(spread * pixels_ext, exact))) + 2 * WINDOW_MARGIN
    window = -(-window // 8) * 8
    return window if window < pixels_ext else None


def _woodbury(rows: float, P: int, k: int, taps: int) -> Work:
    """Per sample row: the convolution, the weights, the Gram, the
    projection, the Cholesky and solve."""
    per = Work(fp32=P * (2 * taps + WEIGHT_FLOPS) + k**3 / 3 + 2 * k * k,
               matrix=P * (k * (k + 1) + 2 * k))
    return per * rows


def evidence_single(B: int, S: int, P: int, k: int, num_lines: int, taps: int,
                    window: int | None) -> Work:
    """One single-DLA evidence call of B spectra x S samples."""
    P6 = P + taps - 1
    W = P6 if window is None else min(window, P6)
    profile = Work(fp32=P6 * num_lines * PROFILE_FLOPS + W * num_lines * CORE_FLOPS
                   + P6 * EXP_FLOPS)
    io = Work(bytes=4.0 * B * (P6 + 5 * P + P * k + 3 * S))
    return (profile + _woodbury(1, P, k, taps)) * (B * S) + io


def evidence_pair(B: int, S: int, P: int, k: int, num_lines: int, taps: int,
                  window: int | None, base_draws: int) -> Work:
    """One pair evidence call: the fresh axis as the single, the base
    axis's profile once per distinct draw on the whole grid, the two
    depths summed at every (sample, extended pixel)."""
    P6 = P + taps - 1
    base = Work(fp32=P6 * num_lines * (PROFILE_FLOPS + CORE_FLOPS)) * (B * base_draws)
    extra = Work(fp32=P6 * 1.0, bytes=8.0) * (B * S)
    return evidence_single(B, S, P, k, num_lines, taps, window) + base + extra


def null_evidence(B: int, P: int, k: int) -> Work:
    per = Work(fp32=P * WEIGHT_FLOPS + k**3 / 3 + 2 * k * k, matrix=P * (k * (k + 1) + 2 * k),
               bytes=4.0 * (5 * P + P * k + 1))
    return per * B


def redraw(B: int, S: int) -> Work:
    return Work(fp32=REDRAW_FLOPS * B * S, bytes=4.0 * B * S + 8.0 * S + 8.0 * B * S)


def cddf(B: int, S: int, hist_cells: int, ex_width: int) -> Work:
    return Work(fp64=CDDF_FLOPS * B * S, bytes=16.0 * B * S + 4.0 * B * (hist_cells + ex_width))


def base_draws(S: int, replicates: int, tile: int = SAMPLE_TILE) -> int:
    """The distinct base draws of a row in the R-replicated layout."""
    pos = np.arange(S)
    width = tile // replicates
    return int(((pos // tile) * width + (pos % tile) % width).max()) + 1
