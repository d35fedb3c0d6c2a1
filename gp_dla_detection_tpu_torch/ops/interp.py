"""Linear interpolation (MATLAB interp1 / griddedInterpolant semantics).

Counterpart of ``gp_dla_detection_tpu/ops/interp.py``.  The query tensor
may carry any batch axes (the JAX package vmaps over spectra; here the
batch axis is written out), the grid ``xp`` is 1-D and strictly
increasing.  ``interp1`` and ``interp_columns`` bracket by binary search
on any grid; the ``_uniform`` variants by arithmetic on a uniformly
spaced grid, bit-identical to the binary search there, and
``interp_stack_uniform`` (the inference path) interpolates several
quantities with one bracketing and one row gather.
"""

from __future__ import annotations

import torch

__all__ = [
    "interp1",
    "interp_columns",
    "interp1_uniform",
    "interp_columns_uniform",
    "interp_stack_uniform",
]


def _bracket(xp, x):
    """Interval index and weight of each x on any increasing xp, by
    searchsorted(side="right") (clamped to the end intervals)."""
    idx = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, xp.shape[0] - 2)
    x0 = xp[idx]
    x1 = xp[idx + 1]
    t = (x - x0) / (x1 - x0)
    return idx, t


def _bracket_uniform(xp, x):
    """Interval index and weight of each x on a UNIFORMLY spaced xp.

    The index comes from arithmetic, then one +-1 correction against the
    actual knots gives searchsorted(side="right") semantics even when xp
    carries ulp-level rounding, so the result is bit-equal to the JAX
    package's ``_bracket_uniform`` (and to a binary search) in float64.
    """
    n = xp.shape[0]
    inv_dx = (n - 1) / (xp[-1] - xp[0])
    idx = torch.clamp(
        torch.floor((x - xp[0]) * inv_dx).to(torch.int64), 0, n - 2
    )
    # x == xp[i] brackets [i, i+1) with t = 0
    idx = torch.where(x < xp[idx], idx - 1, idx)
    idx = torch.clamp(torch.where(x >= xp[idx + 1], idx + 1, idx), 0, n - 2)
    x0 = xp[idx]
    x1 = xp[idx + 1]
    t = (x - x0) / (x1 - x0)
    return idx, t


def _lerp(fp, idx, t):
    return fp[idx] * (1.0 - t) + fp[idx + 1] * t


def _lerp_columns(columns, idx, t):
    return columns[idx, :] * (1.0 - t)[..., None] + columns[idx + 1, :] * t[..., None]


def interp1(xp, fp, x):
    """Linear interpolation of ``fp`` (n,) on ``xp`` at ``x`` (...),
    edge-clamped like griddedInterpolant inside the data range (queries
    outside are extrapolated from the end interval)."""
    return _lerp(fp, *_bracket(xp, x))


def interp_columns(xp, columns, x):
    """Interpolate the columns of ``columns`` (n, k) at ``x`` (...):
    (..., k), one bracketing shared by every column (the reference's
    M_interpolator, process_qsos.m:67-68)."""
    return _lerp_columns(columns, *_bracket(xp, x))


def interp1_uniform(xp, fp, x):
    """:func:`interp1` for a uniformly spaced xp, without the binary
    search (bit-identical on such grids)."""
    return _lerp(fp, *_bracket_uniform(xp, x))


def interp_columns_uniform(xp, columns, x):
    """:func:`interp_columns` for a uniformly spaced xp."""
    return _lerp_columns(columns, *_bracket_uniform(xp, x))


def interp_stack_uniform(xp, stack, x):
    """Interpolate several quantities over ONE shared uniform grid with
    one bracketing and one row gather.

    ``stack``: sequence of (n,) or (n, k) tensors on the grid ``xp``;
    ``x``: (..., m) query points.  Returns the interpolated tensors,
    (..., m) or (..., m, k).  Each element is fp[idx]*(1-t) + fp[idx+1]*t,
    as in the JAX package.
    """
    stack = list(stack)
    flat = [a.ndim == 1 for a in stack]
    arrs = [a if a.ndim == 2 else a[:, None] for a in stack]
    widths = [a.shape[1] for a in arrs]
    f = torch.cat(arrs, dim=1)
    ff = torch.cat([f[:-1], f[1:]], dim=1)          # (n-1, 2w)
    idx, t = _bracket_uniform(xp, x)
    rows = ff[idx]                                   # (..., m, 2w)
    w = f.shape[1]
    out = rows[..., :w] * (1.0 - t)[..., None] + rows[..., w:] * t[..., None]
    pieces = []
    start = 0
    for was_flat, width in zip(flat, widths):
        piece = out[..., start : start + width]
        pieces.append(piece[..., 0] if was_flat else piece)
        start += width
    return pieces
