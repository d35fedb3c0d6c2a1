"""Linear interpolation on a uniform grid (MATLAB interp1 semantics).

Counterpart of ``gp_dla_detection_tpu/ops/interp.py`` for the two
functions the inference path uses.  The query tensor may carry any batch
axes (the JAX package vmaps over spectra; here the batch axis is written
out), the grid ``xp`` is 1-D and strictly increasing.
"""

from __future__ import annotations

import torch

__all__ = ["interp_stack_uniform"]


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
