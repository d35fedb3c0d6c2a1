"""The base redraw's posterior CDF and grid counts: the CUDA kernel, its
wrappers, its plain versions.

The fused lean chain draws each pair column's second absorber from the
1-DLA posterior by an inverse CDF at grid quantiles
(``multi_dla.device_inverse_cdf_grid``, the JAX package's
``device_inverse_cdf_grid``, which XLA computes; there is no TPU kernel).

- :func:`inverse_cdf_grid` is the wrapper.  On CUDA tensors it launches
  ``csrc/redraw.cu`` (float32 only) or raises; on CPU tensors it runs the
  plain version.  It never falls back on the card.
- :func:`posterior_cdf` launches the same kernel for the CDF alone, the
  entry that checks the kernel's counts against :func:`grid_counts_reference`
  of its own CDF.
- :func:`inverse_cdf_grid_reference`, :func:`posterior_cdf_reference` and
  :func:`grid_counts_reference` are the plain PyTorch versions, any dtype,
  any device.  On the card their ``torch.cumsum`` adds a row's float32
  entries in an order that depends on the number of rows; the kernel's
  order depends on the row alone, so its draws do not depend on the
  batch.
- :func:`posterior_cdf_in_kernel_order` is the kernel's scan in plain
  PyTorch, the same additions in the same order: on the card it gives
  the kernel's CDF bit for bit.  :func:`grid_cell_by_table` is the
  kernel's grid cell, the cell boundaries looked up in a table in place
  of :func:`grid_cells_reference`'s divisions.
- ``launch_count`` / ``cdf_launch_count`` count the kernel launches made
  by each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = [
    "MAX_SAMPLES",
    "cdf_launch_count",
    "grid_cell_by_table",
    "grid_cells_reference",
    "grid_counts_reference",
    "inverse_cdf_grid",
    "inverse_cdf_grid_reference",
    "launch_count",
    "max_grid_size",
    "posterior_cdf",
    "posterior_cdf_in_kernel_order",
    "posterior_cdf_reference",
]

# the kernel's float32 grid cells (m -+ 0.5) and sample counts are exact
# below 2**23
MAX_SAMPLES = 1 << 23
MAX_ROWS = (1 << 31) - 1
# the kernel's scan (csrc/redraw.cu): tiles of 256 threads x 16 entries
TILE_THREADS = 256
PER_THREAD = 16
TILE = TILE_THREADS * PER_THREAD
WARP = 32

launch_count = 0       # inverse_cdf_grid launches
cdf_launch_count = 0   # posterior_cdf launches


def posterior_cdf_reference(sample_log_likelihoods):
    """Per-row normalized posterior CDF of a (B, S) sample-likelihood
    tensor: NaN counts as -inf, and rows with no finite mass fall back to
    uniform weights (a zero-total CDF would divide to NaN)."""
    sll = sample_log_likelihoods
    neg_inf = torch.full((), -math.inf, dtype=sll.dtype, device=sll.device)
    finite = torch.where(torch.isnan(sll), neg_inf, sll)
    rowmax = torch.amax(finite, dim=1, keepdim=True)
    rowmax = torch.where(torch.isfinite(rowmax), rowmax, torch.zeros_like(rowmax))
    w = torch.exp(finite - rowmax)
    w = torch.where(w.sum(dim=1, keepdim=True) == 0.0, torch.ones_like(w), w)
    cdf = torch.cumsum(w, dim=1)
    return cdf / cdf[:, -1:]


def grid_cells_reference(cdf, s: int):
    """The grid cell of each CDF value, #{k < s : (k + 0.5)/s <= cdf_i}
    on the grid as the cdf's dtype computes it: one rounding, then an
    exact two-step correction against the grid's own arithmetic.

    The divisor is a 0-d tensor: PyTorch divides by a Python number as a
    multiply by its rounded reciprocal, which would move the cell
    boundaries off the correctly rounded (k +- 0.5)/s that numpy's grid
    and JAX compute.
    """
    dt = cdf.dtype
    s_f = torch.full((), s, dtype=dt, device=cdf.device)
    half = torch.full((), 0.5, dtype=dt, device=cdf.device)
    m = torch.clamp(torch.floor(cdf * s_f + half).to(torch.int64), 0, s)
    for _ in range(2):  # |rounded - true| <= 1; two steps each way
        u_below = (m.to(dt) - half) / s_f
        m = torch.where((m > 0) & (u_below > cdf), m - 1, m)
        u_at = (m.to(dt) + half) / s_f
        m = torch.where((m < s) & (u_at <= cdf), m + 1, m)
    return m


def grid_cell_by_table(cdf, s: int):
    """:func:`grid_cells_reference` without a division per value, as the
    kernel computes it: the boundaries u_k = (k + 0.5)/s, correctly
    rounded in the cdf's dtype, are a table of s entries made once, and
    each correction step looks up u_{m-1} = (m - 0.5)/s and u_m = (m +
    0.5)/s in it.  The same rounded guess and the same comparisons, so
    the same cells."""
    dt = cdf.dtype
    s_f = torch.full((), s, dtype=dt, device=cdf.device)
    table = (torch.arange(s, dtype=dt, device=cdf.device) + 0.5) / s_f
    m = torch.clamp(torch.floor(cdf * s_f + 0.5).to(torch.int64), 0, s)
    for _ in range(2):
        m = torch.where((m > 0) & (table[(m - 1).clamp(min=0)] > cdf), m - 1, m)
        m = torch.where((m < s) & (table[m.clamp(max=s - 1)] <= cdf), m + 1, m)
    return m


def grid_counts_reference(cdf, s: int):
    """Per-row counts g_k = #{i : cdf_i < (k + 0.5)/s} for every grid
    position k < s, clipped to valid sample indices: each CDF step is
    bucketed into its grid cell (:func:`grid_cells_reference`), a
    scatter-add histograms the buckets and a cumsum gives the counts."""
    m = grid_cells_reference(cdf, s)
    hist = torch.zeros((cdf.shape[0], s + 1), dtype=torch.int64, device=cdf.device)
    hist.scatter_add_(1, m, torch.ones_like(m))
    g = torch.cumsum(hist[:, :s], dim=1)
    # counts index SAMPLES (CDF steps): clip to the sample axis, which
    # differs from the grid size under base replication
    return torch.clamp(g, 0, cdf.shape[1] - 1)


def posterior_cdf_in_kernel_order(sample_log_likelihoods):
    """:func:`posterior_cdf_reference` with the kernel's additions in the
    kernel's order, in the input's dtype (on the card in float32: the
    kernel's CDF, bit for bit; ``exp`` is the card's own there).

    The row runs in tiles of ``TILE`` entries, zero weights past its end.
    In a tile, thread t (of 256) adds its 16 contiguous weights in order
    from 0; the thread totals go through a 5-step shift-and-add scan in
    each warp of 32 and a serial sum of the warp totals before the warp,
    from 0; the exclusive prefix is (warp offset) + (the previous lane's
    inclusive sum).  An entry is (carry + exclusive) + its thread's
    inclusive prefix, the carry the previous tile's last entry, and the
    divisor the row's last entry, so c_{S-1} = 1.  No finite entry: all
    weights 1.
    """
    sll = sample_log_likelihoods
    B, S = sll.shape
    dt, dev = sll.dtype, sll.device
    finite = torch.where(torch.isnan(sll), torch.full((), -math.inf, dtype=dt, device=dev), sll)
    mx = torch.amax(finite, dim=1, keepdim=True)
    rowmax = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    w = torch.where(mx == -math.inf, torch.ones_like(finite), torch.exp(finite - rowmax))
    n_tiles = -(-S // TILE)
    w = torch.nn.functional.pad(w, (0, n_tiles * TILE - S)).view(
        B, n_tiles, TILE_THREADS // WARP, WARP, PER_THREAD)
    local = torch.empty_like(w)
    acc = torch.zeros_like(w[..., 0])
    for v in range(PER_THREAD):
        acc = acc + w[..., v]
        local[..., v] = acc
    lane = torch.arange(WARP, device=dev)
    inc = acc
    d = 1
    while d < WARP:
        shifted = torch.nn.functional.pad(inc[..., :-d], (d, 0))
        inc = torch.where(lane >= d, shifted + inc, inc)
        d *= 2
    prev = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    warp_totals = inc[..., -1]
    off = torch.zeros_like(warp_totals)
    run = torch.zeros_like(warp_totals[..., 0])
    for k in range(warp_totals.shape[-1]):
        off[..., k] = run
        run = run + warp_totals[..., k]
    exclusive = off[..., None] + prev
    entries = torch.empty_like(local)
    carry = torch.zeros((B, 1, 1), dtype=dt, device=dev)
    for t in range(n_tiles):
        entries[:, t] = ((carry + exclusive[:, t])[..., None] + local[:, t])
        last = min(TILE, S - t * TILE) - 1
        carry = entries[:, t].reshape(B, TILE)[:, last, None, None]
    entries = entries.reshape(B, n_tiles * TILE)[:, :S]
    return entries / entries[:, -1:]


def inverse_cdf_grid_reference(sample_log_likelihoods, kvec, grid_size=None):
    """The plain version of :func:`inverse_cdf_grid`."""
    sll = sample_log_likelihoods
    if grid_size is None:
        grid_size = sll.shape[1]
    kvec = torch.as_tensor(kvec, dtype=torch.int64, device=sll.device)
    return grid_counts_reference(posterior_cdf_reference(sll), grid_size)[:, kvec]


def inverse_cdf_grid(sample_log_likelihoods, kvec, grid_size=None):
    """Search-free ``multi_dla.device_base_sample_inds`` for grid
    quantiles: per-row inverse CDF of the posterior at u_j = (kvec_j +
    0.5) / grid_size, int64 (B, len(kvec)).  ``kvec`` is the grid
    permutation, possibly composed with further permutations;
    ``grid_size`` (default: the sample count S) is the number of grid
    quantiles, smaller under base replication, while the returned indices
    run over the whole sample axis.  Equals ``searchsorted(cdf, (kvec +
    0.5) / grid_size, side='left')`` on the float64 grid bit for bit
    (:func:`grid_counts_reference`).

    CUDA tensors: ``csrc/redraw.cu``, float32 only; anything it cannot
    take (another dtype, a ``kvec`` that is not 1-D, S or grid_size at or
    above 2**23, a grid whose histogram exceeds shared memory, B above
    2**31 - 1) raises, as does a failed build or launch.  A ``kvec``
    entry outside [0, grid_size) stops the kernel, as an index outside a
    tensor does in PyTorch.  CPU tensors: :func:`inverse_cdf_grid_reference`.
    """
    sll = sample_log_likelihoods
    if not sll.is_cuda:
        return inverse_cdf_grid_reference(sll, kvec, grid_size)
    if grid_size is None:
        grid_size = sll.shape[1]
    kvec = torch.as_tensor(kvec, dtype=torch.int64, device=sll.device)
    if kvec.dim() != 1:
        raise ValueError(f"kvec must be 1-D, got {tuple(kvec.shape)}")
    _check(sll, grid_size, counts=True)
    B, S = sll.shape
    out = torch.empty((B, kvec.numel()), dtype=torch.int64, device=sll.device)
    if B and kvec.numel():
        _launch(sll, kvec.contiguous(), out, None, grid_size)
        global launch_count
        launch_count += 1
    return out


def posterior_cdf(sample_log_likelihoods):
    """The kernel's normalized posterior CDF (B, S) float32, on CUDA
    tensors; :func:`posterior_cdf_reference` on CPU tensors."""
    sll = sample_log_likelihoods
    if not sll.is_cuda:
        return posterior_cdf_reference(sll)
    _check(sll, sll.shape[1], counts=False)
    cdf = torch.empty(sll.shape, dtype=torch.float32, device=sll.device)
    if sll.shape[0]:
        _launch(sll, None, None, cdf, sll.shape[1])
        global cdf_launch_count
        cdf_launch_count += 1
    return cdf


@functools.lru_cache(maxsize=None)
def _kernel_library():
    from .. import _build

    return _bind_library(_build.load_library("redraw"))


def _bind_library(built):
    """Set the C entry points' argument and result types of a built
    ``csrc/redraw.cu`` library."""
    built.lib.gpdla_redraw_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    built.lib.gpdla_redraw_f32.restype = ctypes.c_int
    built.lib.gpdla_redraw_max_grid.argtypes = []
    built.lib.gpdla_redraw_max_grid.restype = ctypes.c_int
    built.lib.gpdla_redraw_error_string.argtypes = [ctypes.c_int]
    built.lib.gpdla_redraw_error_string.restype = ctypes.c_char_p
    return built


def max_grid_size(device) -> int:
    """The largest grid_size the kernel takes on ``device`` (builds it):
    the grid whose histogram of cells fits in a block's shared memory,
    58,015 on an H100 (232,448 bytes a block; above 29,007 the table of
    cell boundaries no longer fits beside it and the cells divide)."""
    return _max_grid(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _max_grid(index: int) -> int:
    with torch.cuda.device(index):
        return _kernel_library().lib.gpdla_redraw_max_grid()


def _check(sll, grid_size: int, counts: bool) -> None:
    """Raise on what the kernel cannot take."""
    if sll.dtype != torch.float32:
        raise ValueError(
            f"the CUDA redraw kernel is float32-only; got {sll.dtype}. "
            "Use the plain version (backend='torch') for float64."
        )
    if sll.dim() != 2:
        raise ValueError(f"sample_log_likelihoods must be (B, S), got {tuple(sll.shape)}")
    B, S = sll.shape
    if not 1 <= S < MAX_SAMPLES:
        raise ValueError(f"S = {S} outside the kernel's [1, 2**23)")
    if B > MAX_ROWS:
        raise ValueError(f"batch size {B} beyond the kernel's grid ({MAX_ROWS})")
    if counts:
        if not 1 <= grid_size < MAX_SAMPLES:
            raise ValueError(f"grid_size {grid_size} outside the kernel's [1, 2**23)")
        limit = max_grid_size(sll.device)
        if grid_size > limit:
            raise ValueError(
                f"grid_size {grid_size}: the kernel's histogram of grid cells holds at most "
                f"{limit} on {torch.cuda.get_device_name(sll.device)}"
            )


def _launch(sll, kvec, out, cdf, grid_size: int) -> None:
    B, S = sll.shape
    sll = sll.contiguous()
    built = _kernel_library()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(sll.device):
        stream = torch.cuda.current_stream(sll.device).cuda_stream
        err = built.lib.gpdla_redraw_f32(
            sll.data_ptr(), ptr(kvec), ptr(out), ptr(cdf), B, S, int(grid_size),
            0 if kvec is None else kvec.numel(), stream,
        )
    if err != 0:
        msg = built.lib.gpdla_redraw_error_string(err).decode()
        raise RuntimeError(f"redraw kernel launch failed: {msg} (cudaError {err})")
