"""Per-sample DLA evidence: the CUDA kernel, its wrappers, its plain versions.

Counterpart of ``gp_dla_detection_tpu/ops/evidence_pallas.py`` in both
its configurations.  For a batch of spectra and, per spectrum, S QMC
samples, compute the (B, S) log likelihoods of the DLA model: Voigt
absorption -> instrumental convolution -> masked Woodbury log-density.
A sample is one absorber (z_DLA, N_HI), or, in the two-DLA pair
configuration, a pair of absorbers whose optical depths add.

- :func:`sample_log_likelihoods` / :func:`sample_log_likelihoods_pair`
  are the wrappers.  On CUDA tensors they launch ``csrc/evidence.cu``
  (float32 only) or raise; on CPU tensors they run the plain version.
  They never fall back on the card.
- :func:`sample_log_likelihoods_reference` /
  :func:`sample_log_likelihoods_pair_reference` are the plain PyTorch
  versions, any dtype, any device, looping over sample chunks so that no
  (S, P6) array is materialised whole.
- ``launch_count`` / ``pair_launch_count`` count the kernel launches
  made by each wrapper, and ``full_grid_launch_count`` /
  ``full_grid_pair_launch_count`` those of them made with ``window``
  None (the profile and its Gaussian core at every pixel of every line).
- :func:`check_base_layout` is the pair wrapper's check of the
  ``base_replicates`` layout it hands the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..params import InstrumentParams

from .faddeeva import _G_A, _SQRT_PI, _g_global_coeffs
from .low_rank_mvn import batched_dla_log_likelihoods
from .voigt import (
    WINDOW_MARGIN,
    _LineConstants,
    pair_absorption,
    voigt_absorption,
    voigt_absorption_windowed,
)

__all__ = [
    "SAMPLE_TILE",
    "KERNEL_TILE",
    "PATTERN_TILE",
    "check_base_layout",
    "full_grid_launch_count",
    "full_grid_pair_launch_count",
    "kernel_constants",
    "launch_count",
    "pair_launch_count",
    "sample_log_likelihoods",
    "sample_log_likelihoods_pair",
    "sample_log_likelihoods_pair_reference",
    "sample_log_likelihoods_reference",
    "supported_k",
]

# The chunk size windows are sized for (inference.compute_sample_window);
# any run of consecutive z-sorted samples no longer than this stays
# inside its window.
SAMPLE_TILE = 256
# Samples per CUDA block (csrc/evidence.cu TILE); <= SAMPLE_TILE.
KERNEL_TILE = 128
# The column tile of the pair configuration's replicated base draws
# (csrc/evidence.cu PATTERN): lanes l and l + PATTERN_TILE / R repeat.
PATTERN_TILE = 256
BASE_REPLICATES = (1, 2, 4, 8)
MAX_LINES = 31

launch_count = 0        # single-absorber kernel launches
pair_launch_count = 0   # two-DLA pair kernel launches
full_grid_launch_count = 0       # of launch_count, those with window None
full_grid_pair_launch_count = 0  # of pair_launch_count, those with window None


def kernel_constants(num_lines: int, instrument: InstrumentParams) -> dict:
    """The kernel's float32 constants, taken from the plain version's own
    float32 arithmetic (voigt._LineConstants on the CPU), so the kernel
    rounds every line constant exactly as the plain version does:

      line_table (3, num_lines): lambda_t [cm], y = gamma_t/(sqrt(2) sigma),
        lead_t * voigt_norm (the product rounded to float32)
      g: the 13 G-polynomial coefficients; taps: the instrument kernel;
      c, inv_sqrt2_sigma, wing_scale = 2/sqrt(pi), g_inv_a = 1/_G_A.
    """
    k = _LineConstants(torch.float32, "cpu")
    rows = [[], [], []]
    for j in range(num_lines):
        lambda_t, y, lead_j = k.line(j)
        rows[0].append(lambda_t)
        rows[1].append(y)
        rows[2].append(lead_j * k.voigt_norm)
    table = torch.stack([torch.stack(r) for r in rows]).numpy()
    f32 = lambda v: float(np.float32(v))
    return {
        "line_table": np.ascontiguousarray(table, dtype=np.float32),
        "g": np.asarray(_g_global_coeffs(), np.float32),
        "taps": np.asarray(instrument.profile(), np.float32),
        "c": float(k.c),
        "inv_sqrt2_sigma": float(k.inv_sqrt2_sigma),
        "wing_scale": f32(2.0 / _SQRT_PI),
        "g_inv_a": f32(1.0 / _G_A),
    }


def _check_grid(ext_wavelengths, flux, instrument: InstrumentParams) -> None:
    if ext_wavelengths.shape[-1] != flux.shape[-1] + 2 * instrument.width:
        # a padding/width disagreement would evaluate absorption a few
        # pixels off its wavelength without failing any bounds check
        raise ValueError(
            f"ext_wavelengths has {ext_wavelengths.shape[-1]} px but flux "
            f"has {flux.shape[-1]}; expected exactly 2*width="
            f"{2 * instrument.width} convolution-padding pixels"
        )


def _neutralize_masked(mask, *arrays):
    """Zero masked pixels BEFORE anything multiplies by the mask: NaN flux
    at ivar == 0, inf noise variance or an overflowed omega2 on masked
    padding would otherwise give NaN * 0 and log(inf) * 0 = NaN."""
    zero = torch.zeros((), dtype=arrays[0].dtype, device=arrays[0].device)
    return [torch.where(mask, a, zero) for a in arrays]


def sample_log_likelihoods_reference(
    ext_wavelengths,   # (B, P + 2*width)
    flux,              # (B, P)
    mu,                # (B, P)
    M,                 # (B, P, k)
    omega2,            # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_dlas,            # (B, S)
    nhi,               # (B, S)
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int | None = None,
    sample_chunk: int = KERNEL_TILE,
    absorption_index=None,
):
    """The plain PyTorch version of the evidence kernel, (B, S).

    ``window`` set: windowed fast Voigt (float32 only; z ascending along
    the sample axis); the windows are placed per chunk of
    ``sample_chunk`` samples, which must not exceed SAMPLE_TILE (the
    default KERNEL_TILE places them exactly as the kernel does).
    ``window`` None: full-grid Voigt, the fast path in float32 and the
    accurate one in float64.

    ``absorption_index`` (B, P): optional per-pixel gather of each
    profile (the reference's misaligned-absorption quirk,
    inference.spectrum_log_likelihoods).
    """
    if instrument is None:
        instrument = InstrumentParams()

    def absorb(c0, c1):
        z_c, n_c = z_dlas[..., c0:c1], nhi[..., c0:c1]
        if window is not None:
            absorption = voigt_absorption_windowed(
                ext_wavelengths, z_c, n_c, num_lines=num_lines,
                instrument=instrument, window=window,
            )
        else:
            absorption = voigt_absorption(
                ext_wavelengths, z_c, n_c, num_lines=num_lines,
                instrument=instrument,
            )
        if absorption_index is not None:
            absorption = torch.gather(
                absorption, -1,
                absorption_index[..., None, :].expand(absorption.shape),
            )
        return absorption

    return _plain_evidence(
        ext_wavelengths, flux, mu, M, omega2, noise_variance, mask,
        z_dlas.shape[-1], absorb, instrument, window, sample_chunk,
    )


def sample_log_likelihoods_pair_reference(
    ext_wavelengths,   # (B, P + 2*width)
    flux,              # (B, P)
    mu,                # (B, P)
    M,                 # (B, P, k)
    omega2,            # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_dlas,            # (B, S) first absorber (the fresh QMC axis)
    nhi,               # (B, S)
    z_dlas2,           # (B, S) second absorber (the resampled base axis)
    nhi2,              # (B, S)
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int | None = None,
    sample_chunk: int = KERNEL_TILE,
):
    """The plain PyTorch version of the pair kernel, (B, S): sample s is
    the pair (z_dlas[:, s], nhi[:, s]) + (z_dlas2[:, s], nhi2[:, s]),
    whose optical depths add before one exp (ops/voigt.pair_absorption).

    ``window`` applies to the first axis only, exactly as in
    :func:`sample_log_likelihoods_reference` (z_dlas ascending, float32);
    the second axis always takes the full grid.
    """
    if instrument is None:
        instrument = InstrumentParams()

    def absorb(c0, c1):
        return pair_absorption(
            ext_wavelengths, z_dlas[..., c0:c1], nhi[..., c0:c1],
            z_dlas2[..., c0:c1], nhi2[..., c0:c1], num_lines=num_lines,
            instrument=instrument, window=window,
        )

    return _plain_evidence(
        ext_wavelengths, flux, mu, M, omega2, noise_variance, mask,
        z_dlas.shape[-1], absorb, instrument, window, sample_chunk,
    )


def _plain_evidence(
    ext_wavelengths, flux, mu, M, omega2, noise_variance, mask, S, absorb,
    instrument, window, sample_chunk,
):
    """The chunk loop shared by the plain versions: ``absorb(c0, c1)``
    gives the (B, c1 - c0, P) broadened absorption of samples c0:c1."""
    _check_grid(ext_wavelengths, flux, instrument)
    if window is not None and sample_chunk > SAMPLE_TILE:
        raise ValueError(
            f"windowed chunks of {sample_chunk} samples exceed the "
            f"{SAMPLE_TILE}-sample span the window is sized for"
        )
    mask = mask.to(torch.bool)
    flux, noise_variance, mu, omega2 = _neutralize_masked(
        mask, flux, noise_variance, mu, omega2
    )
    out = []
    for c0 in range(0, S, sample_chunk):
        out.append(
            batched_dla_log_likelihoods(
                flux, mu, M, omega2, noise_variance, mask,
                absorb(c0, min(c0 + sample_chunk, S)),
            )
        )
    return torch.cat(out, dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_library():
    from .. import _build

    return _bind_library(_build.load_library("evidence"))


def _bind_library(built):
    """Declare the C entry points of a built ``csrc/evidence.cu`` library
    to ctypes; returns ``built``."""
    for fn, n_arrays, n_tail_ints in (
        (built.lib.gpdla_evidence_single_f32, 12, 1),
        (built.lib.gpdla_evidence_pair_f32, 14, 2),
    ):
        fn.argtypes = (
            [ctypes.c_void_p] * n_arrays
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3
            + [ctypes.c_float] * 5
            + [ctypes.c_int] * n_tail_ints
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    built.lib.gpdla_error_string.argtypes = [ctypes.c_int]
    built.lib.gpdla_error_string.restype = ctypes.c_char_p
    built.lib.gpdla_evidence_supported_k.argtypes = []
    built.lib.gpdla_evidence_supported_k.restype = ctypes.POINTER(ctypes.c_int)
    built.lib.gpdla_evidence_table_bytes.argtypes = [ctypes.c_int] * 3
    built.lib.gpdla_evidence_table_bytes.restype = ctypes.c_size_t
    return built


@functools.lru_cache(maxsize=None)
def supported_k() -> tuple[int, ...]:
    """The ranks k the CUDA kernel is compiled for (builds it)."""
    ptr = _kernel_library().lib.gpdla_evidence_supported_k()
    ks = []
    while ptr[len(ks)]:
        ks.append(ptr[len(ks)])
    return tuple(ks)


def sample_log_likelihoods(
    ext_wavelengths,   # (B, P + 2*width)
    flux,              # (B, P)
    mu,                # (B, P)
    M,                 # (B, P, k)
    omega2,            # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_dlas,            # (B, S)
    nhi,               # (B, S)
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int | None = None,
):
    """Per-sample DLA log likelihoods, (B, S).

    CUDA tensors: the hand-written kernel, float32 only; anything it
    cannot take (another dtype, a CPU tensor among CUDA ones, a rank k
    it is not compiled for, > 31 lines) raises, as does a failed build
    or launch.  CPU tensors: :func:`sample_log_likelihoods_reference`.

    With ``window`` set, z_dlas must be ascending along the sample axis
    and ``window`` must bound the line-center spread of any SAMPLE_TILE
    consecutive samples plus 2*WINDOW_MARGIN
    (inference.compute_sample_window).
    """
    if instrument is None:
        instrument = InstrumentParams()
    if not flux.is_cuda:
        return sample_log_likelihoods_reference(
            ext_wavelengths, flux, mu, M, omega2, noise_variance, mask,
            z_dlas, nhi, num_lines=num_lines, instrument=instrument,
            window=window,
        )
    out = _launch(
        "gpdla_evidence_single_f32", ext_wavelengths, flux, mu, M, omega2,
        noise_variance, mask, (z_dlas, nhi), num_lines, instrument, window,
    )
    global launch_count, full_grid_launch_count
    launch_count += 1
    full_grid_launch_count += int(window is None)
    return out


def sample_log_likelihoods_pair(
    ext_wavelengths,   # (B, P + 2*width)
    flux,              # (B, P)
    mu,                # (B, P)
    M,                 # (B, P, k)
    omega2,            # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_dlas,            # (B, S) first absorber (the fresh QMC axis)
    nhi,               # (B, S)
    z_dlas2,           # (B, S) second absorber (the resampled base axis)
    nhi2,              # (B, S)
    num_lines: int = 3,
    instrument: InstrumentParams | None = None,
    window: int | None = None,
    base_replicates: int = 1,
    check_layout: bool = True,
):
    """Two-DLA pair log likelihoods, (B, S): sample s is the absorber
    pair (z_dlas, nhi)[:, s] + (z_dlas2, nhi2)[:, s].

    CUDA tensors: the kernel's pair configuration, float32 only, with
    the same refusals as :func:`sample_log_likelihoods`.  CPU tensors:
    :func:`sample_log_likelihoods_pair_reference`.  ``window`` applies
    to the first axis (z_dlas ascending); the second axis is evaluated
    on the full grid, in any order.  ``base_replicates`` R: the second
    axis repeats at lanes l and l + 256/R of every full 256-column tile
    (checked, :func:`check_base_layout`), and the kernel evaluates it
    once per distinct draw; the output does not depend on R.  The check
    reads the device tensors back (a host sync): ``check_layout=False``
    skips it for a caller that checked, on the host, the pattern its
    base columns follow (the fused lean chain, once per run).
    """
    if instrument is None:
        instrument = InstrumentParams()
    _check_replicates(base_replicates)
    if check_layout:
        check_base_layout(z_dlas2, nhi2, base_replicates)
    if not flux.is_cuda:
        return sample_log_likelihoods_pair_reference(
            ext_wavelengths, flux, mu, M, omega2, noise_variance, mask,
            z_dlas, nhi, z_dlas2, nhi2, num_lines=num_lines,
            instrument=instrument, window=window,
        )
    out = _launch(
        "gpdla_evidence_pair_f32", ext_wavelengths, flux, mu, M, omega2,
        noise_variance, mask, (z_dlas, nhi, z_dlas2, nhi2), num_lines,
        instrument, window, base_replicates,
    )
    global pair_launch_count, full_grid_pair_launch_count
    pair_launch_count += 1
    full_grid_pair_launch_count += int(window is None)
    return out


def _check_replicates(base_replicates: int) -> None:
    """Raise unless ``base_replicates`` is one the pair kernel takes."""
    if base_replicates not in BASE_REPLICATES:
        raise ValueError(
            f"base_replicates must be one of {BASE_REPLICATES}, got {base_replicates}"
        )


def check_base_layout(z_dlas2, nhi2, base_replicates: int) -> None:
    """Raise unless the second axis (B, S) repeats with period
    PATTERN_TILE / R inside every full PATTERN_TILE-column tile, the
    layout the pair kernel's shared base evaluation relies on
    (``parallel.sharded_multi.lean_base_columns``)."""
    R = base_replicates
    _check_replicates(R)
    if R == 1:
        return
    full = z_dlas2.shape[-1] // PATTERN_TILE * PATTERN_TILE
    for t in (z_dlas2, nhi2):
        tiles = t[..., :full].reshape(*t.shape[:-1], -1, R, PATTERN_TILE // R)
        if not bool((tiles == tiles[..., :1, :]).all()):
            raise ValueError(
                f"the second absorber does not repeat at lanes l and l + "
                f"{PATTERN_TILE // R} of every {PATTERN_TILE}-column tile, "
                f"as base_replicates={R} requires"
            )


def _launch(
    entry, ext_wavelengths, flux, mu, M, omega2, noise_variance, mask,
    samples, num_lines, instrument, window, base_replicates=None,
):
    """Validate the inputs, launch the C entry point ``entry`` on the
    current stream and return its (B, S) output; raises on anything the
    kernel cannot take and on a failed build or launch."""
    _check_grid(ext_wavelengths, flux, instrument)
    floats = (ext_wavelengths, flux, mu, M, omega2, noise_variance, *samples)
    for t in (*floats, mask):
        if t.device != flux.device:
            raise ValueError(
                f"all inputs must be on {flux.device}; got one on {t.device}"
            )
    for t in floats:
        if t.dtype != torch.float32:
            raise ValueError(
                f"the CUDA evidence kernel is float32-only; got {t.dtype}. "
                "Use the plain version (backend='torch') for float64."
            )
    B, P = flux.shape
    P6 = ext_wavelengths.shape[-1]
    k = M.shape[-1]
    S = samples[0].shape[-1]
    if ext_wavelengths.shape != (B, P6) or M.shape != (B, P, k):
        raise ValueError("ext_wavelengths must be (B, P6) and M (B, P, k)")
    for t in (mu, omega2, noise_variance, mask):
        if t.shape != (B, P):
            raise ValueError(f"per-pixel inputs must be {(B, P)}, got {tuple(t.shape)}")
    for t in samples:
        if t.shape != (B, S):
            raise ValueError(f"per-sample inputs must all be {(B, S)}, got {tuple(t.shape)}")
    if not 1 <= num_lines <= MAX_LINES:
        raise ValueError(f"num_lines must be in [1, {MAX_LINES}], got {num_lines}")
    if k not in supported_k():
        raise ValueError(
            f"the CUDA evidence kernel is compiled for k in {supported_k()}, got {k}"
        )
    if not 1 <= B <= 65535:
        raise ValueError(f"batch size {B} outside the kernel's grid [1, 65535]")
    if S == 0:
        return torch.empty((B, 0), dtype=torch.float32, device=flux.device)

    mask = mask.to(torch.bool)
    flux, noise_variance, mu, omega2 = _neutralize_masked(
        mask, flux, noise_variance, mu, omega2
    )
    maskf = mask.to(torch.float32)
    n_eff = maskf.sum(dim=-1)
    contiguous = [
        t.contiguous()
        for t in (ext_wavelengths, flux, mu, omega2, noise_variance, maskf, M,
                  *samples, n_eff)
    ]
    out = torch.empty((B, S), dtype=torch.float32, device=flux.device)
    built = _kernel_library()
    # the kernel's per-spectrum coefficient tables, written by its
    # prologue on the same stream (so the caching allocator may hand the
    # block on once the stream has passed the launch)
    table = torch.empty(
        built.lib.gpdla_evidence_table_bytes(B, P, k), dtype=torch.uint8, device=flux.device
    )

    cst = kernel_constants(num_lines, instrument)
    with torch.cuda.device(flux.device):
        stream = torch.cuda.current_stream(flux.device).cuda_stream
        err = getattr(built.lib, entry)(
            *[t.data_ptr() for t in contiguous], out.data_ptr(), table.data_ptr(),
            B, P, P6, k, S, num_lines, 0 if window is None else int(window),
            cst["line_table"].ctypes.data, cst["g"].ctypes.data,
            cst["taps"].ctypes.data, cst["c"], cst["inv_sqrt2_sigma"],
            cst["wing_scale"], cst["g_inv_a"], float(instrument.pixel_spacing),
            WINDOW_MARGIN, *(() if base_replicates is None else (base_replicates,)), stream,
        )
    if err != 0:
        msg = built.lib.gpdla_error_string(err).decode()
        raise RuntimeError(f"evidence kernel launch failed: {msg} (cudaError {err})")
    return out
