"""Spectrum loading and preprocessing (read_spec.m + preload_qsos.m).

Counterpart of ``gp_dla_detection_tpu/spectra.py`` (host-side numpy; the
JAX module imports the JAX ``inference.PaddedSpectra``, which pulls in
jax).  It reads SDSS DR12 speclite coadd FITS files, normalizes and
truncates each spectrum, records filter reasons in the catalog's
bitfield, and packs the results as a ragged store (the npz artifact
format the JAX package writes and reads) and as the port's fixed-width
``PaddedSpectra``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gp_dla_detection_tpu.params import Parameters, emitted_wavelengths

from .inference import PaddedSpectra

__all__ = [
    "read_spec",
    "RaggedSpectra",
    "preload_qsos",
    "FILTER_Z_QSO",
    "FILTER_BAL",
    "FILTER_NORMALIZATION",
    "FILTER_MIN_PIXELS",
]

# filter_flags bits (0-indexed; build_catalogs.m:40-48, preload_qsos.m:36-48)
FILTER_Z_QSO = 0          # z_QSO < 2.15
FILTER_BAL = 1            # broad absorption line QSO
FILTER_NORMALIZATION = 2  # all normalization pixels masked
FILTER_MIN_PIXELS = 3     # fewer than min_num_pixels usable pixels

BRIGHTSKY_BIT = 23  # 0-indexed bit of AND_MASK (read_spec.m:8: MATLAB bit 24)


def read_spec(filename: str | Path):
    """Load one speclite coadd (read_spec.m:6-39).

    Returns (wavelengths [Å], flux, noise_variance, pixel_mask).
    noise_variance is inf where ivar == 0 (as in MATLAB 1/0);
    pixel_mask is True for pixels to ignore (ivar == 0 or BRIGHTSKY).
    """
    from gp_dla_detection_tpu.io.fits import read_bintable

    table = read_bintable(filename, hdu=1)
    flux = np.asarray(table["FLUX"], np.float64)
    log_wavelengths = np.asarray(table["LOGLAM"], np.float64)
    inverse_noise_variance = np.asarray(table["IVAR"], np.float64)
    and_mask = np.asarray(table["AND_MASK"], np.int64)

    wavelengths = 10.0**log_wavelengths
    with np.errstate(divide="ignore"):
        noise_variance = 1.0 / inverse_noise_variance
    pixel_mask = (inverse_noise_variance == 0) | (
        ((and_mask >> BRIGHTSKY_BIT) & 1) == 1
    )
    return wavelengths, flux, noise_variance, pixel_mask


@dataclass
class RaggedSpectra:
    """Preloaded spectra in a flat ragged layout (preloaded_qsos.mat
    equivalent: preload_qsos.m:73-79).

    Row i occupies values[offsets[i]:offsets[i+1]].  Quasars filtered
    out keep an empty row.  normalizers holds the median-flux
    normalization constant per quasar (0 when filtered).
    """

    offsets: np.ndarray          # (N+1,) int64
    wavelengths: np.ndarray      # (total,)
    flux: np.ndarray             # (total,)
    noise_variance: np.ndarray   # (total,)
    pixel_mask: np.ndarray       # (total,) bool
    normalizers: np.ndarray      # (N,)
    params_json: str = ""

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def row(self, i: int):
        s = slice(self.offsets[i], self.offsets[i + 1])
        return (
            self.wavelengths[s],
            self.flux[s],
            self.noise_variance[s],
            self.pixel_mask[s],
        )

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @classmethod
    def from_lists(cls, waves, fluxes, noises, masks, normalizers, params_json=""):
        offsets = np.zeros(len(waves) + 1, np.int64)
        offsets[1:] = np.cumsum([len(w) for w in waves])
        cat = lambda xs, dt: (
            np.concatenate([np.asarray(x, dt) for x in xs])
            if offsets[-1]
            else np.empty(0, dt)
        )
        return cls(
            offsets=offsets,
            wavelengths=cat(waves, np.float64),
            flux=cat(fluxes, np.float64),
            noise_variance=cat(noises, np.float64),
            pixel_mask=cat(masks, bool),
            normalizers=np.asarray(normalizers, np.float64),
            params_json=params_json,
        )

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        )

    @classmethod
    def load(cls, path: str | Path) -> "RaggedSpectra":
        with np.load(Path(path)) as f:
            return cls(**{k: (str(f[k]) if k == "params_json" else f[k]) for k in f.files})

    # ------------------------------------------------------------------
    def to_padded(
        self,
        indices=None,
        z_qsos=None,
        pixel_pad: int | None = None,
        pixel_spacing: float = 1e-4,
    ) -> PaddedSpectra:
        """Fixed-width padded batch for the inference engine.

        Padded tail pixels continue the uniform log10-lambda grid from
        the last real pixel (keeping wavelengths strictly increasing,
        which the Voigt convolution padding relies on) and are masked
        out.  ``z_qsos`` must align with ``indices``.
        """
        if z_qsos is None:
            # validate BEFORE building the (B, P) batch: at survey scale
            # the loop below fills ~6 GB before a late check would fire
            raise ValueError("z_qsos required to build a PaddedSpectra batch")
        if indices is None:
            indices = np.arange(len(self))
        indices = np.asarray(indices)
        lengths = self.lengths()[indices]
        max_len = int(lengths.max()) if len(lengths) else 0
        P = pixel_pad if pixel_pad is not None else max_len
        if max_len > P:
            raise ValueError(f"pixel_pad={P} < longest spectrum {max_len}")

        B = len(indices)
        wavelengths = np.empty((B, P))
        flux = np.zeros((B, P))
        noise = np.full((B, P), np.inf)
        mask = np.zeros((B, P), bool)
        for row, i in enumerate(indices):
            w, f, n, pm = self.row(int(i))
            L = len(w)
            if L == 0:
                # filtered-out quasar: synthesize a harmless grid
                wavelengths[row] = 3600.0 * 10 ** (
                    pixel_spacing * np.arange(P)
                )
                continue
            wavelengths[row, :L] = w
            flux[row, :L] = f
            noise[row, :L] = n
            mask[row, :L] = ~pm
            if L < P:
                wavelengths[row, L:] = w[-1] * 10 ** (
                    pixel_spacing * np.arange(1, P - L + 1)
                )
        return PaddedSpectra(
            wavelengths=wavelengths,
            flux=flux,
            noise_variance=np.where(mask, noise, 0.0),
            mask=mask,
            z_qso=np.asarray(z_qsos, np.float64),
        )


def preload_qsos(
    catalog,
    params: Parameters | None = None,
    file_loader=None,
    progress: bool = False,
    use_native: bool = True,
    max_pixels: int = 4800,
    release: str = "dr12q",
) -> RaggedSpectra:
    """Load, normalize, filter, and truncate all catalog spectra
    (preload_qsos.m:18-83).

    ``catalog`` is a :class:`gp_dla_detection_tpu.catalog.Catalog`;
    its ``filter_flags`` are updated in place with bits 2/3 exactly as
    the reference amends catalog.mat (preload_qsos.m:81-83).

    ``file_loader(plate, mjd, fiber_id) -> (wavelengths, flux,
    noise_variance, pixel_mask)`` defaults to reading
    ``spec-{plate}-{mjd}-{fiber:04d}.fits`` under the catalog release's
    spectra directory (README.md:102-108's closure).
    """
    if params is None:
        params = Parameters()

    native_loader = None
    if file_loader is None:
        # the same release knob pipeline.run_catalog writes file_list
        # under — a hardcoded "dr12q" here would read a different tree
        # than download_spectra populated
        base = params.spectra_directory(release)

        def spec_path(plate, mjd, fiber_id):
            # files land under a per-plate subdirectory, matching
            # catalog.file_list()'s rsync layout and the reference's
            # file_loader closure (README.md:102-108)
            return base / str(plate) / f"spec-{plate}-{mjd}-{fiber_id:04d}.fits"

        if use_native:
            from gp_dla_detection_tpu.io.native import native_available, read_spec_batch

            # read_spec_batch's own fallback, without the native library,
            # is the JAX package's read_spec, whose import reaches jax:
            # without the library, read through this module's read_spec
            use_native = native_available()
        if use_native:
            # bulk-parse the needed files in bounded chunks with the
            # multithreaded C++ loader (native/gpdla_io.cc), replacing
            # the reference's sequential 162k-file loop.  Chunking bounds
            # peak memory (~chunk * max_pixels * 8B * 3).

            todo = np.flatnonzero(np.asarray(catalog.filter_flags) == 0)
            paths = [
                spec_path(
                    catalog.plates[i], catalog.mjds[i], catalog.fiber_ids[i]
                )
                for i in todo
            ]
            row_of = {int(q): r for r, q in enumerate(todo)}
            chunk_size = 4096
            cache = {"lo": 0, "hi": 0, "data": None}

            def native_loader(i):
                r = row_of[i]
                if not (cache["lo"] <= r < cache["hi"]):
                    lo = (r // chunk_size) * chunk_size
                    hi = min(lo + chunk_size, len(paths))
                    cache["data"] = read_spec_batch(
                        paths[lo:hi], max_pixels=max_pixels
                    )
                    cache["lo"], cache["hi"] = lo, hi
                w_b, f_b, n_b, m_b, len_b = cache["data"]
                rr = r - cache["lo"]
                L = int(len_b[rr])
                if L < 0:
                    raise FileNotFoundError(paths[r])
                return w_b[rr, :L], f_b[rr, :L], n_b[rr, :L], m_b[rr, :L]

        else:

            def file_loader(plate, mjd, fiber_id):
                return read_spec(spec_path(plate, mjd, fiber_id))

    num_quasars = len(catalog.z_qsos)
    waves, fluxes, noises, masks = [], [], [], []
    normalizers = np.zeros(num_quasars)

    def append_empty():
        """Filtered-out quasar: an empty row in every ragged array."""
        waves.append(np.empty(0))
        fluxes.append(np.empty(0))
        noises.append(np.empty(0))
        masks.append(np.empty(0, bool))

    for i in range(num_quasars):
        if catalog.filter_flags[i] > 0:
            append_empty()
            continue

        if native_loader is not None:
            wavelengths, flux, noise_variance, pixel_mask = native_loader(i)
        else:
            wavelengths, flux, noise_variance, pixel_mask = file_loader(
                catalog.plates[i], catalog.mjds[i], catalog.fiber_ids[i]
            )
        rest = emitted_wavelengths(wavelengths, catalog.z_qsos[i])

        # normalize by median flux in the normalization range
        # (preload_qsos.m:29-33)
        norm_ind = (
            (rest >= params.normalization_min_lambda)
            & (rest <= params.normalization_max_lambda)
            & ~pixel_mask
        )
        this_median = (
            np.nanmedian(flux[norm_ind]) if norm_ind.any() else np.nan
        )

        if np.isnan(this_median):  # bit 2 (preload_qsos.m:36-39)
            catalog.filter_flags[i] |= 1 << FILTER_NORMALIZATION
            append_empty()
            continue

        usable = (
            (rest >= params.null_model.min_lambda)
            & (rest <= params.null_model.max_lambda)
            & ~pixel_mask
        )
        if usable.sum() < params.min_num_pixels:  # bit 3 (:41-49)
            catalog.filter_flags[i] |= 1 << FILTER_MIN_PIXELS
            append_empty()
            continue

        normalizers[i] = this_median
        flux = flux / this_median
        noise_variance = noise_variance / this_median**2

        # truncate to the loading range plus one extra unmasked pixel on
        # each side (preload_qsos.m:56-62)
        ind = (rest >= params.loading_min_lambda) & (
            rest <= params.loading_max_lambda
        )
        available = np.flatnonzero(~ind & ~pixel_mask)
        inside = np.flatnonzero(ind)
        if inside.size:
            after = available[available > inside[-1]]
            if after.size:
                ind[after.min()] = True
            before = available[available < inside[0]]
            if before.size:
                ind[before.max()] = True

        waves.append(wavelengths[ind])
        fluxes.append(flux[ind])
        noises.append(noise_variance[ind])
        masks.append(pixel_mask[ind])
        if progress:
            print(
                f"loaded quasar {i + 1} of {num_quasars} "
                f"({catalog.plates[i]}/{catalog.mjds[i]}/"
                f"{catalog.fiber_ids[i]:04d})",
                flush=True,
            )

    return RaggedSpectra.from_lists(
        waves, fluxes, noises, masks, normalizers, params.to_json()
    )
