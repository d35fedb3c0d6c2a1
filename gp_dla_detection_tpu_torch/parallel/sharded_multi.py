"""The fused lean two-stage {0,1,2}-DLA chain on one device.

Counterpart of ``gp_dla_detection_tpu/parallel/sharded_multi.py``'s
``_process_multi_lean_fused``, the production catalog run.  Per batch of
spectra, on the device:

1. the single-DLA sample evidences (``inference.batch_log_likelihoods``,
   columns in original sample order);
2. their evidence and MAP sample (``streaming.pack_lean``);
3. the inverse-CDF redraw of a second absorber from the 1-DLA posterior
   at the composed column permutation (``multi_dla.device_inverse_cdf_
   grid``);
4. the gather of the drawn (z offset, N_HI) from one packed (S, 2) table;
5. the pair evidences (``multi_dla.batch_dla2_log_likelihoods``, on the
   z-sorted fresh axis under ``"cuda"``);
6. the pair evidence, MAP pair and MAP base index
   (``multi_dla.pack_lean_pair``).

Only eight per-spectrum vectors reach the host, which translates the MAP
pair index back to original sample numbering, forms the posteriors and
keeps one checkpoint stream.  The (N, S) matrices never exist on the
host, so the results carry None for them.

Not ported: the mesh and ``shard_map``, the degradation ladders, the
threaded upload overlap and the CDDF-input reduction.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import torch

from gp_dla_detection_tpu.params import Parameters, kms_to_z
from gp_dla_detection_tpu.utils.atomic_io import atomic_savez, atomic_write_json

from ..inference import (
    _NUMPY_DTYPES,
    BACKENDS,
    InferenceResults,
    PaddedSpectra,
    batch_log_likelihoods,
    compute_sample_window,
    dla_rate_priors,
    posteriors_from_evidence,
)
from ..models.qso_model import GPModel
from ..multi_dla import (
    MultiDLAResults,
    base_sample_perm,
    batch_dla2_log_likelihoods,
    device_inverse_cdf_grid,
    finalize_multi_from_evidence,
    pack_lean_pair,
    packed_base_tables,
    replicate_draw_pattern,
)
from ..ops import evidence
from .sharded_inference import run_fingerprint
from .streaming import pack_lean

__all__ = [
    "FUSED_LEAN_BASE_REPLICATES",
    "PATTERN_TILE",
    "lean_base_columns",
    "process_spectra_multi_lean",
]

# base_replicates=None resolves to this under backend="cuda": the JAX
# package's production default (survey-validated there), kept so that
# both packages draw the same pairs
FUSED_LEAN_BASE_REPLICATES = 4
# The pair-column tile the replicated draw pattern is laid out on: the
# JAX kernel's sample tile, not this package's 64-sample CUDA block, so
# that R > 1 draws pair the same columns in both packages.
PATTERN_TILE = evidence.SAMPLE_TILE

VEC_KEYS = (
    "log_likelihood_no_dla", "min_z_dla", "max_z_dla",
    "log_likelihood_dla", "map_sample_ind",
    "log_likelihood_dla2", "map_sample_ind2", "map_base_sample_ind",
)


def lean_base_columns(offsets, base_seed: int, replicates: int, sorted_axis: bool):
    """The grid positions the base redraw reads, one per pair column.

    Pair column p takes the inverse CDF at u = (cols[p] + 0.5) / grid_size.
    ``sorted_axis``: the pair columns are the z-sorted fresh axis (the
    kernel path), so with R = 1 the grid permutation is composed with the
    sort, and index VALUES stay in original sample numbering.  With
    R > 1, column p takes draw slot replicate_draw_pattern(S, 256, R)[p]
    of the shuffled n_draws-point grid, bound to the columns in the order
    the pair stage sees them.

    Returns (cols int64 (S,), grid_size, order): ``order`` is the sort
    of the fresh axis (None when not ``sorted_axis``).
    """
    offsets = np.asarray(offsets)
    S = len(offsets)
    order = np.argsort(offsets, kind="stable") if sorted_axis else None
    if replicates == 1:
        perm = base_sample_perm(S, base_seed)
        cols, grid_size = (perm if order is None else perm[order]), S
    else:
        draw_idx, grid_size = replicate_draw_pattern(S, PATTERN_TILE, replicates)
        cols = base_sample_perm(grid_size, base_seed)[draw_idx]
    return cols.astype(np.int64), grid_size, order


def process_spectra_multi_lean(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters | None = None,
    batch_size: int = 16,
    sample_chunk: int = 1000,
    dtype: torch.dtype = torch.float64,
    device=None,
    backend: str = "torch",
    base_replicates: int | None = None,
    base_seed: int = 0,
    min_separation_kms: float = 3000.0,
    checkpoint_dir=None,
    progress: bool = False,
) -> MultiDLAResults:
    """Lean (catalog-only) {0,1,2}-DLA selection: both stages per batch
    on one device (see the module docstring).

    ``backend``: ``"torch"`` (plain path, any dtype) or ``"cuda"`` (both
    kernel configurations; float32 on a CUDA device).
    ``base_replicates`` R: base draws shared by R columns of every
    256-column tile; None means 4 under ``"cuda"`` and 1 under
    ``"torch"``.  R > 1 under ``"torch"`` warns: it lays out the draws
    as the JAX package's XLA path does, on the unsorted axis.
    ``checkpoint_dir``: per-batch checkpoints of the eight vectors under
    ``<checkpoint_dir>/fused`` with a manifest and a fingerprint (R
    included when R != 1); a rerun resumes completed batches and ignores,
    with a warning, checkpoints of another run or of the JAX package.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if params is None:
        params = Parameters()
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    device = torch.device(device) if device is not None else model.mu.device
    use_cuda = backend == "cuda"
    if use_cuda and (device.type != "cuda" or dtype != torch.float32):
        raise ValueError(
            f"backend='cuda' runs float32 on a CUDA device; got {dtype} on {device}"
        )
    R = base_replicates
    if R is None:
        R = FUSED_LEAN_BASE_REPLICATES if use_cuda else 1
    elif R not in (1, 2, 4, 8):
        raise ValueError(
            f"base_replicates must be 1, 2, 4, or 8 (got {R}): each base "
            "draw is shared by R lane blocks of a 256-column tile"
        )
    if R > 1 and not use_cuda:
        warnings.warn(
            f"base_replicates={R} under backend={backend!r}: the run pays "
            f"the {R}x-coarser base-draw stratification and an R-specific "
            "checkpoint fingerprint on the unsorted sample axis (the JAX "
            "package's XLA layout), with no kernel fast path to gain; use "
            "base_replicates=1 here",
            stacklevel=2,
        )

    offsets = np.asarray(offset_samples)
    nhis = np.asarray(nhi_samples)
    S = len(offsets)
    n = len(spectra)
    min_sep_z = kms_to_z(min_separation_kms)
    prior_num = np.asarray(prior_num_dlas)
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_num >= 1, params
    )

    window = None
    if use_cuda:
        window = compute_sample_window(
            offsets, evidence.SAMPLE_TILE,
            spectra.wavelengths.shape[1] + 2 * params.instrument.width,
            num_lines=params.num_lines,
            pixel_spacing=params.instrument.pixel_spacing,
        )
    # the pair stage runs on the z-sorted fresh axis under "cuda" (the
    # kernel's window needs it); the single stage sorts and un-sorts
    # itself, so its columns stay in original order for the redraw
    cols, grid_size, order = lean_base_columns(offsets, base_seed, R, use_cuda)

    on_device = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    model_args = (
        model.rest_wavelengths.to(device=device, dtype=dtype),
        model.mu.to(device=device, dtype=dtype),
        model.M.to(device=device, dtype=dtype),
        model.log_omega.to(device=device, dtype=dtype),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
    )
    off_orig, nh_orig = on_device(offsets), on_device(nhis)
    off_pair = off_orig if order is None else on_device(offsets[order])
    nh_pair = nh_orig if order is None else on_device(nhis[order])
    cols_dev = torch.as_tensor(cols, device=device)
    base_tables = on_device(packed_base_tables(offsets, nhis, _NUMPY_DTYPES[dtype]))

    ckpt_dir = Path(checkpoint_dir) / "fused" if checkpoint_dir else None
    manifest_path = ckpt_dir / "manifest.json" if ckpt_dir else None
    # R > 1 draws on another grid: a distinct numerics configuration
    fingerprint = run_fingerprint(
        dtype, backend, params, model, offsets, nhis,
        extra=(
            [min_sep_z, float(base_seed), float(sample_chunk)]
            + ([float(R)] if R != 1 else []),
            spectra.z_qso,
        ),
    )
    done: set = set()
    if manifest_path and manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        if (
            manifest.get("num_spectra") == n
            and manifest.get("batch_size") == batch_size
            and manifest.get("num_samples") == S
            and manifest.get("fingerprint") == fingerprint
        ):
            done = set(manifest["completed_batches"])
        else:
            warnings.warn(
                f"ignoring incompatible fused two-stage checkpoints in "
                f"{ckpt_dir} (run shape or numerics config changed)",
                stacklevel=2,
            )
    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    host_vecs = {k: np.empty(n) for k in VEC_KEYS}
    for bi, start in enumerate(range(0, n, batch_size)):
        stop = min(start + batch_size, n)
        ckpt_file = ckpt_dir / f"batch_{bi:06d}.npz" if ckpt_dir else None
        if bi in done and ckpt_file and ckpt_file.exists():
            with np.load(ckpt_file) as f:
                for k in VEC_KEYS:
                    host_vecs[k][start:stop] = f[k]
            continue
        batch = spectra.slice(slice(start, stop)).pad_to(batch_size)
        spec = (
            on_device(batch.wavelengths),
            on_device(batch.flux),
            on_device(batch.noise_variance),
            torch.as_tensor(np.asarray(batch.mask, bool), device=device),
            on_device(batch.z_qso),
        )
        out1 = batch_log_likelihoods(
            *spec, *model_args, off_orig, nh_orig, params=params,
            sample_chunk=sample_chunk, backend=backend, sample_window=window,
        )
        sll = out1["sample_log_likelihoods_dla"]
        ev1, map1 = pack_lean(sll)
        base_cols = device_inverse_cdf_grid(sll, cols_dev, grid_size)
        vals = base_tables[base_cols]                    # (B, S, 2)
        lls2 = batch_dla2_log_likelihoods(
            *spec, *model_args, off_pair, nh_pair, vals[..., 0], vals[..., 1],
            params=params, min_sep_z=min_sep_z, backend=backend,
            sample_window=window, sample_chunk=sample_chunk,
        )
        ev2, map2, map_base = pack_lean_pair(lls2, base_cols)
        small = (
            out1["log_likelihood_no_dla"], out1["min_z_dla"], out1["max_z_dla"],
            ev1, map1, ev2, map2, map_base,
        )
        # one device-to-host copy; indices are exact in float64
        vecs = list(torch.stack([v.to(torch.float64) for v in small]).cpu().numpy())
        keep = stop - start
        vecs = [v[:keep] for v in vecs]
        # -1 = no finite sample: the catalog's fallback is index 0; the
        # pair MAPs keep -1 as the no-valid-pair flag
        vecs[4] = np.maximum(vecs[4], 0.0)
        if order is not None:
            # the pair columns are the z-sorted axis: back to original
            # sample numbering (the base index already is)
            map2_i = vecs[6].astype(np.int64)
            vecs[6] = np.where(map2_i >= 0, order[np.maximum(map2_i, 0)], -1).astype(np.float64)
        for k, v in zip(VEC_KEYS, vecs):
            host_vecs[k][start:stop] = v
        if ckpt_file:
            atomic_savez(ckpt_file, compress=False, **dict(zip(VEC_KEYS, vecs)))
            done.add(bi)
            atomic_write_json(
                manifest_path,
                {
                    "num_spectra": n,
                    "batch_size": batch_size,
                    "num_samples": S,
                    "base_seed": base_seed,
                    "fingerprint": fingerprint,
                    "completed_batches": sorted(done),
                },
            )
        if progress:
            print(f"fused two-stage: {stop}/{n} spectra", flush=True)

    post = posteriors_from_evidence(
        log_p_no_dla, log_p_dla,
        host_vecs["log_likelihood_no_dla"], host_vecs["log_likelihood_dla"],
    )
    single = InferenceResults(
        min_z_dlas=host_vecs["min_z_dla"],
        max_z_dlas=host_vecs["max_z_dla"],
        log_priors_no_dla=log_p_no_dla,
        log_priors_dla=log_p_dla,
        log_likelihoods_no_dla=host_vecs["log_likelihood_no_dla"],
        log_likelihoods_dla=post["log_likelihoods_dla"],
        sample_log_likelihoods_dla=None,
        map_sample_inds=host_vecs["map_sample_ind"].astype(np.int64),
        log_posteriors_no_dla=post["log_posteriors_no_dla"],
        log_posteriors_dla=post["log_posteriors_dla"],
        model_posteriors=post["model_posteriors"],
        p_no_dlas=post["p_no_dlas"],
        p_dlas=post["p_dlas"],
    )
    # rows with no valid pair keep NaN evidence, as finalize_multi's
    # np.nanmax of an all-NaN row does
    return finalize_multi_from_evidence(
        single, host_vecs["log_likelihood_dla2"], spectra.z_qso,
        prior_z_qsos, prior_num, params,
        map_sample_inds2=host_vecs["map_sample_ind2"].astype(np.int64),
        map_base_sample_inds=host_vecs["map_base_sample_ind"].astype(np.int64),
    )
