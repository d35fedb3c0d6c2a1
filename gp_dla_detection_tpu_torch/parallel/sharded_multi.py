"""The fused lean two-stage {0,1,2}-DLA chain and the classic flow, on a
mesh.

Counterpart of ``gp_dla_detection_tpu/parallel/sharded_multi.py``.
``process_spectra_multi_lean`` is its ``_process_multi_lean_fused``, the
production catalog run.  Per super-batch (``batch_size`` rows per data
rank), each data rank runs on its device, on its rows:

1. the single-DLA sample evidences (``inference.batch_log_likelihoods``,
   columns in original sample order);
2. their evidence and MAP sample (``streaming.pack_lean``);
3. the inverse-CDF redraw of a second absorber from the 1-DLA posterior
   at the composed column permutation (``multi_dla.device_inverse_cdf_
   grid``: the kernel of ``ops/redraw.py`` under ``"cuda"``);
4. the gather of the drawn (z offset, N_HI) from one packed (S, 2) table;
5. the pair evidences (``multi_dla.batch_dla2_log_likelihoods``, on the
   z-sorted fresh axis under ``"cuda"``);
6. the pair evidence, MAP pair and MAP base index
   (``multi_dla.pack_lean_pair``);
7. optionally the CDDF inputs (``cddf_inputs.make_cddf_reducer``; its
   sums in the kernel of ``cddf_inputs.cddf_sums`` under ``"cuda"``).

Under ``"cuda"`` every kernel of the chain adds in an order fixed by the
row alone, so the results, the CDDF inputs included, do not depend on
the batch size or the run.

Only eight per-spectrum vectors (and the CDDF reductions) reach the
host; they are gathered along the data axis, so that every rank holds
the whole catalogue, which translates the pair indices back to original
sample numbering and forms the posteriors; the coordinator keeps one
checkpoint stream.  The (N, S) matrices never exist on the host, so the
results carry None for them.  The base columns depend on ``base_seed``,
R and S alone, never on the rank: the mesh changes no draw.

On a sample axis (``backend="torch"``, as the JAX package's XLA path
shards the whole chain) each sample rank evaluates a contiguous block of
the one-device column layout in both stages (every rank evaluates all
columns when they do not divide).  Each stage's rows are gathered along
the sample axis, which puts the blocks back in that layout, before
anything reads a whole row: the redraw and ``pack_lean`` after the
single stage, ``pack_lean_pair`` and the CDDF reducer after the pair
stage, whose argmax and top-k break ties by column position.  The base
columns are computed once on the whole axis, so every rank redraws the
one-device pairs.  Blocks of the layout, not z-sorted ones as the single
driver takes for the kernel's window: on the card a float32 sample's
plain-path evidence moves in its last bits when its column moves to
another position (z-sorted blocks), while halves of the layout give the
one-device values bit for bit (``tests/test_torch_cuda.py``).  The kernels run data-parallel only:
``"cuda"`` refuses a sample axis, as the JAX package's Pallas path does.

:func:`process_spectra_multi_sharded` is the driver the pipeline calls:
the lean chain, or the classic two-pass flow with the single stage's
checkpoints under ``<checkpoint_dir>/single`` and the pair stage's under
``<checkpoint_dir>/pair`` (:func:`process_spectra_multi` on the mesh:
rows over the data axis, z-sorted blocks of the pair columns over the
sample axis, the base draws resampled on the host).

Both flows run their batches through the drivers' one loop, as the
single driver does (``batches.run_batches``, ``pipeline_depth`` batches
in flight, the checkpoints on a background writer).  The chain's
``issue`` enqueues the whole chain of a batch with no host sync on a
data-only mesh: the draw pattern of R > 1 is checked once on the host,
not per launch; the index translations run in ``complete``.

Not ported: ``shard_map`` and the degradation ladders.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import torch

from ..params import Parameters, kms_to_z

from ..cddf_inputs import N_CHANNELS, CDDFInputs, CDDFReductionSpec, make_cddf_reducer
from ..inference import (
    _NUMPY_DTYPES,
    InferenceResults,
    PaddedSpectra,
    batch_log_likelihoods,
    dla_rate_priors,
    kernel_sample_window,
    kernel_span_ids,
    posteriors_from_evidence,
    process_spectra,
)
from ..models.qso_model import GPModel
from ..runtime import resolve_run
from ..utils import trace
from ..utils.observability import driver_call
from ..multi_dla import (
    MultiDLAResults,
    base_sample_perm,
    batch_dla2_log_likelihoods,
    device_inverse_cdf_grid,
    device_inverse_cdf_grid_reference,
    finalize_multi,
    finalize_multi_from_evidence,
    make_base_sample_inds,
    multi_dla_rate_priors,
    pack_lean_pair,
    packed_base_tables,
    replicate_draw_pattern,
)
from ..ops import evidence
from .batches import run_batches
from .mesh import SAMPLE_AXIS, Mesh, fetch_global, make_mesh, rank_device
from .overlap import check_depth
from .sharded_inference import (
    ShardedRunConfig,
    in_sample_order,
    process_spectra_sharded,
    run_fingerprint,
    sample_blocks,
)
from .streaming import pack_lean

__all__ = [
    "FUSED_LEAN_BASE_REPLICATES",
    "PATTERN_TILE",
    "lean_base_columns",
    "process_spectra_multi",
    "process_spectra_multi_lean",
    "process_spectra_multi_sharded",
]

# base_replicates=None resolves to this under backend="cuda": the JAX
# package's production default (survey-validated there), kept so that
# both packages draw the same pairs
FUSED_LEAN_BASE_REPLICATES = 4
# The pair-column tile the replicated draw pattern is laid out on: the
# JAX kernel's sample tile, so that R > 1 draws pair the same columns in
# both packages, and the pair kernel's pattern tile, across which it
# evaluates each distinct base draw once.
PATTERN_TILE = evidence.PATTERN_TILE

VEC_KEYS = (
    "log_likelihood_no_dla", "min_z_dla", "max_z_dla",
    "log_likelihood_dla", "map_sample_ind",
    "log_likelihood_dla2", "map_sample_ind2", "map_base_sample_ind",
)
CDDF_KEYS = ("cddf_hist", "cddf_ex")


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


@driver_call
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
    dtype: torch.dtype | None = None,
    device=None,
    backend: str | None = None,
    base_replicates: int | None = None,
    base_seed: int = 0,
    min_separation_kms: float = 3000.0,
    checkpoint_dir=None,
    progress: bool = False,
    store_cddf_inputs: bool = False,
    mesh: Mesh | None = None,
    pipeline_depth: int = 4,
) -> MultiDLAResults:
    """Lean (catalog-only) {0,1,2}-DLA selection: both stages per batch
    on each data rank's device (see the module docstring).

    ``backend``: ``"torch"`` (plain path, any dtype) or ``"cuda"`` (both
    kernel configurations; float32 on a CUDA device).  ``device``,
    ``dtype`` and ``backend`` default to the CUDA device, float32 and the
    kernels (``runtime.resolve_run``).
    ``base_replicates`` R: base draws shared by R columns of every
    256-column tile; None means 4 under ``"cuda"`` and 1 under
    ``"torch"``.  R > 1 under ``"torch"`` warns: it lays out the draws
    as the JAX package's XLA path does, on the unsorted axis.
    ``checkpoint_dir``: per-batch checkpoints of the eight vectors under
    ``<checkpoint_dir>/fused`` with a manifest and a fingerprint (R
    included when R != 1); a rerun resumes completed batches and ignores,
    with a warning, checkpoints of another run or of the JAX package.
    ``store_cddf_inputs``: also reduce the CDDF inputs in each batch
    (checkpointed with it); the results then carry ``cddf_inputs``.
    ``mesh``: default ``make_mesh()``; a sample axis under ``"torch"``
    only.  The results and checkpoints do not depend on the mesh.
    ``pipeline_depth``: the batches in flight (``ShardedRunConfig``);
    the results do not depend on it either.
    """
    check_depth(pipeline_depth)
    if mesh is None:
        mesh = make_mesh()
    device, dtype, backend = resolve_run(rank_device(device, mesh), dtype, backend)
    use_cuda = backend == "cuda"
    if use_cuda and mesh.shape[SAMPLE_AXIS] > 1:
        raise ValueError(
            "the fused lean two-stage driver runs its CUDA kernels "
            "data-parallel only (a sample axis would replicate the kernel "
            f"work across {mesh.shape[SAMPLE_AXIS]} ranks); use a data-only "
            "mesh with backend='cuda', or backend='torch', which shards "
            "the full chain on any mesh"
        )
    if params is None:
        params = Parameters()
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
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
    if store_cddf_inputs and S >= 1 << 24:
        raise ValueError(
            f"the CDDF reduction stores sample indices at the run dtype, "
            f"exact below 2**24 samples (got {S})"
        )
    n = len(spectra)
    min_sep_z = kms_to_z(min_separation_kms)
    prior_num = np.asarray(prior_num_dlas)
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_num >= 1, params
    )

    window = None
    if use_cuda:
        window = kernel_sample_window(offsets, spectra.wavelengths.shape[1], params)
    kernel_ids = kernel_span_ids(params, window)
    # the pair stage runs on the z-sorted fresh axis under "cuda" (the
    # kernel's window needs it); the single stage sorts and un-sorts
    # itself, so its columns stay in original order for the redraw
    cols, grid_size, order = lean_base_columns(offsets, base_seed, R, use_cuda)
    if use_cuda:
        # the pair kernel's shared base evaluation needs the base columns
        # to repeat in the R-layout; they repeat wherever the grid
        # positions do, so the host pattern is checked here, once, and
        # the launches skip the device check (a host sync per batch)
        t = torch.from_numpy(cols[None])
        evidence.check_base_layout(t, t, R)

    on_device = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    model_args = model.evidence_args(device, dtype)
    off_orig, nh_orig = on_device(offsets), on_device(nhis)
    off_pair = off_orig if order is None else on_device(offsets[order])
    nh_pair = nh_orig if order is None else on_device(nhis[order])
    # this sample rank's columns of both stages: a contiguous block of
    # the one-device layout ("torch": the samples in original order in
    # both stages), in tensors of their own
    n_sample = mesh.shape[SAMPLE_AXIS]
    block = None
    if n_sample > 1 and S % n_sample == 0:
        size = S // n_sample
        block = slice(mesh.sample_index * size, (mesh.sample_index + 1) * size)
        off_orig = off_pair = on_device(offsets[block])
        nh_orig = nh_pair = on_device(nhis[block])

    def whole_rows(t):
        """A stage's (B, block) columns gathered along the sample axis:
        in rank order, the one-device column layout."""
        if block is None:
            return t
        return on_device(fetch_global(t, mesh, SAMPLE_AXIS, dim=1))

    cols_dev = torch.as_tensor(cols, device=device)
    base_tables = on_device(packed_base_tables(offsets, nhis, _NUMPY_DTYPES[dtype]))

    cddf_spec = None
    if store_cddf_inputs:
        cddf_spec = CDDFReductionSpec()
        # the reduction's lnhi tables come from log10 of the linear N_HI
        # samples, as in the JAX package (within 1 ulp of the stored
        # log_nhi_samples the host statistics rebind against)
        cddf_reduce, cddf_consts = make_cddf_reducer(
            cddf_spec, offsets, np.log10(nhis), order=order, device=device,
            base_order=np.argsort(cols, kind="stable"), kernels=use_cuda,
        )
        log_p0m, log_p1m, log_p2m = multi_dla_rate_priors(
            spectra.z_qso, prior_z_qsos, prior_num, params
        )
        host_hist = np.empty(
            (n, N_CHANNELS, cddf_spec.n_z_window, cddf_spec.n_lnhi + 1),
            _NUMPY_DTYPES[dtype],
        )
        host_ex = np.empty((n, 5 * cddf_spec.top_k + 4), _NUMPY_DTYPES[dtype])

    # R > 1 draws on another grid: a distinct numerics configuration; a
    # CDDF run fingerprints the reduction spec (its grids determine the
    # stored hist, and other runs' checkpoints lack it)
    fingerprint = run_fingerprint(
        dtype, backend, params, model, offsets, nhis,
        extra=(
            [min_sep_z, float(base_seed), float(sample_chunk)]
            + ([float(R)] if R != 1 else []),
            spectra.z_qso,
        )
        + (
            (np.frombuffer(cddf_spec.token().encode(), np.uint8),)
            if store_cddf_inputs
            else ()
        ),
    )
    stored = VEC_KEYS + (CDDF_KEYS if store_cddf_inputs else ())
    host_vecs = {k: np.empty(n) for k in VEC_KEYS}

    def store(start: int, stop: int, payload: dict) -> None:
        for k in VEC_KEYS:
            host_vecs[k][start:stop] = payload[k]
        if store_cddf_inputs:
            host_hist[start:stop] = payload["cddf_hist"]
            host_ex[start:stop] = payload["cddf_ex"]

    def issue(uploaded):
        # both stages, the redraw and the reductions, enqueued; no host
        # sync on a data-only mesh.  On a sample axis ("torch") the rows'
        # gathers are collectives, so here in program order
        spec, priors = uploaded[:5], uploaded[5:]
        with trace("gpdla.stage.single", **kernel_ids):
            out1 = batch_log_likelihoods(
                *spec, *model_args, off_orig, nh_orig, params=params,
                sample_chunk=sample_chunk, backend=backend, sample_window=window,
            )
            sll = whole_rows(out1["sample_log_likelihoods_dla"])
            ev1, map1 = pack_lean(sll)
        with trace("gpdla.stage.redraw"):
            # the kernel under "cuda" (a row's draws depend on that row
            # alone), the plain version otherwise
            redraw = device_inverse_cdf_grid if use_cuda else device_inverse_cdf_grid_reference
            base_cols = redraw(sll, cols_dev, grid_size)
            vals = base_tables[base_cols]                    # (B, S, 2)
            if block is not None:
                vals = vals[:, block].contiguous()
        with trace("gpdla.stage.pair", **kernel_ids):
            lls2 = whole_rows(batch_dla2_log_likelihoods(
                *spec, *model_args, off_pair, nh_pair, vals[..., 0], vals[..., 1],
                params=params, min_sep_z=min_sep_z, backend=backend,
                sample_window=window, sample_chunk=sample_chunk,
                base_replicates=R if use_cuda else 1, check_layout=False,
            ))
            ev2, map2, map_base = pack_lean_pair(lls2, base_cols)
        cddf = ()
        if store_cddf_inputs:
            with trace("gpdla.stage.cddf"):
                cddf = cddf_reduce(
                    cddf_consts, sll, ev1, out1["log_likelihood_no_dla"],
                    out1["min_z_dla"], out1["max_z_dla"], *priors, lls2, ev2, base_cols,
                )
        small = (
            out1["log_likelihood_no_dla"], out1["min_z_dla"], out1["max_z_dla"],
            ev1, map1, ev2, map2, map_base,
        )
        # one copy of the vectors to the host, a row a spectrum; indices
        # are exact in float64
        return torch.stack([v.to(torch.float64) for v in small], dim=1), *cddf

    def complete(host):
        stacked, *cddf = host
        vecs = list(stacked.T)
        cddf = dict(zip(CDDF_KEYS, cddf))
        # -1 = no finite sample: the catalog's fallback is index 0; the
        # pair MAPs keep -1 as the no-valid-pair flag
        vecs[4] = np.maximum(vecs[4], 0.0)
        if order is not None:
            # the pair columns are the z-sorted axis: back to original
            # sample numbering (the base index already is)
            map2_i = vecs[6].astype(np.int64)
            vecs[6] = np.where(map2_i >= 0, order[np.maximum(map2_i, 0)], -1).astype(np.float64)
            if cddf:
                # so are the exact second-DLA pair indices (the base and
                # first-DLA indices already are original)
                K = cddf_spec.top_k
                ex = cddf["cddf_ex"] = np.array(cddf["cddf_ex"])
                pidx = ex[:, 3 * K : 4 * K].astype(np.int64)
                ex[:, 3 * K : 4 * K] = np.where(pidx >= 0, order[np.maximum(pidx, 0)], -1)
        return {**dict(zip(VEC_KEYS, vecs)), **cddf}

    run_batches(
        spectra, mesh, batch_size, device, dtype, issue=issue, complete=complete, store=store,
        depth=pipeline_depth, progress=progress,
        ckpt_dir=Path(checkpoint_dir) / "fused" if checkpoint_dir else None,
        manifest={"num_samples": S, "fingerprint": fingerprint, "base_seed": base_seed},
        keys=stored, what="fused two-stage",
        host_arrays=lambda own: [(own(a), dtype) for a in (
            log_p_no_dla, log_p_dla, log_p0m, log_p1m, log_p2m)] if store_cddf_inputs else (),
    )

    with trace("gpdla.call.finalize"):
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
        cddf_out = None
        if store_cddf_inputs:
            cddf_out = CDDFInputs(spec=cddf_spec, hist=host_hist, ex=host_ex, second=True)
            cddf_out.validate()
        # rows with no valid pair keep NaN evidence, as finalize_multi's
        # np.nanmax of an all-NaN row does
        return finalize_multi_from_evidence(
            single, host_vecs["log_likelihood_dla2"], spectra.z_qso,
            prior_z_qsos, prior_num, params,
            map_sample_inds2=host_vecs["map_sample_ind2"].astype(np.int64),
            map_base_sample_inds=host_vecs["map_base_sample_ind"].astype(np.int64),
            cddf_inputs=cddf_out,
        )


def process_spectra_multi_sharded(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters | None = None,
    mesh: Mesh | None = None,
    config: ShardedRunConfig | None = None,
    progress: bool = False,
    min_separation_kms: float = 3000.0,
    base_seed: int = 0,
    single: InferenceResults | None = None,
) -> MultiDLAResults:
    """{0,1,2}-DLA model selection on ``mesh`` (default ``make_mesh()``),
    the counterpart of the JAX driver of the same name.

    ``config.store_sample_likelihoods=False``: the fused lean chain
    (:func:`process_spectra_multi_lean`), with ``store_cddf_inputs``.
    Otherwise the classic two-pass flow: the single stage
    (``process_spectra_sharded``, checkpointed under
    ``<checkpoint_dir>/single``) or ``single`` reused, then
    :func:`process_spectra_multi` with its pair checkpoints under
    ``<checkpoint_dir>/pair``, its pair stage split over the mesh.
    """
    if params is None:
        params = Parameters()
    if config is None:
        config = ShardedRunConfig()
    if mesh is None:
        mesh = make_mesh()
    device, dtype, backend = resolve_run(
        rank_device(config.device, mesh), config.torch_dtype(), config.backend
    )
    ckpt_root = Path(config.checkpoint_dir) if config.checkpoint_dir else None

    if not config.store_sample_likelihoods:
        if single is not None:
            raise ValueError(
                "the fused lean two-stage driver recomputes the single "
                "stage on device per batch (the base resampler needs the "
                "sample matrix, which lean results never store) — drop "
                "`single`, or use store_sample_likelihoods=True to reuse "
                "a precomputed full single-stage result"
            )
        return process_spectra_multi_lean(
            model, offset_samples, nhi_samples, spectra, prior_z_qsos, prior_num_dlas,
            params=params, batch_size=config.per_device_batch,
            sample_chunk=config.sample_chunk, dtype=dtype, device=device,
            backend=backend, base_replicates=config.base_replicates,
            base_seed=base_seed, min_separation_kms=min_separation_kms,
            checkpoint_dir=ckpt_root, progress=progress,
            store_cddf_inputs=config.store_cddf_inputs, mesh=mesh,
            pipeline_depth=config.pipeline_depth,
        )
    if config.base_replicates not in (None, 1):
        raise ValueError(
            "base_replicates > 1 is a fused-lean-driver feature "
            "(store_sample_likelihoods=False): the classic pair stage "
            "resamples on the host and stores the full (N, S) base "
            "index matrix, where draw replication has no kernel payoff"
        )
    if config.store_cddf_inputs:
        raise ValueError(
            "store_cddf_inputs is a lean-mode feature: classic "
            "(store_sample_likelihoods=True) runs already carry the "
            "full matrices the CDDF statistics marginalize"
        )
    # fail at config time, not after an hours-long single stage
    if single is not None and single.sample_log_likelihoods_dla is None:
        raise ValueError(
            "two-stage {0,1,2}-DLA selection resamples the base absorber "
            "from the single-stage sample likelihoods, which a lean "
            "(catalog-only) run never stores — pass a non-lean "
            "precomputed `single`, or drop both `single` and "
            "store_sample_likelihoods to run the fused lean driver"
        )
    if single is None:
        single = process_spectra_sharded(
            model, offset_samples, nhi_samples, spectra,
            prior_z_qsos, np.asarray(prior_num_dlas) >= 1, params=params, mesh=mesh,
            config=dataclasses.replace(
                config, checkpoint_dir=str(ckpt_root / "single") if ckpt_root else None
            ),
            progress=progress,
        )
    return process_spectra_multi(
        model, offset_samples, nhi_samples, spectra, prior_z_qsos, prior_num_dlas,
        params=params, batch_size=config.per_device_batch,
        sample_chunk=config.sample_chunk, dtype=dtype, device=device,
        min_separation_kms=min_separation_kms, base_seed=base_seed, single=single,
        backend=backend,
        checkpoint_dir=ckpt_root / "pair" if ckpt_root else None, progress=progress,
        mesh=mesh, pipeline_depth=config.pipeline_depth,
    )


@driver_call
def process_spectra_multi(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters | None = None,
    batch_size: int = 16,
    sample_chunk: int = 1000,
    dtype: torch.dtype | None = None,
    device=None,
    min_separation_kms: float = 3000.0,
    base_seed: int = 0,
    single: InferenceResults | None = None,
    backend: str | None = None,
    checkpoint_dir=None,
    progress: bool = False,
    mesh: Mesh | None = None,
    pipeline_depth: int = 1,
) -> MultiDLAResults:
    """The classic flow: model selection over {no DLA, 1 DLA, 2 DLAs} on
    one device, or with its pair stage split over ``mesh``; the
    counterpart of the JAX package's ``multi_dla.process_spectra_multi``.

    Runs (or reuses, as ``single``) the single-DLA stage, draws the base
    absorbers on the host (``multi_dla.make_base_sample_inds``),
    evaluates the pairs batch by batch and combines the three evidences
    with the extended counting prior.  ``device``, ``dtype`` and
    ``backend`` default to the CUDA device, float32 and the kernel
    (``runtime.resolve_run``).  ``backend="cuda"`` (float32 on a CUDA
    device) sorts the fresh axis once, permutes the base columns the
    same way and un-sorts the result columns on the host.

    ``checkpoint_dir``: per-batch atomic checkpoints of the pair stage
    with a manifest and a numerics fingerprint; a rerun resumes the
    completed batches and ignores (with a warning) checkpoints of
    another run.

    ``mesh``: default ``make_mesh()``.  Each data rank evaluates its rows
    of a super-batch of ``batch_size`` x the data axis; on a sample axis
    each rank takes a contiguous block of the z-sorted pair columns, the
    base columns travelling with them.  The rows are gathered so that
    every rank holds the whole result; the coordinator checkpoints.
    Without ``single``, the single stage runs on one device.

    ``pipeline_depth``: the pair stage's batches in flight, as in the
    mesh drivers (``batches.run_batches``), which pass their config's;
    the default is the serial loop.  The results do not depend on it.
    """
    check_depth(pipeline_depth)
    if mesh is None:
        mesh = make_mesh()
    device, dtype, backend = resolve_run(rank_device(device, mesh), dtype, backend)
    if params is None:
        params = Parameters()
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    offsets = np.asarray(offset_samples)
    nhis = np.asarray(nhi_samples)
    S = len(offsets)
    n = len(spectra)

    if single is None:
        single = process_spectra(
            model, offsets, nhis, spectra,
            prior_z_qsos, np.asarray(prior_num_dlas) >= 1,
            params=params, batch_size=batch_size, sample_chunk=sample_chunk,
            dtype=dtype, device=device, backend=backend, progress=progress,
        )
    elif single.sample_log_likelihoods_dla is None:
        raise ValueError(
            "two-stage {0,1,2}-DLA selection resamples the base absorber "
            "from the single-stage sample likelihoods, which a lean run "
            "never stores: pass a full single-stage result, or use "
            "parallel.sharded_multi.process_spectra_multi_lean"
        )
    elif len(single.p_dlas) != n or single.sample_log_likelihoods_dla.shape[1] != S:
        raise ValueError(
            "precomputed single-DLA results do not match these spectra/"
            f"samples: {single.sample_log_likelihoods_dla.shape} vs ({n}, {S})"
        )

    base = make_base_sample_inds(single.sample_log_likelihoods_dla, seed=base_seed)
    min_sep_z = kms_to_z(min_separation_kms)

    window = None
    order = None
    if backend == "cuda":
        # z-sort the fresh axis; the base columns travel with their pairs
        order = np.argsort(offsets, kind="stable")
        window = kernel_sample_window(offsets, spectra.wavelengths.shape[1], params)
    kernel_ids = kernel_span_ids(params, window)
    # the pair columns this rank evaluates (original sample indices): a
    # z-sorted block on a sample axis, else all of them in the layout
    split = sample_blocks(offsets, mesh)
    block, columns = split if split is not None else (order, order)
    cols = np.arange(S) if block is None else block

    on_device = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    model_args = (
        *model.evidence_args(device, dtype), on_device(offsets[cols]), on_device(nhis[cols]),
    )

    # pair lls stored at the run dtype: (N, S) dominates host memory
    out2 = np.empty((n, S), _NUMPY_DTYPES[dtype])
    fingerprint = run_fingerprint(
        dtype, backend, params, model, offsets, nhis,
        extra=([min_sep_z, float(sample_chunk)], base, spectra.z_qso),
    )

    def store(start: int, stop: int, payload: dict) -> None:
        out2[start:stop] = payload["sample_log_likelihoods_dla2"]

    def base_draws(own):
        # per-batch gather: offsets[base] whole would be (N, S) per array
        bidx = own(base)[:, cols]
        return (offsets[bidx], dtype), (nhis[bidx], dtype)

    def issue(uploaded):
        # the pair evaluation, enqueued; on a sample axis the rows'
        # gather (a collective, so here in program order)
        with trace("gpdla.stage.pair", **kernel_ids):
            *spec, base_off, base_nhi = uploaded
            lls = batch_dla2_log_likelihoods(
                *spec, *model_args, base_off, base_nhi, params=params, min_sep_z=min_sep_z,
                backend=backend, sample_window=window, sample_chunk=sample_chunk,
            )
            if split is not None:
                lls = fetch_global(lls, mesh, SAMPLE_AXIS, dim=1)
        return (lls,)

    def complete(host):
        return {"sample_log_likelihoods_dla2": in_sample_order(host[0], columns)}

    run_batches(
        spectra, mesh, batch_size, device, dtype, issue=issue, complete=complete, store=store,
        depth=pipeline_depth, progress=progress,
        ckpt_dir=Path(checkpoint_dir) if checkpoint_dir else None,
        manifest={"num_samples": S, "base_seed": base_seed, "fingerprint": fingerprint},
        keys=("sample_log_likelihoods_dla2",), what="two-DLA", host_arrays=base_draws,
    )

    with trace("gpdla.call.finalize"):
        return finalize_multi(
            single, out2, base, spectra.z_qso, prior_z_qsos, prior_num_dlas,
            params,
        )
