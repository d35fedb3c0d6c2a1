"""Two-DLA model selection in PyTorch.

Counterpart of ``gp_dla_detection_tpu/multi_dla.py``: the {no DLA,
exactly 1, 2 DLAs} selection.  A two-DLA sample pairs QMC sample j (the
fresh axis, one absorber at theta_j) with a second absorber at
theta_{base[s, j]} drawn by deterministic inverse-CDF resampling of
spectrum s's 1-DLA posterior (the base axis).  Pairs closer than
``min_separation_kms`` are invalid (NaN log likelihood); the two
absorbers' optical depths add before one instrumental broadening; the
model prior extends the counting prior to multiplicity 2.

The host helpers (numpy) are copies of the JAX package's, held equal to
them by the tests; the device parts (the posterior CDF, the inverse-CDF
redraws, the pair reduction, the pair evaluator) are torch functions on
tensors.  The drivers that run them over many spectra are in
``parallel.sharded_multi``: the fused lean chain and the classic flow
(``process_spectra_multi``).  Two backends evaluate the pairs, as in ``inference``:
``"torch"`` (the plain path, any dtype) and ``"cuda"`` (the pair
configuration of the CUDA evidence kernel, float32 on CUDA tensors).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from .params import LYA_WAVELENGTH, LYMAN_LIMIT, Parameters
from .utils.atomic_io import atomic_savez

from .cddf_inputs import CDDFInputs
from .inference import InferenceResults, _prepare_spectrum
from .ops import evidence, redraw
from .runtime import resolve_backend

__all__ = [
    "MultiDLAResults",
    "base_sample_grid",
    "base_sample_perm",
    "batch_dla2_log_likelihoods",
    "device_base_sample_inds",
    "device_inverse_cdf_grid",
    "device_inverse_cdf_grid_reference",
    "finalize_multi",
    "finalize_multi_from_evidence",
    "make_base_sample_inds",
    "multi_dla_rate_priors",
    "pack_lean_pair",
    "packed_base_tables",
    "prior_dla_multiplicity",
    "replicate_draw_pattern",
]


# ---------------------------------------------------------------------------
# host helpers (numpy), copied from the JAX package
# ---------------------------------------------------------------------------


def prior_dla_multiplicity(
    prior_z_qsos, prior_dla_flags, prior_z_dlas
) -> np.ndarray:
    """Per-prior-sightline DLA count for the extended counting prior: a
    catalog DLA counts only if its Lyα line falls above the quasar's
    Lyman limit; a flagged sightline with no absorber redshifts (None or
    empty) counts as 1."""
    flags = np.asarray(prior_dla_flags, bool)
    num = np.zeros(len(flags), np.int64)
    for i in np.flatnonzero(flags):
        entry = prior_z_dlas[i]
        if entry is None:
            num[i] = 1
            continue
        z_dlas = np.atleast_1d(np.asarray(entry, dtype=float))
        if z_dlas.size == 0:
            num[i] = 1
        else:
            num[i] = int(
                np.sum(
                    LYA_WAVELENGTH * (1 + z_dlas)
                    >= LYMAN_LIMIT * (1 + prior_z_qsos[i])
                )
            )
    return num


def base_sample_perm(num_samples: int, seed: int = 0) -> np.ndarray:
    """The grid permutation underlying :func:`base_sample_grid`:
    u_j = (perm_j + 0.5) / S."""
    rng = np.random.default_rng(seed)
    return rng.permutation(num_samples)


def base_sample_grid(num_samples: int, seed: int = 0) -> np.ndarray:
    """The shuffled inverse-CDF grid points u_j = (perm(S)_j + 0.5) / S
    shared by the host and device resamplers; deterministic in
    (seed, S).  The shuffle decorrelates the base draw from the fresh
    axis."""
    return (base_sample_perm(num_samples, seed) + 0.5) / num_samples


def packed_base_tables(offset_samples, nhi_samples, dtype) -> np.ndarray:
    """(S, 2) packed (z_offset, N_HI) rows for the base-value gather."""
    return np.stack(
        [np.asarray(offset_samples), np.asarray(nhi_samples)], axis=1
    ).astype(dtype)


def replicate_draw_pattern(
    num_samples: int, tile: int, replicates: int
) -> tuple[np.ndarray, int]:
    """Draw-slot assignment for base-replicated pair sampling: with
    ``replicates`` R > 1, each tile of ``tile`` pair columns shares
    tile/R distinct base draws, lane l and lane l + tile/R carrying the
    same one.  Returns ``(draw_idx, n_draws)``: the draw slot of each
    pair column and the number of distinct slots."""
    if replicates < 1 or tile % replicates:
        raise ValueError(
            f"replicates must divide the sample tile (got {replicates} "
            f"vs tile {tile})"
        )
    pos = np.arange(num_samples)
    width = tile // replicates
    draw_idx = (pos // tile) * width + (pos % tile) % width
    return draw_idx.astype(np.int64), int(draw_idx.max()) + 1


def make_base_sample_inds(
    sample_log_likelihoods, seed: int = 0, row_chunk: int = 8192
) -> np.ndarray:
    """Per-spectrum second-absorber sample indices, (N, S): S draws from
    each spectrum's normalized 1-DLA posterior by inverse-CDF resampling
    at the shuffled grid points, in float64, in row chunks (rows are
    independent, so chunking is bit-identical).  Rows with no finite
    mass resample uniformly."""
    sll_all = np.asarray(sample_log_likelihoods)
    n, s = sll_all.shape
    u = base_sample_grid(s, seed)
    out = np.empty((n, s), np.int32)
    for c0 in range(0, n, row_chunk):
        sll = sll_all[c0 : c0 + row_chunk].astype(np.float64)
        m = sll.shape[0]
        # one flat searchsorted over all rows: offset row i's CDF by 2i;
        # a NaN row would break the flat array's order, hence the
        # uniform fallback for rows with no finite mass
        sll = np.where(np.isnan(sll), -np.inf, sll)
        rowmax = sll.max(axis=1, keepdims=True)
        rowmax = np.where(np.isfinite(rowmax), rowmax, 0.0)
        w = np.exp(sll - rowmax)
        w[w.sum(axis=1) == 0.0] = 1.0
        cdf = np.cumsum(w, axis=1)
        cdf /= cdf[:, -1:]
        offs = 2.0 * np.arange(m)[:, None]
        flat = np.searchsorted(
            (cdf + offs).ravel(), (u[None, :] + offs).ravel()
        )
        base = flat.reshape(m, s) - s * np.arange(m)[:, None]
        out[c0 : c0 + row_chunk] = np.clip(base, 0, s - 1)
    return out


def multi_dla_rate_priors(
    z_qsos, prior_z_qsos, prior_num_dlas, params: Parameters
):
    """Counting priors for >=1 and >=2 DLAs (extending
    process_qsos.m:122-132).  Returns (log_p_no_dla, log_p_one_dla,
    log_p_two_dla), each (B,); with no prior quasar below the cut the
    DLA models get zero weight."""
    prior_num = np.asarray(prior_num_dlas)
    order = np.argsort(prior_z_qsos, kind="stable")
    z_sorted = np.asarray(prior_z_qsos)[order]
    ge1 = np.concatenate([[0], np.cumsum((prior_num[order] >= 1).astype(np.int64))])
    ge2 = np.concatenate([[0], np.cumsum((prior_num[order] >= 2).astype(np.int64))])

    counts = np.searchsorted(
        z_sorted, np.asarray(z_qsos) + params.prior_z_qso_increase, side="left"
    )
    n1 = ge1[counts]
    n2 = ge2[counts]
    safe_counts = np.maximum(counts, 1)
    with np.errstate(divide="ignore"):
        log_p_two = np.log(n2) - np.log(safe_counts)
        log_p_one = np.log(n1 - n2) - np.log(safe_counts)
        log_p_none = np.log(counts - n1) - np.log(safe_counts)
    log_p_two = np.where(counts > 0, log_p_two, -np.inf)
    log_p_one = np.where(counts > 0, log_p_one, -np.inf)
    log_p_none = np.where(counts > 0, log_p_none, 0.0)
    return log_p_none, log_p_one, log_p_two


def _multi_posteriors(single, ll2, z_qsos, prior_z_qsos, prior_num_dlas,
                      params: Parameters):
    """Extended counting priors + normalized 3-model posteriors
    [no DLA, exactly 1, 2 DLAs] from the aggregated evidences."""
    log_p0, log_p1, log_p2 = multi_dla_rate_priors(
        z_qsos, prior_z_qsos, prior_num_dlas, params
    )
    posts = np.stack(
        [
            log_p0 + single.log_likelihoods_no_dla,
            log_p1 + single.log_likelihoods_dla,
            log_p2 + ll2,
        ],
        axis=1,
    )
    pmax = np.max(posts, axis=1, keepdims=True)
    model_posteriors = np.exp(posts - pmax)
    model_posteriors /= model_posteriors.sum(axis=1, keepdims=True)
    return log_p1, log_p2, model_posteriors


# ---------------------------------------------------------------------------
# device parts (torch)
# ---------------------------------------------------------------------------


# the redraw (ops/redraw.py) under the JAX package's names: the search-free
# inverse CDF at grid quantiles (the kernel on CUDA tensors), its plain
# version and the plain version's two steps
device_inverse_cdf_grid = redraw.inverse_cdf_grid
device_inverse_cdf_grid_reference = redraw.inverse_cdf_grid_reference
_posterior_cdf = redraw.posterior_cdf_reference
_grid_counts = redraw.grid_counts_reference


def device_base_sample_inds(sample_log_likelihoods, u):
    """:func:`make_base_sample_inds` on the device: per-row inverse CDF
    of the 1-DLA posterior at the grid points ``u`` (base_sample_grid),
    ``searchsorted(side='left')``, int64 (B, S).  The CDF accumulates in
    the input dtype, so in float32 a draw within rounding of a CDF step
    can land on a neighbouring sample; the draws are identically
    distributed."""
    sll = sample_log_likelihoods
    cdf = _posterior_cdf(sll)
    u = torch.as_tensor(u, dtype=sll.dtype, device=sll.device)
    inds = torch.searchsorted(cdf, u.expand(cdf.shape[0], -1).contiguous(), side="left")
    return torch.clamp(inds, 0, sll.shape[1] - 1)


def pack_lean_pair(pair_lls, base_inds):
    """Device reduction of a (B, S) pair matrix: the pair evidence
    max + log(mean(exp(x - max))) over VALID (finite) pairs only, the
    MAP pair column and the base index at that column.

    Rows with no valid pair give NaN evidence and -1 for both indices.
    Returns (evidence (B,), map_index (B,) int64, map_base_index (B,)
    int64).
    """
    valid = torch.isfinite(pair_lls)
    neg_inf = torch.full((), -math.inf, dtype=pair_lls.dtype, device=pair_lls.device)
    zero = torch.zeros((), dtype=pair_lls.dtype, device=pair_lls.device)
    # torch.amax/argmax propagate NaN: mask before reducing
    neg = torch.where(valid, pair_lls, neg_inf)
    rowmax = torch.amax(neg, dim=1)
    safe_max = torch.where(torch.isfinite(rowmax), rowmax, zero)
    count = valid.sum(dim=1)
    total = torch.where(valid, torch.exp(pair_lls - safe_max[:, None]), zero).sum(dim=1)
    has = count > 0
    evidence = torch.where(
        has,
        safe_max + torch.log(total / torch.clamp(count, min=1)),
        torch.full_like(safe_max, math.nan),
    )
    map_ind = torch.argmax(neg, dim=1)
    map_base = torch.gather(base_inds.to(torch.int64), 1, map_ind[:, None])[:, 0]
    minus_one = torch.full_like(map_ind, -1)
    return (
        evidence,
        torch.where(has, map_ind, minus_one),
        torch.where(has, map_base, minus_one),
    )


def batch_dla2_log_likelihoods(
    wavelengths,       # (B, P)
    flux,              # (B, P)
    noise_variance,    # (B, P)
    mask,              # (B, P) bool
    z_qso,             # (B,)
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    offset_samples,    # (S,) fresh axis, shared by the batch
    nhi_samples,       # (S,)
    base_offsets,      # (B, S) base axis, per spectrum
    base_nhis,         # (B, S)
    *,
    params: Parameters,
    min_sep_z: float,
    backend: str | None = None,
    sample_window: int | None = None,
    sample_chunk: int = 1000,
    base_replicates: int = 1,
    check_layout: bool = True,
):
    """Two-DLA pair log likelihoods for a batch of spectra, (B, S); NaN
    marks a pair closer than ``min_sep_z`` (in log(1+z)).

    ``backend="torch"``: the plain pair evidence on the full grid (any
    dtype), chunked by ``sample_chunk``.  ``backend="cuda"``: the
    kernel's pair configuration (float32, CUDA tensors), windowed on the
    fresh axis when ``sample_window`` is set, in which case
    ``offset_samples`` must be ascending (the caller sorts and permutes
    the base columns the same way).  The too-close mask is applied
    outside the kernel, in the run dtype, from the same redshifts the
    kernel sees.  ``backend`` None: the kernel on CUDA tensors, the plain
    version on CPU tensors.  ``base_replicates`` R (``"cuda"``): the base
    columns repeat with period 256/R in every 256-column tile, so the
    kernel evaluates each distinct draw once (checked, unless
    ``check_layout=False``; see ``ops.evidence.sample_log_likelihoods_pair``).
    """
    backend = resolve_backend(backend, flux.device, flux.dtype)
    dtype = flux.dtype
    prep = _prepare_spectrum(
        wavelengths, flux, noise_variance, mask, z_qso,
        model_grid, model_mu, model_M, model_log_omega,
        log_c_0, log_tau_0, log_beta, params, backend=backend, null_evidence=False,
    )
    min_z, max_z = prep["min_z_dla"], prep["max_z_dla"]
    rng_z = (max_z - min_z)[:, None]
    z_b = min_z[:, None] + rng_z * offset_samples.to(dtype)[None, :]
    z2_b = min_z[:, None] + rng_z * base_offsets.to(dtype)
    nhi_b = nhi_samples.to(dtype)[None, :].expand(z_b.shape)
    args = (
        prep["padded_wavelengths"], flux, prep["mu"], prep["M"],
        prep["omega2"], noise_variance, prep["valid"], z_b, nhi_b,
        z2_b, base_nhis.to(dtype),
    )
    if backend == "cuda":
        lls = evidence.sample_log_likelihoods_pair(
            *args[:8], nhi_b.contiguous(), *args[9:],
            num_lines=params.num_lines, instrument=params.instrument,
            window=sample_window, base_replicates=base_replicates,
            check_layout=check_layout,
        )
    else:
        lls = evidence.sample_log_likelihoods_pair_reference(
            *args, num_lines=params.num_lines, instrument=params.instrument,
            sample_chunk=sample_chunk,
        )
    # a 0-d CPU tensor: compared as a scalar, never copied to the card
    threshold = torch.log1p(torch.full((), min_sep_z, dtype=torch.float64)).to(dtype)
    too_close = torch.abs(torch.log1p(z_b) - torch.log1p(z2_b)) < threshold
    return torch.where(too_close, torch.full_like(lls, math.nan), lls)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiDLAResults:
    """Single + two-DLA model selection outputs, with the JAX package's
    fields and npz keys.

    Lean (catalog-only) runs carry None for both (N, S) matrices and
    hold the device-reduced MAP indices instead, and with
    ``store_cddf_inputs`` the device-reduced CDDF inputs.
    """

    single: InferenceResults
    # (N, S), NaN = invalid pair; None on lean runs
    sample_log_likelihoods_dla2: np.ndarray | None
    # (N, S) per-spectrum base indices; None on lean runs
    base_sample_inds: np.ndarray | None
    log_likelihoods_dla2: np.ndarray          # (N,)
    log_priors_one_dla: np.ndarray
    log_priors_two_dla: np.ndarray
    model_posteriors: np.ndarray              # (N, 3)
    # lean runs only: per-spectrum argmax over valid pairs and the base
    # sample index there, in ORIGINAL sample numbering; -1 = no valid pair
    map_sample_inds2: np.ndarray | None = None
    map_base_sample_inds: np.ndarray | None = None
    # device-reduced CDDF inputs (cddf_inputs.CDDFInputs) of a lean run
    # with store_cddf_inputs: the L7 statistics run from them
    # (analysis.lean_catalogue.LeanDLACatalogue) without the matrices
    cddf_inputs: CDDFInputs | None = None

    # the only keys save() may omit; any other missing key is a corrupt
    # or incompatible artifact
    _OPTIONAL_KEYS = (
        "sample_log_likelihoods_dla2",
        "base_sample_inds",
        "map_sample_inds2",
        "map_base_sample_inds",
    )
    _MULTI_KEYS = {
        "sample_log_likelihoods_dla2": "sample_log_likelihoods_dla2",
        "base_sample_inds": "base_sample_inds",
        "log_likelihoods_dla2": "log_likelihoods_dla2",
        "log_priors_one_dla": "log_priors_one_dla",
        "log_priors_two_dla": "log_priors_two_dla",
        "multi_model_posteriors": "model_posteriors",
        "map_sample_inds2": "map_sample_inds2",
        "map_base_sample_inds": "map_base_sample_inds",
    }

    def save(self, path: str | Path) -> None:
        payload = {
            f.name: getattr(self.single, f.name)
            for f in dataclasses.fields(type(self.single))
            if getattr(self.single, f.name) is not None
        }
        payload.update(
            {
                key: getattr(self, attr)
                for key, attr in self._MULTI_KEYS.items()
                if getattr(self, attr) is not None
            }
        )
        if self.cddf_inputs is not None:
            payload.update(self.cddf_inputs.to_npz_dict())
        # atomic and uncompressed, as the JAX package writes it
        atomic_savez(path, compress=False, **payload)

    @classmethod
    def load(cls, path: str | Path) -> "MultiDLAResults":
        with np.load(Path(path)) as f:
            missing = [
                key
                for key in cls._MULTI_KEYS
                if key not in f.files and key not in cls._OPTIONAL_KEYS
            ]
            if missing:
                raise ValueError(
                    f"{path} is not a two-DLA results artifact: missing {missing}"
                )
            single = InferenceResults(
                **{
                    k: f[k]
                    for k in f.files
                    if k not in cls._MULTI_KEYS and not k.startswith("cddf_")
                },
                **{
                    name: None
                    for name in InferenceResults._OPTIONAL_FIELDS
                    if name not in f.files
                },
            )
            return cls(
                single=single,
                cddf_inputs=(
                    CDDFInputs.from_npz_dict(f) if CDDFInputs.npz_present(f.files) else None
                ),
                **{
                    attr: (f[key] if key in f.files else None)
                    for key, attr in cls._MULTI_KEYS.items()
                },
            )


def finalize_multi_from_evidence(
    single, ll2, z_qsos, prior_z_qsos, prior_num_dlas,
    params: Parameters,
    map_sample_inds2=None,
    map_base_sample_inds=None,
    cddf_inputs=None,
) -> MultiDLAResults:
    """3-model posteriors from already-aggregated pair evidences (the
    lean runs, whose (N, S) matrices never reach the host)."""
    log_p1, log_p2, model_posteriors = _multi_posteriors(
        single, np.asarray(ll2, np.float64), z_qsos, prior_z_qsos,
        prior_num_dlas, params,
    )
    return MultiDLAResults(
        single=single,
        sample_log_likelihoods_dla2=None,
        base_sample_inds=None,
        log_likelihoods_dla2=np.asarray(ll2, np.float64),
        log_priors_one_dla=log_p1,
        log_priors_two_dla=log_p2,
        model_posteriors=model_posteriors,
        map_sample_inds2=map_sample_inds2,
        map_base_sample_inds=map_base_sample_inds,
        cddf_inputs=cddf_inputs,
    )


def finalize_multi(
    single, out2, base, z_qsos, prior_z_qsos, prior_num_dlas,
    params: Parameters,
) -> MultiDLAResults:
    """Pair-evidence aggregation (the mean over VALID pairs, in float64)
    + 3-model posteriors from the raw (N, S) pair log likelihoods."""
    with np.errstate(invalid="ignore"):
        max2 = np.nanmax(out2, axis=1).astype(np.float64)
        ll2 = max2 + np.log(
            np.nanmean(
                np.exp(out2 - max2[:, None], dtype=np.float64), axis=1
            )
        )

    log_p1, log_p2, model_posteriors = _multi_posteriors(
        single, ll2, z_qsos, prior_z_qsos, prior_num_dlas, params
    )
    return MultiDLAResults(
        single=single,
        sample_log_likelihoods_dla2=out2,
        base_sample_inds=base,
        log_likelihoods_dla2=ll2,
        log_priors_one_dla=log_p1,
        log_priors_two_dla=log_p2,
        model_posteriors=model_posteriors,
    )
