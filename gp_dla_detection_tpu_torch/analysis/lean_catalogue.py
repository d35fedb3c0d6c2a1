"""CDDF statistics from device-reduced lean inputs.

Counterpart of ``gp_dla_detection_tpu/analysis/lean_catalogue.py``:
:class:`LeanDLACatalogue` is the JAX package's (jax-free)
``analysis.cddf.DLACatalogue`` for lean (catalog-only) runs that stored
the port's :class:`~..cddf_inputs.CDDFInputs` instead of the (N, S)
sample-likelihood matrices: the binned small-probability masses feed
the Poisson tails, the exact top-k entries (rebound to float64 sample
parameters on the host) feed the Poisson-binomial exact lists, and the
per-sample-weighted moment histograms feed the direct Omega_DLA
estimator — bin-for-bin the same statistics as the classic path
(calc_cddf.py:440-464, 490-507, 521-560) under the quantization contract
of ``gp_dla_detection_tpu/cddf_inputs.py``.

:func:`catalogue_from_run` is ``DLACatalogue.from_run`` for the port's
stage artifacts: it builds the lean catalogue itself and leaves the
classic branch to ``DLACatalogue.from_run``.

Unsupported on lean inputs (each raises with the classic alternative):
``lowzcut`` and noisy-pixel excision (both cut samples at continuous
redshifts), statistics bins not aligned with the reduction grids, and
the per-spectrum posterior-shape diagnostics (find_delta_*).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gp_dla_detection_tpu.analysis.cddf import DLACatalogue
from gp_dla_detection_tpu.analysis.cosmology import OMEGA_M_WMAP9, AbsorptionPath

from ..cddf_inputs import (
    CH_P,
    CH_P_NU,
    CH_P_VAR,
    CH_P_VAR_NU2,
    CH_SMALL2_A,
    CH_SMALL2_B,
    CH_SMALL_A,
    CH_SMALL_B,
    EX_W0,
    CDDFInputs,
)

__all__ = ["LeanDLACatalogue", "catalogue_from_run"]


class LeanDLACatalogue(DLACatalogue):
    """DLA catalogue statistics from lean (device-reduced) inputs.

    Args mirror :class:`DLACatalogue` where they overlap; the (N, S)
    likelihood arguments are replaced by ``inputs``.
    """

    def __init__(
        self,
        p_dla,
        min_z_dlas,
        max_z_dlas,
        inputs: CDDFInputs,
        offset_samples,
        log_nhi_samples,
        snrs=None,
        snr_thresh: float = -2.0,
        lowzcut: bool = False,
        omega_m: float = OMEGA_M_WMAP9,
        p_dla_2=None,
    ):
        # deliberately NOT calling DLACatalogue.__init__ (it consumes
        # the full matrices); every attribute the inherited methods read
        # is set here with the same meaning
        self.p_dla = np.asarray(p_dla, np.float64)
        self._z_min = np.asarray(min_z_dlas, np.float64)
        self._z_max = np.asarray(max_z_dlas, np.float64)
        n = self.p_dla.size

        # thresholds (calc_cddf.py:42-56) — the per-sample ones must
        # match what the device reduction applied
        self.p_thresh_spec = 5e-2
        self.p_thresh_sample = inputs.spec.p_sample_min
        self.p_switch = inputs.spec.p_switch
        self.bins_per_z = inputs.spec.z_bins_per_unit
        self.lowzcut = lowzcut
        self.proximity_zone = 0.1
        self.noise_thresh = 0.5**2
        self.snr_thresh = snr_thresh
        self.tophat_prior = False

        inputs.validate()
        self.inputs = inputs
        self.z_offsets = np.asarray(offset_samples, np.float64)
        self.lnhi_vals = np.asarray(log_nhi_samples, np.float64)
        self.snrs = None if snrs is None else np.asarray(snrs, np.float64)
        self.pixel_noise = None
        self.filter_noisy_pixels = False
        self.condition = np.ones(n, dtype=bool)

        self.second_dla = inputs.second and p_dla_2 is not None
        if inputs.second and p_dla_2 is None:
            raise ValueError(
                "inputs carry second-DLA reductions but p_dla_2 was not "
                "given — pass multi_model_posteriors[:, 2]"
            )
        if self.second_dla:
            self.p_dla_2 = np.asarray(p_dla_2, np.float64)

        # normalization sanity, the lean analogue of calc_cddf.py:87-99's
        # check: the all-sample probability-mass channel must integrate
        # to p_dla (weights sum to ~1 by the evidence construction)
        keep = self.p_dla > self.p_thresh_spec
        if keep.any():
            mass = inputs.hist[keep, CH_P].astype(np.float64).sum((1, 2))
            ratio = mass / self.p_dla[keep]
            assert np.all((ratio > 0.95) & (ratio < 1.05)), (
                "device-reduced sample masses do not integrate to p_dla "
                "— corrupt or mismatched CDDF inputs"
            )

        self._path = AbsorptionPath(omega_m)
        self.do_resample = False
        self._resample = None
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------
    @classmethod
    def from_results(
        cls, multi, offset_samples, log_nhi_samples, **kwargs
    ) -> "LeanDLACatalogue":
        """From an in-memory lean MultiDLAResults (cddf_inputs set)."""
        if getattr(multi, "cddf_inputs", None) is None:
            raise ValueError(
                "MultiDLAResults has no cddf_inputs — rerun the lean "
                "driver with ShardedRunConfig(store_cddf_inputs=True)"
            )
        single = multi.single
        return cls(
            single.p_dlas,
            single.min_z_dlas,
            single.max_z_dlas,
            multi.cddf_inputs,
            offset_samples,
            log_nhi_samples,
            p_dla_2=multi.model_posteriors[:, 2],
            **kwargs,
        )

    # --- unsupported posterior-shape accessors -------------------------

    def _unsupported(self, what: str):
        raise NotImplementedError(
            f"{what} needs the per-sample likelihood matrix, which lean "
            "runs reduce on device — rerun with store_sample_likelihoods"
            "=True (classic full-matrix mode) for this"
        )

    def _log_norm_like(self, spec, second=False):
        self._unsupported("per-sample posterior access")

    def _get_sample_params(self, spec, second=False):
        self._unsupported("per-sample parameter access")

    def find_delta_nhi(self, spec):
        self._unsupported("find_delta_nhi")

    def find_delta_z(self, spec):
        self._unsupported("find_delta_z")

    def find_max_like(self, spec, second=False):
        """MAP sample parameters from the exact top-k entries (the
        top-1 by probability IS the posterior argmax)."""
        i = self._idx(spec)
        if second:
            idx = int(self.inputs.ex2_base[i, 0])
        else:
            idx = int(self.inputs.ex1_idx[i, 0])
        idx = max(idx, 0)
        z = self._z_min[i] + (
            self._z_max[i] - self._z_min[i]
        ) * self.z_offsets[idx]
        return self.lnhi_vals[idx], z

    # --- grid plumbing --------------------------------------------------

    def _reject_continuous_cuts(self):
        if self.lowzcut:
            raise NotImplementedError(
                "lowzcut cuts samples at per-spectrum continuous "
                "redshifts (z_QSO - 0.1), which binned lean masses "
                "cannot represent — use the classic full-matrix path "
                "(store_sample_likelihoods=True) for lowzcut statistics"
            )

    def _rows(self, specs):
        """Stored-array rows for filtered view indices (bootstrap-aware)."""
        return self._resample[specs] if self.do_resample else specs

    def _lnhi_range_bins(self, lnhi_min, lnhi_max, grid=None):
        """(grid, j0, j1): fine-bin range of an aligned lnhi interval."""
        spec = self.inputs.spec
        m = spec.match_lnhi_bins([lnhi_min, lnhi_max])
        if m is None or (grid is not None and m[0] != grid):
            raise ValueError(
                f"lnhi range ({lnhi_min}, {lnhi_max}) is not aligned "
                "with the lean reduction's log-N_HI grids"
                + (f" (needs grid {grid!r})" if grid else "")
                + " — lean CDDF inputs support only grid-aligned bins; "
                "use the classic full-matrix path for arbitrary bins"
            )
        g, edges = m
        return g, int(edges[0]), int(edges[-1])

    def _z_fine_cols(self, rows):
        """(n_sel, W) global fine z-bin index of each window column."""
        w0 = self.inputs.scalar(EX_W0).astype(np.int64)[rows]
        return w0[:, None] + np.arange(self.inputs.spec.n_z_window)[None, :]

    # --- Poisson-binomial inputs (calc_cddf.py:724-780) -----------------

    def _split_distributions_single(
        self, q_bins, lred, ured, lnhi_min=20.3, lnhi_max=23.0, nhi=False,
        second=False,
    ):
        self._reject_continuous_cuts()
        spec = self.inputs.spec
        q = np.asarray(q_bins, np.float64)
        nbins = q.size - 1
        probs = [[] for _ in range(nbins)]

        specs = self.filter_dla_spectra(second=second)
        rows = self._rows(specs)

        # ---- exact entries: float64 rebind, zero binning error ----
        if second:
            pE = self.inputs.ex2_p[rows]
            idxE = self.inputs.ex2_base[rows]
        else:
            pE = self.inputs.ex1_p[rows]
            idxE = self.inputs.ex1_idx[rows]
        safe = np.maximum(idxE, 0)
        zmin = self._z_min[rows][:, None]
        span = (self._z_max - self._z_min)[rows][:, None]
        zE = zmin + span * self.z_offsets[safe]
        lE = self.lnhi_vals[safe]
        keep = (
            (idxE >= 0)
            & (pE >= self.p_switch)
            & (pE > self.p_thresh_sample)
            & (lE > lnhi_min)
            & (lE < lnhi_max)
            & (zE > lred)
            & (zE < ured)
        )
        quantity = lE if nhi else zE
        for b in range(nbins):
            sel = keep & (quantity > q[b]) & (quantity < q[b + 1])
            if sel.any():
                probs[b].append(pE[sel])

        # ---- Poisson tails: binned small-p masses ----
        poissons = np.zeros(nbins)
        if rows.size:
            gl = self._z_fine_cols(rows)
            g_lo = spec.match_z_edge(lred)
            g_hi = spec.match_z_edge(ured)
            hist = self.inputs.hist
            if nhi:
                m = spec.match_lnhi_bins(q)
                if m is None:
                    raise ValueError(
                        "CDDF lnhi bins are not aligned with the lean "
                        "reduction grids — use grid-aligned bins or the "
                        "classic full-matrix path"
                    )
                grid, edges = m
                # an outer lnhi cut strictly inside the bins would slice
                # a bin at continuous resolution — refuse (no default
                # configuration does this: the cuts coincide with the
                # outer bin edges)
                if lnhi_min > q[0] + 1e-9 or lnhi_max < q[-1] - 1e-9:
                    raise ValueError(
                        f"lnhi range ({lnhi_min}, {lnhi_max}) cuts inside "
                        "the requested bins — unsupported on lean inputs"
                    )
                ch = (CH_SMALL2_A if second else CH_SMALL_A) if grid == "a" \
                    else (CH_SMALL2_B if second else CH_SMALL_B)
                zmask = (gl >= g_lo) & (gl < g_hi)
                h = hist[rows, ch].astype(np.float64)  # (n, W, nl+1)
                lsum = np.einsum("nwl,nw->l", h, zmask.astype(np.float64))
                for b in range(nbins):
                    poissons[b] = lsum[int(edges[b]) : int(edges[b + 1])].sum()
            else:
                grid, j0, j1 = self._lnhi_range_bins(lnhi_min, lnhi_max)
                ch = (CH_SMALL2_A if second else CH_SMALL_A) if grid == "a" \
                    else (CH_SMALL2_B if second else CH_SMALL_B)
                h = hist[rows, ch, :, j0:j1].astype(np.float64)
                zsum = h.sum(axis=2)  # (n, W)
                for b in range(nbins):
                    lo = max(spec.match_z_edge(q[b]), g_lo)
                    hi = min(spec.match_z_edge(q[b + 1]), g_hi)
                    m_b = (gl >= lo) & (gl < hi)
                    poissons[b] = float((zsum * m_b).sum())
        return probs, poissons

    # --- direct count/moment histogram (calc_cddf.py:829-870) -----------

    def _get_z_nhi_hist(
        self, q_bins, lred, ured, lnhi_min=20.3, lnhi_max=23.0,
        nhi=False, moment=False,
    ):
        self._reject_continuous_cuts()
        spec = self.inputs.spec
        q = np.asarray(q_bins, np.float64)
        nbins = q.size - 1
        mean_ch = CH_P_NU if moment else CH_P
        var_ch = CH_P_VAR_NU2 if moment else CH_P_VAR
        mean_scale = 10.0**spec.nu_log_offset if moment else 1.0
        var_scale = 10.0 ** (2 * spec.nu_log_offset) if moment else 1.0

        means = np.zeros(nbins)
        variances = np.zeros(nbins)
        specs = self.filter_dla_spectra()
        rows = self._rows(specs)
        if rows.size:
            gl = self._z_fine_cols(rows)
            g_lo = spec.match_z_edge(lred)
            g_hi = spec.match_z_edge(ured)
            hist = self.inputs.hist
            if nhi:
                m = spec.match_lnhi_bins(q)
                if m is None or m[0] != "a":
                    raise ValueError(
                        "moment histograms are stored on the lean "
                        "reduction's grid A (0.1-wide from 20.0) — use "
                        "grid-A-aligned lnhi bins or the classic path"
                    )
                edges = m[1]
                if lnhi_min > q[0] + 1e-9 or lnhi_max < q[-1] - 1e-9:
                    raise ValueError(
                        f"lnhi range ({lnhi_min}, {lnhi_max}) cuts inside "
                        "the requested bins — unsupported on lean inputs"
                    )
                zmask = ((gl >= g_lo) & (gl < g_hi)).astype(np.float64)
                hm = np.einsum(
                    "nwl,nw->l", hist[rows, mean_ch].astype(np.float64), zmask
                )
                hv = np.einsum(
                    "nwl,nw->l", hist[rows, var_ch].astype(np.float64), zmask
                )
                for b in range(nbins):
                    sl = slice(int(edges[b]), int(edges[b + 1]))
                    means[b] = hm[sl].sum() * mean_scale
                    variances[b] = hv[sl].sum() * var_scale
            else:
                _, j0, j1 = self._lnhi_range_bins(lnhi_min, lnhi_max, "a")
                hm = hist[rows, mean_ch, :, j0:j1].astype(np.float64).sum(2)
                hv = hist[rows, var_ch, :, j0:j1].astype(np.float64).sum(2)
                for b in range(nbins):
                    lo = max(spec.match_z_edge(q[b]), g_lo)
                    hi = min(spec.match_z_edge(q[b + 1]), g_hi)
                    m_b = (gl >= lo) & (gl < hi)
                    means[b] = float((hm * m_b).sum()) * mean_scale
                    variances[b] = float((hv * m_b).sum()) * var_scale
        variances += means  # Poisson sampling term (calc_cddf.py:863-869)
        return means, variances


def catalogue_from_run(
    workdir: str | Path,
    test_set_name: str = "dr12q",
    multi: bool = False,
    **kwargs,
) -> DLACatalogue:
    """The catalogue of the pipeline's stage artifacts
    (``DLACatalogue.from_run``): the classic ``DLACatalogue.from_run``
    for artifacts with sample matrices, a :class:`LeanDLACatalogue` for
    a lean multi-DLA artifact with device-reduced CDDF inputs.  The lean
    branch is handled here, so that ``DLACatalogue.from_run`` never
    reaches the JAX package's ``cddf_inputs``."""
    workdir = Path(workdir)
    fname = (
        f"processed_qsos_multi_{test_set_name}.npz"
        if multi
        else f"processed_qsos_{test_set_name}.npz"
    )
    with np.load(workdir / fname) as f:
        if "sample_log_likelihoods_dla" in f.files:
            results = None
        elif multi and CDDFInputs.npz_present(f.files):
            results = {k: f[k] for k in f.files}
        else:
            raise ValueError(
                f"{fname} was written by a lean (catalog-only) run and "
                "has no sample_log_likelihoods_dla matrix; the CDDF "
                "marginalizes posterior sample weights (calc_cddf.py) — "
                "rerun with store_sample_likelihoods=True, or run the "
                "fused lean two-stage driver with store_cddf_inputs="
                "True to device-reduce the statistics' inputs"
            )
    if results is None:
        return DLACatalogue.from_run(workdir, test_set_name, multi=multi, **kwargs)
    with np.load(workdir / "dla_samples.npz") as f:
        offsets = f["offset_samples"]
        lnhi = f["log_nhi_samples"]
    snrs = None
    snrs_path = workdir / "snrs.npz"
    if snrs_path.exists():
        with np.load(snrs_path) as f:
            snrs = f["snrs"]
    return LeanDLACatalogue(
        results["p_dlas"],
        results["min_z_dlas"],
        results["max_z_dlas"],
        CDDFInputs.from_npz_dict(results),
        offsets,
        lnhi,
        snrs=snrs,
        p_dla_2=results["multi_model_posteriors"][:, 2],
        **kwargs,
    )
