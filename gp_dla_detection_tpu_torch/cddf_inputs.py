"""Device-reduced CDDF inputs for lean (catalog-only) runs, in PyTorch.

Counterpart of ``gp_dla_detection_tpu/cddf_inputs.py``.  The column
density distribution f(N), the line density dN/dX and Omega_DLA
(CDDF_analysis/calc_cddf.py:440-464, 490-507, 521-560) marginalize each
spectrum's normalized sample probabilities.  The fused lean chain never
holds the (N, S) matrices on the host, so it reduces on the device,
per batch, everything those statistics consume:

  - binned small-probability masses on fixed (z, log N_HI) grids whose
    cells the default statistics' bins are unions of;
  - exact entries (sample indices) for every sample with p >= p_switch,
    rebound to float64 (z, log N_HI) on the host;
  - moment histograms sum(p), sum(p N_HI), sum(p (1-p)),
    sum(p (1-p) N_HI^2) for the direct Omega_DLA estimator.

The host side (the channel layout, :class:`CDDFReductionSpec` and
:class:`CDDFInputs`) is a copy of the JAX package's, held equal to it by
the tests; the quantization contract is the JAX module's docstring.
The device side, :func:`make_cddf_reducer`, is plain torch in float64
(inputs of a float32 run upcast, results returned at the run dtype): one
``scatter_add_`` over the flat index ``zloc * (n_lnhi + 1) + lnhi_bin``
where the JAX package runs one masked matmul per z bin, and a stable
descending sort where it runs ``lax.top_k``, so that ties (every row
with fewer than top_k non-zero p) keep the lower index first, as
``lax.top_k`` orders them.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

__all__ = [
    "CDDFReductionSpec",
    "CDDFInputs",
    "make_cddf_reducer",
]

# channel layout of the (B, 8, n_z_window, n_lnhi+1) histogram tensor;
# the final lnhi column is the dump bin (samples outside the grid's
# open interval — the classic range cuts exclude them, but they must
# still be accounted for so sum(P_CHANNEL) == p_dla holds per spectrum)
CH_SMALL_A = 0      # sum p,         1e-4 < p < 0.25, grid A
CH_P = 1            # sum p,         all samples,     grid A
CH_P_NU = 2         # sum p*nu,      all samples,     grid A
CH_P_VAR = 3        # sum p*(1-p),   all samples,     grid A
CH_P_VAR_NU2 = 4    # sum p*(1-p)*nu^2, all,          grid A
CH_SMALL_B = 5      # sum p,         small,           grid B
CH_SMALL2_A = 6     # sum p2,        small, 2nd DLA,  grid A (by base z/N)
CH_SMALL2_B = 7     # sum p2,        small, 2nd DLA,  grid B
N_CHANNELS = 8


@dataclasses.dataclass(frozen=True)
class CDDFReductionSpec:
    """Static geometry of the device reduction.

    The two log-N_HI grids cover every binning the reference's
    statistics use by default: grid A (width 0.1 from 20.0) nests the
    CDDF's 30 bins over [20, 23] (calc_cddf.py:440-464) and the 20.3
    line-density cut; grid B (width 0.09 from 20.3) nests
    Omega_DLA(CDDF)'s 30 bins over [20.3, 23] and the 15-bin bootstrap
    variant (width 0.18).  The redshift grid at 1/6 per bin nests every
    ``bins_per_z = 6`` statistic with integer z endpoints
    (calc_cddf.py:49).
    """

    z_bins_per_unit: int = 6
    # per-spectrum z window, in fine z bins: must cover the widest DLA
    # search range (max_z - min_z <= ~1.2 for any z_QSO <= 7 given the
    # Lyb..Lya forest bounds, = ~8 bins); violations are counted on
    # device and raised loudly on the host
    n_z_window: int = 12
    lnhi_a_start: float = 20.0
    lnhi_a_width: float = 0.1
    lnhi_b_start: float = 20.3
    lnhi_b_width: float = 0.09
    n_lnhi: int = 30
    top_k: int = 8
    # thresholds mirror calc_cddf.py:42-56 (DLACatalogue)
    p_sample_min: float = 1e-4
    p_switch: float = 0.25
    # N_HI moment weights are stored as nu = 10^(lnhi - nu_log_offset)
    # so nu^2 sums stay in f32 range; the host multiplies the offset back
    nu_log_offset: float = 20.0

    def token(self) -> str:
        """Fingerprint component: any field change invalidates stored
        reductions."""
        return "cddf_inputs:v1:" + json.dumps(
            dataclasses.asdict(self), sort_keys=True
        )

    # ---- host-side grid helpers (shared with LeanDLACatalogue) ----

    def lnhi_bin_index(self, lnhi, grid: str) -> np.ndarray:
        """float64 bin index on grid 'a'|'b'; n_lnhi = the dump bin.

        Outer bounds are STRICT (samples at exactly the grid start/end
        are dumped), matching the classic open-interval range cuts."""
        start, width = (
            (self.lnhi_a_start, self.lnhi_a_width)
            if grid == "a"
            else (self.lnhi_b_start, self.lnhi_b_width)
        )
        lnhi = np.asarray(lnhi, np.float64)
        idx = np.floor((lnhi - start) / width).astype(np.int64)
        end = start + width * self.n_lnhi
        out = np.where(
            (lnhi > start) & (lnhi < end),
            np.clip(idx, 0, self.n_lnhi - 1),
            self.n_lnhi,
        )
        return out

    def match_lnhi_bins(self, q_bins) -> tuple[str, int] | None:
        """If ``q_bins`` is a contiguous run of one grid's edges,
        return (grid, first bin index); else None."""
        q = np.asarray(q_bins, np.float64)
        for grid, start, width in (
            ("a", self.lnhi_a_start, self.lnhi_a_width),
            ("b", self.lnhi_b_start, self.lnhi_b_width),
        ):
            j = (q - start) / width
            jr = np.round(j)
            if (
                np.all(np.abs(j - jr) < 1e-6)
                and np.all(np.diff(jr) >= 1)
                and jr[0] >= 0
                and jr[-1] <= self.n_lnhi
            ):
                return grid, jr.astype(np.int64)
        return None

    def match_z_edge(self, z: float) -> int:
        """Global fine z-bin index of an aligned z edge, or raise."""
        j = float(z) * self.z_bins_per_unit
        jr = round(j)
        if abs(j - jr) > 1e-6:
            raise ValueError(
                f"z edge {z} is not aligned with the lean reduction's "
                f"1/{self.z_bins_per_unit} redshift grid — lean-reduced "
                "CDDF inputs only support statistics whose bins are "
                "unions of the reduction grid cells (all defaults are); "
                "rerun with store_sample_likelihoods=True for arbitrary "
                "bins"
            )
        return int(jr)


# per-spectrum scalar row layout of CDDFInputs.ex beyond the 5 top-k
# blocks [ex1_p, ex1_idx, ex2_p, ex2_pair_idx, ex2_base_idx]
EX_W0 = 0          # window start (global fine z bin)
EX_NBIG1 = 1       # count of first-DLA p >= p_switch (must be <= top_k)
EX_NBIG2 = 2       # count of second-DLA p2 >= p_switch
EX_ZOVER = 3       # mass-carrying samples outside the z window (must be 0)
N_EX_SCALARS = 4


@dataclasses.dataclass
class CDDFInputs:
    """Host-side container for the fetched reductions.

    hist: (N, 8, n_z_window, n_lnhi+1) float32/float64 (run dtype).
    ex:   (N, 5*top_k + 4): [ex1_p | ex1_idx | ex2_p | ex2_pair_idx |
          ex2_base_idx | w0, nbig1, nbig2, zover].  Indices are exact
          (< 2**24 guard in the lean driver); pair indices are in
          ORIGINAL sample numbering (the driver translates sorted pair
          columns before storing).  second=False runs store -1/0 blocks.
    """

    spec: CDDFReductionSpec
    hist: np.ndarray
    ex: np.ndarray
    second: bool = True

    # ---- field accessors ----
    def _blk(self, i):
        k = self.spec.top_k
        return self.ex[:, i * k : (i + 1) * k]

    @property
    def ex1_p(self):
        return self._blk(0)

    @property
    def ex1_idx(self):
        return self._blk(1).astype(np.int64)

    @property
    def ex2_p(self):
        return self._blk(2)

    @property
    def ex2_idx(self):
        return self._blk(3).astype(np.int64)

    @property
    def ex2_base(self):
        return self._blk(4).astype(np.int64)

    def scalar(self, which: int):
        return self.ex[:, 5 * self.spec.top_k + which]

    def validate(self) -> None:
        """Loud integrity checks on the device counters."""
        zover = self.scalar(EX_ZOVER)
        if np.any(zover > 0):
            bad = int(np.flatnonzero(zover > 0)[0])
            raise ValueError(
                f"{int((zover > 0).sum())} spectra (first: row {bad}) "
                "have posterior mass outside the lean reduction's "
                f"{self.spec.n_z_window}-bin redshift window — increase "
                "CDDFReductionSpec.n_z_window (the DLA search range is "
                "wider than the spec assumed)"
            )
        for name, n in (("first", EX_NBIG1), ("second", EX_NBIG2)):
            nbig = self.scalar(n)
            if np.any(nbig > self.spec.top_k):
                raise ValueError(
                    f"a spectrum has {int(nbig.max())} {name}-DLA samples "
                    f"above p_switch but the reduction stored only "
                    f"top_k={self.spec.top_k} exact entries — increase "
                    "CDDFReductionSpec.top_k (normalized probabilities "
                    "bound this by 1/p_switch = 4, so this indicates "
                    "corrupt inputs)"
                )

    # ---- persistence (flat npz-compatible dict, "cddf_" prefix) ----
    def to_npz_dict(self, prefix: str = "cddf_") -> dict:
        return {
            prefix + "hist": self.hist,
            prefix + "ex": self.ex,
            prefix + "spec": np.frombuffer(
                json.dumps(dataclasses.asdict(self.spec)).encode(), np.uint8
            ),
            prefix + "second": np.asarray(self.second),
        }

    @classmethod
    def from_npz_dict(cls, d, prefix: str = "cddf_") -> "CDDFInputs":
        spec = CDDFReductionSpec(
            **json.loads(bytes(np.asarray(d[prefix + "spec"])).decode())
        )
        return cls(
            spec=spec,
            hist=np.asarray(d[prefix + "hist"]),
            ex=np.asarray(d[prefix + "ex"]),
            second=bool(np.asarray(d[prefix + "second"])),
        )

    @classmethod
    def npz_present(cls, files, prefix: str = "cddf_") -> bool:
        return prefix + "hist" in files


def _top_k(x, k: int):
    """The k largest entries of each row and their indices, largest
    first; among equal values the lower index comes first (the order
    ``lax.top_k`` gives)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def make_cddf_reducer(
    spec: CDDFReductionSpec,
    offset_samples,
    log_nhi_samples,
    order=None,
    device=None,
):
    """Build the device reduction of one batch of the lean chain.

    Args:
      offset_samples, log_nhi_samples: the (S,) QMC prior tables
        (ORIGINAL sample order).
      order: z-sort permutation of the pair stage's fresh axis (the
        ``"cuda"`` backend), or None when pair columns ride original
        order.
      device: where the constant tables live.

    Returns ``(reduce_fn, consts)``; ``reduce_fn(consts, sll, ev1,
    ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m, ll2_pair,
    ev2, base_cols) -> (hist, ex)``, all (B, ...) tensors on one device,
    returned at the dtype of ``sll`` (the run dtype).  The reduction
    itself runs in float64 whatever the run dtype, one pass over (B, S)
    next to the kernels' (B, S, P): the float32 run's weights then sum to
    1 (its evidence, at ~1e3, is off by ~1e-4 in float32), its masses do
    not depend on the order the card's atomics add in, and its redshift
    bins are the float64 host's.  A float64 run computes exactly what the
    JAX package's float64 run does.
    """
    offsets = np.asarray(offset_samples, np.float64)
    lnhis = np.asarray(log_nhi_samples, np.float64)
    S = len(offsets)
    nl = spec.n_lnhi
    W = spec.n_z_window
    K = spec.top_k
    put = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), device=device).to(dt)

    nu = 10.0 ** (lnhis - spec.nu_log_offset)
    consts = {
        "off": put(offsets),
        "lh_a": put(spec.lnhi_bin_index(lnhis, "a"), torch.int64),
        "lh_b": put(spec.lnhi_bin_index(lnhis, "b"), torch.int64),
        "nu": put(nu),
        "nu2": put(nu**2),
        "order": None if order is None else put(order, torch.int64),
    }
    # the grids each channel bins on (the CH_* layout)
    grid_b = torch.tensor(
        [c in (CH_SMALL_B, CH_SMALL2_B) for c in range(N_CHANNELS)], device=device
    )

    def reduce_fn(
        c, sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m,
        ll2_pair, ev2, base_cols,
    ):
        dt = sll.dtype
        B = sll.shape[0]
        (sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m, ll2_pair, ev2) = (
            x.to(torch.float64)
            for x in (sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m,
                      ll2_pair, ev2)
        )
        f64 = torch.float64
        zero = torch.zeros((), dtype=f64, device=sll.device)
        neg_inf = torch.full((), -math.inf, dtype=f64, device=sll.device)
        nan_to_0 = lambda x: torch.where(torch.isnan(x), zero, x)

        # p_dla mirrors inference.posteriors_from_evidence exactly
        # (including the 1 - p0 form), from the evidence the host keeps
        a = lp_no + ll_null
        b = lp_dla + ev1
        m2 = torch.maximum(a, b)
        e0, e1 = torch.exp(a - m2), torch.exp(b - m2)
        p_dla = nan_to_0(1.0 - e0 / (e0 + e1))

        # the weights' normalizer, pack_lean's evidence recomputed from the
        # samples in float64: a float32 evidence of magnitude ~1e3 is off
        # by ~1e-4, and so would be the sum of the float32 run's weights
        # (in a float64 run this is ev1, bit for bit)
        row_max = torch.amax(sll, dim=1)
        norm = row_max + torch.log(torch.mean(torch.exp(sll - row_max[:, None]), dim=1))
        logw = sll - norm[:, None] - torch.log(torch.full((), S, dtype=f64, device=sll.device))
        p = nan_to_0(torch.exp(logw) * p_dla[:, None])

        bpz = torch.full((), spec.z_bins_per_unit, dtype=f64, device=sll.device)
        zf = min_z[:, None] + (max_z - min_z)[:, None] * c["off"][None, :]
        w0 = torch.floor(min_z * bpz)
        w0 = torch.where(torch.isfinite(w0), w0, zero).to(torch.int64)
        zloc_f = torch.floor(zf * bpz)
        zloc = (
            torch.where(torch.isfinite(zloc_f), zloc_f, -torch.ones_like(zloc_f)).to(torch.int64)
            - w0[:, None]
        )
        in_win = (zloc >= 0) & (zloc < W)

        small1 = (p > spec.p_sample_min) & (p < spec.p_switch)
        ps = torch.where(small1, p, zero)
        # a posterior on one sample gives p = 1 + 1 ulp, and a negative
        # variance there a NaN Omega_DLA error bar: the Bernoulli variance
        # is clamped at 0 (the JAX package's is not)
        pvar = p * torch.clamp(1.0 - p, min=0.0)
        z_over = ((~in_win) & (p > 0)).sum(dim=1)

        ex1_p, ex1_i = _top_k(p, K)
        nbig1 = (p >= spec.p_switch).sum(dim=1)

        # p(2 DLAs) mirrors multi_dla._multi_posteriors
        posts = torch.stack([lp0m + ll_null, lp1m + ev1, lp2m + ev2], dim=1)
        pmax = torch.amax(posts, dim=1, keepdim=True)
        e = torch.exp(posts - pmax)
        p_dla2 = nan_to_0(e[:, 2] / e.sum(dim=1))

        lw_pair = logw if c["order"] is None else logw[:, c["order"]]
        comb = ll2_pair + lw_pair
        comb = torch.where(torch.isfinite(comb), comb, neg_inf)
        cmax = torch.amax(comb, dim=1)
        safe = torch.where(torch.isfinite(cmax), cmax, zero)
        lse = safe + torch.log(torch.exp(comb - safe[:, None]).sum(dim=1))
        p2 = nan_to_0(torch.exp(comb - lse[:, None]) * p_dla2[:, None])

        small2 = (p2 > spec.p_sample_min) & (p2 < spec.p_switch)
        p2s = torch.where(small2, p2, zero)
        # bin by the SECOND component's (z, lnhi) = the base draw's:
        # group pair columns by base sample first, then the base
        # sample's zloc/lnhi bins are the first stage's own tables
        base = base_cols.to(torch.int64)
        acc = torch.zeros((B, S), dtype=torch.float64, device=sll.device)
        acc.scatter_add_(1, base, p2s)

        ex2_p, ex2_i = _top_k(p2, K)
        ex2_b = torch.gather(base, 1, ex2_i)
        nbig2 = (p2 >= spec.p_switch).sum(dim=1)

        # every channel's masses in one scatter over the flat (z, lnhi)
        # index; samples outside the window go to a slot that is dropped
        vals = torch.stack(
            [ps, p, p * c["nu"], pvar, pvar * c["nu2"], ps, acc, acc], dim=1
        )  # (B, 8, S)
        lh = torch.where(grid_b[:, None], c["lh_b"][None, :], c["lh_a"][None, :])  # (8, S)
        flat = zloc[:, None, :] * (nl + 1) + lh[None, :, :]
        dump = W * (nl + 1)
        flat = torch.where(in_win[:, None, :], flat, torch.full_like(flat, dump))
        hist = torch.zeros((B, N_CHANNELS, dump + 1), dtype=torch.float64, device=sll.device)
        hist.scatter_add_(2, flat, vals)
        hist = hist[:, :, :dump].reshape(B, N_CHANNELS, W, nl + 1).to(dt)

        col = lambda x: x.to(f64)[:, None]
        ex = torch.cat(
            [
                ex1_p, ex1_i.to(f64), ex2_p, ex2_i.to(f64), ex2_b.to(f64),
                col(w0), col(nbig1), col(nbig2), col(z_over),
            ],
            dim=1,
        )
        return hist, ex.to(dt)

    return reduce_fn, consts
