"""The comparison that decides ``correct``: the outputs of the timed path
for a sample of the spectra a run finished, against the plain reference
worked out again from the same inputs.

Every number is a gap per spectrum of the sample, summarized over the
sample (``<gap>.<max|mean|median>``); the cell's file names the ones compared
and their limits.  The gaps:

- ``shape`` / ``shape5``: the posterior's shape near its peak: the widest
  error of log(p_i / p_0), p_0 the top sample's mass, over the samples
  within 20 / 5 nats of it, against the reference's log-likelihood
  differences of the same samples (the chain: the CDDF inputs' top_k
  exact entries; the full-mode single stage: its whole (B, S) row);
- ``shape2`` / ``shape2_5``: the pair stage's posterior shape: the same
  for the CDDF inputs' top_k pairs, against the reference's pair log
  likelihoods of those (fresh, base) pairs plus its single-DLA log
  likelihood of the fresh sample; a reported pair closer than the
  minimum separation reads as an infinite gap;
- ``hist_c<c>``: sum |hist - reference's| over channel c's cells, over
  the reference's sum of |hist| there (c = 0: p on grid A, the small
  masses the CDDF reads; c = 6, 7: the second-DLA masses on the base
  samples).  In the first-DLA channels 0-5 the reference is an interval
  per cell (``reference.cddf.first_dla_bounds``): a sample whose mass is
  within CUT_REL of the small masses' cuts (p_sample_min, p_switch), or
  whose redshift is within Z_EDGE of a bin edge, may fall either side,
  as rounding puts it; the gap there is how far each cell lies outside
  its interval, and is the plain one where no sample is that near;
- ``top``: the widest gap of the top_k largest p;
- ``evidence``, ``null``, ``bayes_factor`` (evidence - null), ``p_dla``,
  ``map`` (how far the reference's log likelihood of the program's MAP
  sample lies below its best), ``pair_evidence``, ``pair_bf`` (pair
  evidence - single evidence): read, not compared.

Why the posterior's shape and its masses, and not the evidences: a
float32 evaluation of a spectrum's ~1,300 pixel sums (the null's and each
sample's) carries ~0.01-0.1 nats of rounding that the control shares, so
the evidences of the program and of the control read alike; TF32 moves
the samples against each other, which the shape and the masses show.
The pair stage carries mass only where a sightline holds two absorbers,
so a chain cell draws half of its sample from those
(``harness.check_rows``).  A spectrum whose gap is not finite reads as
an infinite gap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench.reference import cddf as ref_cddf
from gpbench.reference.model import ModelConfig, Reference, counting_priors, softmax_rows

SHAPE_NATS = 20.0   # the posterior's peak: entries within this of the top one
TINY = 1e-25        # masses below this are none: float32 outputs flush them
CUT_REL = 0.1       # a mass this near (relative) a histogram cut may fall either side
Z_EDGE = 1e-5       # a redshift this near a bin edge may fall in either bin
LOG_TINY = math.log(TINY)


def reference_for(cfg: dict, model: dict, samples, device, dtype=torch.float64, tf32=False,
                  plain_program: bool = False) -> Reference:
    """The reference of a configuration.  ``plain_program``: the program
    runs its plain path, which draws at R = 1 on the unsorted axis."""
    mc = ModelConfig.from_config(cfg)
    if plain_program:
        mc = ModelConfig(**{**mc.__dict__, "base_replicates": 1})
    return Reference(mc, model, samples[0], samples[1], device=device, dtype=dtype, tf32=tf32,
                     sorted_axis=not plain_program)


def reference_outputs(ref: Reference, pool: dict, rows, priors: dict, multi: bool,
                      log_nhis=None, spec=None, full: bool = False) -> dict:
    """The reference's outputs of ``rows``, in the program's layout (with
    ``full``, the sample log likelihoods too; with ``multi``, the pair
    stage and the CDDF inputs), plus what the comparison reads beside
    them (``_ref``: per row, the reference's stages)."""
    out = {k: [] for k in ("ll0", "ev1", "map1", "p_dla", "ev2", "map2", "map_base", "post",
                           "hist", "hist_lo", "hist_hi", "ex", "sll")}
    keep = []
    for i, r in enumerate(rows):
        prep = ref.prepare(pool["wavelengths"][r], pool["flux"][r], pool["noise_variance"][r],
                           pool["mask"][r], pool["z_qso"][r])
        s = ref.single(prep, keep_tau=multi)
        pr = {k: v[i] for k, v in priors.items()}
        out["ll0"].append(s["ll_null"])
        out["ev1"].append(s["ev1"])
        out["map1"].append(s["map1"])
        e = softmax_rows(np.array([pr["lp_no"] + s["ll_null"], pr["lp_dla"] + s["ev1"]]))
        out["p_dla"].append(1.0 - e[0])
        if full:
            out["sll"].append(s["sll"].double().cpu().numpy())
        entry = {"prep": prep, "single": s}
        if multi:
            p = ref.pair(prep, s["sll"])
            out["ev2"].append(p["ev2"])
            out["map2"].append(p["map2"])
            out["map_base"].append(p["map_base"])
            out["post"].append(softmax_rows(np.array(
                [pr["lp0m"] + s["ll_null"], pr["lp1m"] + s["ev1"], pr["lp2m"] + p["ev2"]])))
            hist, ex = ref_cddf.reduce_row(spec, ref.offsets_np, log_nhis, s, p, pr)
            out["hist"].append(hist)
            lo, hi = ref_cddf.first_dla_bounds(spec, ref.offsets_np, log_nhis, s, pr,
                                               CUT_REL, Z_EDGE)
            out["hist_lo"].append(lo)
            out["hist_hi"].append(hi)
            out["ex"].append(ex)
            entry["pair"] = p
            prep.pop("tau")        # (S, P6) a row: not kept past the row
        keep.append(entry)
    res = {k: np.asarray(v) for k, v in out.items() if v}
    res["_ref"] = keep
    return res


def _abs_gap(a, b) -> np.ndarray:
    """|a - b| per entry; 0 where both are NaN, inf where one is not finite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return np.where(np.isnan(a) & np.isnan(b), 0.0, np.where(np.isfinite(d), d, np.inf))


def _shape_gap(log_p, want_ll, want_p0: float, nats: float | None = None) -> float:
    """The widest error of the log ratios log(p_i / p_0) of the top
    entries (p_0 the largest) within SHAPE_NATS of it, against the
    reference's log-likelihood differences of the same samples.
    A row where the reference's top mass is below TINY reads 0; one where
    the program's is 100 times below it while the reference's is not, inf."""
    log_p, want_ll = np.asarray(log_p, np.float64), np.asarray(want_ll, np.float64)
    if not want_p0 >= TINY:
        return 0.0      # the reference puts no mass here that a float32 output keeps
    ok = np.isfinite(log_p)
    if not len(ok) or not ok[0] or log_p[0] < LOG_TINY - math.log(100.0):
        return math.inf
    ok &= log_p >= log_p[0] - (SHAPE_NATS if nats is None else nats)
    d = (log_p[ok] - log_p[0]) - (want_ll[ok] - want_ll[0])
    d = np.where(np.isfinite(d), np.abs(d), np.inf)
    return float(d.max())


def hist_gap(got, lo, hi, want) -> np.ndarray:
    """Per row: the sum over cells of how far ``got`` lies outside
    [lo, hi], over the reference's (``want``) sum of |mass|; not finite
    reads inf."""
    num = np.maximum(np.maximum(lo - got, got - hi), 0.0).sum(axis=(1, 2))
    rel = num / np.maximum(np.abs(want).sum(axis=(1, 2)), TINY)
    return np.where(np.isfinite(rel), rel, np.inf)


def row_gaps(ref: Reference, got: dict, want: dict, multi: bool, spec=None) -> dict:
    """Per row of the sample, every gap the numbers are made of."""
    rows = {"evidence": _abs_gap(got["ev1"], want["ev1"]),
            "null": _abs_gap(got["ll0"], want["ll0"]),
            "bayes_factor": _abs_gap(np.asarray(got["ev1"]) - np.asarray(got["ll0"]),
                                     np.asarray(want["ev1"]) - np.asarray(want["ll0"])),
            "p_dla": _abs_gap(got["p_dla"], want["p_dla"])}
    if "map1" in got:
        maps = []
        for i, entry in enumerate(want["_ref"]):
            sll = entry["single"]["sll"]
            j = int(got["map1"][i])
            g = float(torch.amax(sll) - sll[j]) if 0 <= j < len(sll) else math.inf
            maps.append(g if math.isfinite(g) else math.inf)
        rows["map"] = np.array(maps)
    if "sll" in got:
        # the full row: every sample within SHAPE_NATS of the top one
        shape = []
        for i, entry in enumerate(want["_ref"]):
            w = entry["single"]["sll"].double().cpu().numpy()
            g = np.asarray(got["sll"][i], np.float64)
            top = int(np.argmax(np.where(np.isfinite(g), g, -np.inf)))
            near = np.flatnonzero(g >= g[top] - SHAPE_NATS)
            order = np.r_[top, near[near != top]]
            shape.append([_shape_gap(g[order] - g[top], w[order], 1.0, n) for n in (None, 5.0)])
        rows["shape"], rows["shape5"] = (np.array(v) for v in zip(*shape))
    if not multi:
        return rows
    K = spec.top_k
    gex = np.asarray(got["ex"], np.float64)
    wex = np.asarray(want["ex"], np.float64)
    shape1 = []
    for i, entry in enumerate(want["_ref"]):
        sll = entry["single"]["sll"].double().cpu().numpy()
        idx = gex[i, K : 2 * K].astype(np.int64)
        with np.errstate(divide="ignore"):
            lp = np.log(gex[i, :K])
        ok = (idx >= 0) & (idx < len(sll))
        shape1.append([_shape_gap(lp[ok], sll[idx[ok]], wex[i, 0], n) for n in (None, 5.0)])
    rows["shape"], rows["shape5"] = (np.array(v) for v in zip(*shape1))
    shape2 = []
    for i, entry in enumerate(want["_ref"]):
        sll = entry["single"]["sll"]
        p2 = gex[i, 2 * K : 3 * K]
        fresh, base = (gex[i, j * K : (j + 1) * K].astype(np.int64) for j in (3, 4))
        ok = (fresh >= 0) & (fresh < len(sll)) & (base >= 0) & (base < len(sll))
        if ((p2 > 0) & ~ok).any():
            shape2.append([math.inf, math.inf])     # a mass on no pair
            continue
        f, b = (torch.as_tensor(a[ok], device=sll.device) for a in (fresh, base))
        ll2 = ref.pair_lls(entry["prep"], f, b) + sll[f]
        with np.errstate(divide="ignore"):
            lp2 = np.log(p2[ok])
        w = ll2.double().cpu().numpy()
        shape2.append([_shape_gap(lp2, w, wex[i, 2 * K], n) for n in (None, 5.0)])
    rows["shape2"], rows["shape2_5"] = (np.array(v) for v in zip(*shape2))
    gh, wh = np.asarray(got["hist"], np.float64), np.asarray(want["hist"], np.float64)
    lo, hi = (np.asarray(want[k], np.float64) for k in ("hist_lo", "hist_hi"))
    for c in (0, 1, 2, 3, 4, 5, 6, 7):
        # the first-DLA channels against the reference's interval, the
        # second-DLA ones against the reference itself
        bounds = (lo[:, c], hi[:, c]) if c < lo.shape[1] else (wh[:, c], wh[:, c])
        rows[f"hist_c{c}"] = hist_gap(gh[:, c], *bounds, wh[:, c])
    rows["top"] = _abs_gap(gex[:, :K], wex[:, :K]).max(axis=1)
    rows["pair_evidence"] = _abs_gap(got["ev2"], want["ev2"])
    rows["pair_bf"] = _abs_gap(np.asarray(got["ev2"]) - np.asarray(got["ev1"]),
                               np.asarray(want["ev2"]) - np.asarray(want["ev1"]))
    return rows


def compare(ref: Reference, got: dict, want: dict, multi: bool, spec=None) -> dict:
    """Every statistic of ``got`` (the program's outputs of the sample,
    or the control's) against ``want`` (the reference's)."""
    return summarize(row_gaps(ref, got, want, multi, spec))


def priors_of(cfg: dict, catalogue, z_qsos) -> dict:
    return counting_priors(z_qsos, catalogue[0], catalogue[1],
                           cfg["prior_z_qso_increase_kms"] / 299792.458)


def cddf_spec() -> ref_cddf.CDDFSpec:
    return ref_cddf.CDDFSpec()


STATS = {"max": np.max, "mean": np.mean, "median": np.median}


def summarize(rows: dict) -> dict:
    """The widest, the mean and the median of every per-row gap:
    "<gap>.<max|mean|median>"."""
    return {f"{k}.{s}": float(f(v)) for k, v in rows.items() for s, f in STATS.items()}
