"""The plain reference of the CDDF inputs of one spectrum: the binned
sample masses on the (z, log N_HI) grids and the exact extremes.

The reduction the fused chain states (the port's ``CDDFReductionSpec``
defaults, calc_cddf.py:42-56 and 440-560), written again in float64 with
plain scatter-adds from the reference's own evidences and draws, in the
program's layout: ``ex`` = [the top_k largest p | their samples | the
top_k largest p2 | their fresh samples | their base draws | window start,
count of p >= p_switch, of p2 >= p_switch, mass outside the window].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

N_CHANNELS = 8
CH_SMALL_B, CH_SMALL2_B = 5, 7


@dataclass(frozen=True)
class CDDFSpec:
    z_bins_per_unit: int = 6
    n_z_window: int = 12
    lnhi_a_start: float = 20.0
    lnhi_a_width: float = 0.1
    lnhi_b_start: float = 20.3
    lnhi_b_width: float = 0.09
    n_lnhi: int = 30
    top_k: int = 8
    p_sample_min: float = 1e-4
    p_switch: float = 0.25
    nu_log_offset: float = 20.0

    def lnhi_bin(self, lnhi: np.ndarray, grid: str) -> np.ndarray:
        start, width = ((self.lnhi_a_start, self.lnhi_a_width) if grid == "a"
                        else (self.lnhi_b_start, self.lnhi_b_width))
        idx = np.floor((lnhi - start) / width).astype(np.int64)
        end = start + width * self.n_lnhi
        return np.where((lnhi > start) & (lnhi < end), np.clip(idx, 0, self.n_lnhi - 1), self.n_lnhi)


def _first_dla(spec: CDDFSpec, offsets, single: dict, priors: dict):
    """(p, log w, z, w0): each sample's first-DLA mass p = w p(DLA), its
    log weight, its absorber redshift, and the window's first z bin."""
    f64 = torch.float64
    sll = single["sll"].to(f64)
    a = priors["lp_no"] + single["ll_null"]
    b = priors["lp_dla"] + single["ev1"]
    m = max(a, b)
    e0, e1 = math.exp(a - m), math.exp(b - m)
    p_dla = 1.0 - e0 / (e0 + e1)
    p_dla = 0.0 if math.isnan(p_dla) else p_dla
    top = torch.amax(sll)
    norm = top + torch.log(torch.mean(torch.exp(sll - top)))
    logw = sll - norm - math.log(sll.shape[0])
    p = torch.nan_to_num(torch.exp(logw) * p_dla, nan=0.0)
    off = torch.as_tensor(np.asarray(offsets, np.float64), device=sll.device)
    zf = single["min_z"] + (single["max_z"] - single["min_z"]) * off
    return p, logw, zf, math.floor(single["min_z"] * spec.z_bins_per_unit)


def reduce_row(spec: CDDFSpec, offsets, log_nhis, single: dict, pair: dict, priors: dict):
    """(hist (8, n_z_window, n_lnhi + 1), ex (5 top_k + 4,)) of one
    spectrum, float64 numpy.  ``single``/``pair``: the reference's own
    stages (sll in original sample order; ll2, base and fresh per pair
    column); ``pair`` None: the first-DLA channels and extremes alone,
    the second-DLA ones 0 and -1.  ``priors``: this spectrum's counting
    priors."""
    f64, dev = torch.float64, single["sll"].device
    put = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    S = single["sll"].shape[0]
    W, nl, K = spec.n_z_window, spec.n_lnhi, spec.top_k

    p, logw, zf, w0 = _first_dla(spec, offsets, single, priors)
    zloc = torch.floor(zf * spec.z_bins_per_unit).to(torch.int64) - w0
    in_win = (zloc >= 0) & (zloc < W)
    z_over = int(((~in_win) & (p > 0)).sum())
    ex1 = torch.sort(p, descending=True, stable=True)
    nbig1 = int((p >= spec.p_switch).sum())

    K2 = torch.full((K,), -1.0, dtype=f64, device=dev)
    if pair is None:
        p2, ex2_parts, nbig2 = torch.zeros_like(p), [K2 * 0.0, K2, K2], 0
    else:
        posts = np.array([priors["lp0m"] + single["ll_null"], priors["lp1m"] + single["ev1"],
                          priors["lp2m"] + pair["ev2"]])
        e = np.exp(posts - np.max(posts))
        p_dla2 = float(e[2] / e.sum())
        p_dla2 = 0.0 if math.isnan(p_dla2) else p_dla2
        comb = pair["ll2"].to(f64) + logw[pair["fresh"]]
        comb = torch.where(torch.isfinite(comb), comb, torch.full_like(comb, -math.inf))
        cmax = torch.amax(comb)
        safe = cmax if torch.isfinite(cmax) else torch.zeros((), dtype=f64, device=dev)
        lse = safe + torch.log(torch.exp(comb - safe).sum())
        p2 = torch.nan_to_num(torch.exp(comb - lse) * p_dla2, nan=0.0)
        ex2 = torch.sort(p2, descending=True, stable=True)
        cols2 = ex2.indices[:K]
        ex2_parts = [ex2.values[:K], pair["fresh"][cols2], pair["base"][cols2]]
        nbig2 = int((p2 >= spec.p_switch).sum())

    small1 = (p > spec.p_sample_min) & (p < spec.p_switch)
    ps = torch.where(small1, p, 0.0)
    pvar = p * torch.clamp(1.0 - p, min=0.0)
    small2 = (p2 > spec.p_sample_min) & (p2 < spec.p_switch)
    acc = torch.zeros(S, dtype=f64, device=dev)
    if pair is not None:
        acc.scatter_add_(0, pair["base"], torch.where(small2, p2, 0.0))
    nu = put(10.0 ** (np.asarray(log_nhis, np.float64) - spec.nu_log_offset))
    vals = torch.stack([ps, p, p * nu, pvar, pvar * nu * nu, ps, acc, acc])        # (8, S)
    lh_a = put(spec.lnhi_bin(np.asarray(log_nhis, np.float64), "a")).to(torch.int64)
    lh_b = put(spec.lnhi_bin(np.asarray(log_nhis, np.float64), "b")).to(torch.int64)
    hist = torch.zeros((N_CHANNELS, W * (nl + 1) + 1), dtype=f64, device=dev)
    for ch in range(N_CHANNELS):
        lh = lh_b if ch in (CH_SMALL_B, CH_SMALL2_B) else lh_a
        flat = torch.where(in_win, zloc * (nl + 1) + lh, torch.full_like(zloc, W * (nl + 1)))
        hist[ch].scatter_add_(0, flat, vals[ch])
    hist = hist[:, : W * (nl + 1)].reshape(N_CHANNELS, W, nl + 1)
    host = lambda t: t.double().cpu().numpy()
    ex = np.concatenate([host(ex1.values[:K]), host(ex1.indices[:K])]
                        + [host(t) for t in ex2_parts] + [[w0, nbig1, nbig2, z_over]])
    return hist.cpu().numpy(), ex


def first_dla_bounds(spec: CDDFSpec, offsets, log_nhis, single: dict, priors: dict,
                     p_rel: float, z_abs: float):
    """(lo, hi), each (6, n_z_window, n_lnhi + 1): the first-DLA channels
    0-5 of ``reduce_row``'s histogram as an interval per cell.

    The masses and redshifts a float32 run computes are the reference's
    within rounding, and the histogram cuts them: a sample whose mass
    lies within ``p_rel`` (relative) of p_sample_min or p_switch may fall
    on either side of that cut (channels 0 and 5), and one whose redshift
    lies within ``z_abs`` of a bin edge in either bin.  ``lo`` sums what
    a cell holds for certain, ``hi`` what it may hold."""
    f64, dev = torch.float64, single["sll"].device
    put = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    W, nl = spec.n_z_window, spec.n_lnhi
    p, _, zf, w0 = _first_dla(spec, offsets, single, priors)
    bpz = spec.z_bins_per_unit
    z_lo = torch.floor((zf - z_abs) * bpz).to(torch.int64) - w0
    z_hi = torch.floor((zf + z_abs) * bpz).to(torch.int64) - w0

    def cut(low, high):
        return (p > spec.p_sample_min * low) & (p < spec.p_switch * high)

    sure_in, may_in = cut(1.0 + p_rel, 1.0 - p_rel), cut(1.0 - p_rel, 1.0 + p_rel)
    every = torch.ones_like(sure_in)
    nu = put(10.0 ** (np.asarray(log_nhis, np.float64) - spec.nu_log_offset))
    pvar = p * torch.clamp(1.0 - p, min=0.0)
    vals = torch.stack([p, p, p * nu, pvar, pvar * nu * nu, p])       # (6, S)
    lh_a = put(spec.lnhi_bin(np.asarray(log_nhis, np.float64), "a")).to(torch.int64)
    lh_b = put(spec.lnhi_bin(np.asarray(log_nhis, np.float64), "b")).to(torch.int64)
    lo = torch.zeros((6, W * (nl + 1) + 1), dtype=f64, device=dev)
    hi = torch.zeros_like(lo)
    zero = torch.zeros((), dtype=f64, device=dev)
    for ch in range(6):
        lh = lh_b if ch == CH_SMALL_B else lh_a
        flat = lambda z: torch.where((z >= 0) & (z < W), z * (nl + 1) + lh,
                                     torch.full_like(z, W * (nl + 1)))
        sure, may = (sure_in, may_in) if ch in (0, CH_SMALL_B) else (every, every)
        lo[ch].scatter_add_(0, flat(z_lo), torch.where(sure & (z_lo == z_hi), vals[ch], zero))
        hi[ch].scatter_add_(0, flat(z_lo), torch.where(may, vals[ch], zero))
        hi[ch].scatter_add_(0, flat(z_hi), torch.where(may & (z_hi != z_lo), vals[ch], zero))
    shape = (6, W, nl + 1)
    return (lo[:, : W * (nl + 1)].reshape(shape).cpu().numpy(),
            hi[:, : W * (nl + 1)].reshape(shape).cpu().numpy())
