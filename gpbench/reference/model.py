"""The plain reference of the DLA model selection: the null, single-DLA
and two-DLA evidences, the MAP samples, the base redraw, the {0,1,2}
model posteriors and the CDDF inputs of one spectrum at a time.

Plain PyTorch (float64 by default), written from the mathematics of
Garnett et al. 2017 (process_qsos.m) and of the fused {0,1,2}-DLA chain
as the port states it, with nothing of the program imported:

- per spectrum: the GP model interpolated to the rest frame, the Lyman
  forest's scaling of omega^2, the pixels in the modelled range, the
  z_DLA search range (process_qsos.m:102-177);
- log N(y; mu a, (M a)(M a)' + diag(omega^2 a^2 + sigma^2)) of each
  sample's broadened absorption a, by Woodbury with a dense Cholesky
  (torch.linalg), on the full pixel grid (no window);
- the evidence max + log mean exp, the MAP sample;
- the base redraw: the inverse CDF of the single-DLA posterior at the
  shuffled grid u = (col + 0.5) / G, where col follows the R-replicated
  draw pattern of 256-column tiles (R = 4: 64 draws a tile);
- the pair evidences on the z-sorted fresh axis, pairs closer than the
  minimum separation left out;
- the CDDF reduction (cddf.py).

The control runs this at float32 with TF32 matrix products
(``Reference(..., dtype=torch.float32, tf32=True)``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import physics

LOG_2PI = math.log(2.0 * math.pi)
PATTERN_TILE = 256


@dataclass(frozen=True)
class ModelConfig:
    """The numbers of a configuration the reference needs."""

    k: int
    num_lines: int
    min_lambda: float
    max_lambda: float
    dlambda: float
    instrument_width: int
    pixel_spacing: float
    resolving_power: float
    min_z_cut_kms: float
    max_z_cut_kms: float
    prior_z_qso_increase_kms: float
    min_separation_kms: float = 3000.0
    base_replicates: int = 4
    base_seed: int = 0

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelConfig":
        return cls(**{f: cfg[f] for f in cls.__dataclass_fields__ if f in cfg})

    def rest_grid(self) -> np.ndarray:
        n = int(round((self.max_lambda - self.min_lambda) / self.dlambda)) + 1
        return self.min_lambda + self.dlambda * np.arange(n)


def counting_priors(z_qsos, prior_z, prior_num, increase_z):
    """log p(0 DLA), log p(>= 1 DLA but not 2), log p(2 DLA) and the
    single model's log p(DLA): among prior quasars with z < z_qso + dz,
    the fractions with no, one and two DLAs (process_qsos.m:122-132)."""
    order = np.argsort(prior_z, kind="stable")
    zs = np.asarray(prior_z)[order]
    num = np.asarray(prior_num)[order]
    ge1 = np.concatenate([[0], np.cumsum(num >= 1)])
    ge2 = np.concatenate([[0], np.cumsum(num >= 2)])
    counts = np.searchsorted(zs, np.asarray(z_qsos) + increase_z, side="left")
    n1, n2 = ge1[counts], ge2[counts]
    safe = np.maximum(counts, 1)
    with np.errstate(divide="ignore"):
        lp_dla = np.where(counts > 0, np.log(n1) - np.log(safe), -np.inf)
        lp_no = np.where(counts > 0, np.log(counts - n1) - np.log(safe), 0.0)
        lp1 = np.where(counts > 0, np.log(n1 - n2) - np.log(safe), -np.inf)
        lp2 = np.where(counts > 0, np.log(n2) - np.log(safe), -np.inf)
    return {"lp_no": lp_no, "lp_dla": lp_dla, "lp0m": lp_no, "lp1m": lp1, "lp2m": lp2}


def softmax_rows(logits: np.ndarray) -> np.ndarray:
    m = np.max(logits, axis=-1, keepdims=True)
    e = np.exp(logits - m)
    return e / e.sum(axis=-1, keepdims=True)


def pair_columns(offsets: np.ndarray, replicates: int, base_seed: int, sorted_axis: bool):
    """The pair stage's columns: (order, cols, G).  Column p pairs the
    fresh sample order[p] (order is None: p itself) with the base draw
    at u = (cols[p] + 0.5) / G."""
    S = len(offsets)
    order = np.argsort(offsets, kind="stable") if sorted_axis else None
    if replicates == 1:
        perm = np.random.default_rng(base_seed).permutation(S)
        return order, (perm if order is None else perm[order]), S
    width = PATTERN_TILE // replicates
    pos = np.arange(S)
    draw_idx = (pos // PATTERN_TILE) * width + (pos % PATTERN_TILE) % width
    G = int(draw_idx.max()) + 1
    return order, np.random.default_rng(base_seed).permutation(G)[draw_idx], G


class Reference:
    """The reference evaluation of given spectra under one model and one
    set of QMC samples, at ``dtype`` on ``device``."""

    def __init__(self, cfg: ModelConfig, model: dict, offsets, nhis, device="cpu",
                 dtype=torch.float64, tf32: bool = False, chunk: int = 2500,
                 sorted_axis: bool = True):
        self.cfg, self.dtype, self.device, self.tf32 = cfg, dtype, torch.device(device), tf32
        self.chunk = chunk
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(dtype)
        self.grid = cfg.rest_grid()
        self.mu, self.M, self.log_omega = t(model["mu"]), t(model["M"]), t(model["log_omega"])
        self.log_c_0 = float(model["log_c_0"])
        self.log_tau_0 = float(model["log_tau_0"])
        self.log_beta = float(model["log_beta"])
        self.offsets_np = np.asarray(offsets, np.float64)
        self.nhis_np = np.asarray(nhis, np.float64)
        self.offsets, self.nhis = t(offsets), t(nhis)
        self.taps = physics.instrument_taps(
            cfg.instrument_width, cfg.pixel_spacing, cfg.resolving_power
        )
        iu, ju = np.triu_indices(cfg.k)
        self._iu, self._ju = torch.as_tensor(iu, device=self.device), torch.as_tensor(ju, device=self.device)
        self.order, self.cols, self.G = pair_columns(
            self.offsets_np, cfg.base_replicates, cfg.base_seed, sorted_axis
        )

    def t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    # ---- one spectrum ----

    def prepare(self, wavelengths, flux, noise_variance, mask, z_qso) -> dict:
        """The model on one spectrum's pixels (process_qsos.m:102-177)."""
        cfg = self.cfg
        lam, y, nv = self.t(wavelengths), self.t(flux), self.t(noise_variance)
        rest = lam / (1.0 + float(z_qso))
        valid = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        valid = valid & (rest >= cfg.min_lambda) & (rest <= cfg.max_lambda)
        n = len(self.grid)
        pos = (rest - cfg.min_lambda) / cfg.dlambda
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
        frac = pos - i0.to(self.dtype)
        lerp = lambda f: f[i0] * (1.0 - frac) + f[i0 + 1] * frac
        lerp_cols = lambda f: f[i0] * (1.0 - frac)[:, None] + f[i0 + 1] * frac[:, None]
        mu, log_omega, M = lerp(self.mu), lerp(self.log_omega), lerp_cols(self.M)
        z_lya = (lam - physics.LYA_WAVELENGTH) / physics.LYA_WAVELENGTH
        scaling = (1.0 - torch.exp(-math.exp(self.log_tau_0) * (1.0 + z_lya) ** math.exp(self.log_beta))
                   + math.exp(self.log_c_0))
        omega2 = torch.exp(2.0 * log_omega) * scaling**2
        lam_valid = lam[valid]
        wmin, wmax = float(lam_valid.min()), float(lam_valid.max())
        min_z = max(
            wmin / physics.LYA_WAVELENGTH - 1.0,
            physics.LYMAN_LIMIT * (1.0 + float(z_qso)) / physics.LYA_WAVELENGTH - 1.0
            + physics.kms_to_z(cfg.min_z_cut_kms),
        )
        max_z = wmax / physics.LYA_WAVELENGTH - 1.0 - physics.kms_to_z(cfg.max_z_cut_kms)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return {
            "y": torch.where(valid, y, zero), "nv": torch.where(valid, nv, zero),
            "mu": torch.where(valid, mu, zero), "omega2": torch.where(valid, omega2, zero),
            "M": M, "valid": valid, "min_z": min_z, "max_z": max_z,
            "ext": physics.extend_wavelengths(lam, cfg.instrument_width, cfg.pixel_spacing),
            "pair_products": M[:, self._iu] * M[:, self._ju],
        }

    def log_likelihoods(self, prep: dict, a):
        """log N(y; mu a, (M a)(M a)' + diag(omega^2 a^2 + sigma^2)) for
        each row of absorption profiles a (C, P): (C,)."""
        valid = prep["valid"]
        one = torch.ones((), dtype=self.dtype, device=self.device)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        d = torch.where(valid, prep["omega2"] * a * a + prep["nv"], one)
        inv_d = torch.where(valid, 1.0 / d, zero)
        yc = torch.where(valid, prep["y"] - prep["mu"] * a, zero)
        w = a * a * inv_d
        u = a * yc * inv_d
        quad0 = torch.sum(yc * yc * inv_d, dim=-1)
        logdet_d = torch.sum(torch.where(valid, torch.log(d), zero), dim=-1)
        k = self.cfg.k
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            tri = torch.matmul(w, prep["pair_products"])          # (C, k(k+1)/2)
            b = torch.matmul(u, prep["M"])                        # (C, k)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        G = torch.zeros((a.shape[0], k, k), dtype=self.dtype, device=self.device)
        G[:, self._iu, self._ju] = tri
        G[:, self._ju, self._iu] = tri
        G = G + torch.eye(k, dtype=self.dtype, device=self.device)
        L = torch.linalg.cholesky(G)
        z = torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
        logdet_G = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        n_eff = valid.sum().to(self.dtype)
        return -0.5 * (quad0 - torch.sum(z * z, dim=-1) + logdet_d + logdet_G + n_eff * LOG_2PI)

    def null(self, prep: dict) -> float:
        ones = torch.ones((1, prep["y"].shape[0]), dtype=self.dtype, device=self.device)
        return float(self.log_likelihoods(prep, ones)[0])

    def _z(self, prep, offsets):
        return prep["min_z"] + (prep["max_z"] - prep["min_z"]) * offsets

    def optical_depths(self, prep: dict):
        """N_HI times the optical depth of every sample on the spectrum's
        extended grid, (S, P6): what each pair adds up again."""
        out = []
        for c0 in range(0, len(self.offsets_np), self.chunk):
            z = self._z(prep, self.offsets[c0 : c0 + self.chunk])
            od = physics.optical_depth(prep["ext"], z, self.cfg.num_lines)
            out.append(self.nhis[c0 : c0 + self.chunk, None] * od)
        return torch.cat(out)

    def sample_lls(self, prep: dict, fresh=None, base=None):
        """Log likelihoods of the single-DLA samples ``fresh`` (index
        tensor, default all in original order) or, with ``base``, of the
        pairs (fresh[p], base[p]).  With ``prep["tau"]`` (``single``
        keeps the optical depths there for the pair stage) the samples'
        optical depths are taken from it, the same numbers."""
        if fresh is None:
            fresh = torch.arange(len(self.offsets_np), device=self.device)
        tau = prep.get("tau")
        out = []
        for c0 in range(0, len(fresh), self.chunk):
            f = fresh[c0 : c0 + self.chunk]
            b = None if base is None else base[c0 : c0 + self.chunk]
            if tau is not None:
                t = tau[f] if b is None else tau[f] + tau[b]
                a = physics.broaden(torch.exp(-t), self.taps)
            else:
                absorbers = [(self._z(prep, self.offsets[f]), self.nhis[f])]
                if b is not None:
                    absorbers.append((self._z(prep, self.offsets[b]), self.nhis[b]))
                a = physics.absorption(prep["ext"], absorbers, self.cfg.num_lines, self.taps)
            out.append(self.log_likelihoods(prep, a))
        return torch.cat(out)

    def redraw(self, sll):
        """The base draws of the pair columns: the inverse CDF of the
        single-DLA posterior at u = (cols + 0.5) / G (searchsorted left)."""
        finite = torch.where(torch.isnan(sll), torch.full_like(sll, -math.inf), sll)
        top = torch.amax(finite)
        w = torch.exp(finite - (top if torch.isfinite(top) else 0.0))
        if float(w.sum()) == 0.0:
            w = torch.ones_like(w)
        cdf = torch.cumsum(w, 0)
        cdf = cdf / cdf[-1]
        u = torch.as_tensor((self.cols + 0.5) / self.G, device=self.device).to(self.dtype)
        return torch.clamp(torch.searchsorted(cdf, u, side="left"), 0, len(sll) - 1)

    @staticmethod
    def evidence(lls):
        top = torch.amax(lls)
        return float(top + torch.log(torch.mean(torch.exp(lls - top))))

    def single(self, prep: dict, keep_tau: bool = False) -> dict:
        """The null and single-DLA stage; ``keep_tau`` leaves the samples'
        optical depths in ``prep["tau"]`` for the pair stage."""
        if keep_tau:
            prep["tau"] = self.optical_depths(prep)
        sll = self.sample_lls(prep)
        finite = torch.where(torch.isnan(sll), torch.full_like(sll, -math.inf), sll)
        return {"ll_null": self.null(prep), "sll": sll, "ev1": self.evidence(sll),
                "map1": int(torch.argmax(finite)) if torch.isfinite(finite.max()) else 0,
                "min_z": prep["min_z"], "max_z": prep["max_z"]}

    def pair_lls(self, prep: dict, fresh, base):
        """Log likelihoods of the pairs (fresh[p], base[p]); NaN where the
        two lie closer than the minimum separation."""
        ll2 = self.sample_lls(prep, fresh, base)
        z1, z2 = self._z(prep, self.offsets[fresh]), self._z(prep, self.offsets[base])
        sep = math.log1p(physics.kms_to_z(self.cfg.min_separation_kms))
        return torch.where(torch.abs(torch.log1p(z1) - torch.log1p(z2)) < sep,
                           torch.full_like(ll2, math.nan), ll2)

    def pair(self, prep: dict, sll) -> dict:
        """The pair stage of one spectrum from its single-DLA samples."""
        S = len(self.offsets_np)
        fresh = torch.arange(S, device=self.device)
        if self.order is not None:
            fresh = torch.as_tensor(self.order, device=self.device)
        base = self.redraw(sll)
        ll2 = self.pair_lls(prep, fresh, base)
        valid = torch.isfinite(ll2)
        out = {"ll2": ll2, "base": base, "fresh": fresh}
        if not bool(valid.any()):
            return {**out, "ev2": math.nan, "map2": -1, "map_base": -1}
        neg = torch.where(valid, ll2, torch.full_like(ll2, -math.inf))
        top = torch.amax(neg)
        ev2 = float(top + torch.log(torch.sum(torch.where(valid, torch.exp(ll2 - top), 0.0))
                                    / valid.sum()))
        p = int(torch.argmax(neg))
        return {**out, "ev2": ev2, "map2": int(fresh[p]), "map_base": int(base[p])}
