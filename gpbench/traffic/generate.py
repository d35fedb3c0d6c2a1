"""The one generator of the benchmark's traffic: a pool of synthetic
quasar sightlines, and the model and QMC samples they are read with.

A traffic mix is a data file ``gpbench/traffic/<mix>.json``::

    {"pool": {"n_sightlines", "z_qso": [lo, hi], "pixels": [lo, hi],
              "noise_sd", "masked_pixels", "dla_dndx", "max_dlas",
              "log_nhi": [lo, hi], "nhi_slope", "min_separation_factor",
              "omega_m"},
     "loop": {"call_size": n | null}}

``loop.call_size`` null: each call takes the whole pool; n: the next n
sightlines of the pool, cycling.  One caller waits for each call (a
closed loop).

Everything that depends on ``--seed`` is drawn on the run's device from
one ``torch.Generator`` seeded with it, in a few large calls: the
generating model's latent directions, then every sightline's redshift,
length, continuum draw, noise, masked pixels and absorbers.  The QMC
samples and the prior catalogue are the configuration's own and fixed.
Absorbers are placed Poisson in absorption distance X at ``dla_dndx``
(flat LCDM at ``omega_m``), uniform in X over each sightline's searchable
range, at most ``max_dlas``, with N_HI ~ N^nhi_slope; their profiles
come from the reference's physics, in float64 (the ±width-pixel
log-continuation the instrument's convolution reads included).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from gpbench.reference import physics
from gpbench.traffic import qmc

HERE = Path(__file__).resolve().parent


def load_mix(name: str, root: Path | None = None) -> dict:
    return json.loads(((root or HERE) / f"{name}.json").read_text())


def generating_model(cfg: dict, gen: torch.Generator, device) -> dict:
    """The GP the spectra are drawn from and read with: mu and omega as
    the configuration states, M (R, k) drawn from the seed."""
    m = cfg["model"]
    n = int(round((cfg["max_lambda"] - cfg["min_lambda"]) / cfg["dlambda"])) + 1
    grid = cfg["min_lambda"] + cfg["dlambda"] * np.arange(n)
    mu = (1.0 + m["mu_line_amplitude"] * np.exp(-0.5 * ((grid - 1215.67) / m["mu_line_width"]) ** 2)
          + m["mu_ripple"] * np.sin(grid / m["mu_ripple_scale"]))
    M = torch.randn((n, cfg["k"]), generator=gen, device=device, dtype=torch.float64) * m["M_scale"]
    return {"grid": grid, "mu": mu, "M": M.cpu().numpy(), "log_omega": np.full(n, math.log(m["omega"])),
            "log_c_0": math.log(m["c_0"]), "log_tau_0": math.log(m["tau_0"]),
            "log_beta": math.log(m["beta"])}


def qmc_samples(cfg: dict):
    """The configuration's (offsets, N_HI, log10 N_HI) QMC samples."""
    s = cfg["sampling"]
    rng = np.random.default_rng(s["catalogue_seed"])
    observed = rng.normal(s["catalogue_mean"], s["catalogue_sd"], s["catalogue_size"]).clip(
        *s["catalogue_clip"])
    off, lnhi = qmc.dla_samples(cfg["num_dla_samples"], observed, s["alpha"],
                                s["uniform_min_log_nhi"], s["uniform_max_log_nhi"],
                                s["fit_min_log_nhi"], s["fit_max_log_nhi"])
    return off, 10.0**lnhi, lnhi


def prior_catalogue(cfg: dict):
    """The configuration's prior catalogue: (z_qso, DLA count) of the
    quasars the counting priors read."""
    p = cfg["prior_catalogue"]
    rng = np.random.default_rng(p["seed"])
    z = rng.uniform(*p["z"], p["n"])
    return z, np.minimum(rng.poisson(p["dla_rate"], p["n"]), 2)


def _path_table(omega_m: float, z_max: float = 8.0, n: int = 80_001):
    z = np.linspace(0.0, z_max, n)
    y = (1.0 + z) ** 2 / np.sqrt(omega_m * (1.0 + z) ** 3 + 1.0 - omega_m)
    return z, np.concatenate([[0.0], np.cumsum(0.5 * (z[1] - z[0]) * (y[1:] + y[:-1]))])


def survey_pool(mix: dict, cfg: dict, gen: torch.Generator, device, chunk: int = 1024) -> dict:
    """The pool of sightlines: padded (n, P) float64 numpy arrays
    ``wavelengths``, ``flux``, ``noise_variance``, ``mask`` (bool),
    ``z_qso`` (n,), and ``n_dlas`` (n,), the absorbers injected."""
    p = mix["pool"]
    n, P = p["n_sightlines"], cfg["pixel_pad"]
    f64 = dict(dtype=torch.float64, device=device)
    model = cfg["_model"]
    lya, ll = physics.LYA_WAVELENGTH, physics.LYMAN_LIMIT

    z_qso = p["z_qso"][0] + (p["z_qso"][1] - p["z_qso"][0]) * torch.rand(n, generator=gen, **f64)
    n_px = torch.randint(p["pixels"][0], p["pixels"][1] + 1, (n,), generator=gen, device=device)
    j = torch.arange(P, device=device)
    lam = (911.9 * (1.0 + z_qso))[:, None] * torch.pow(10.0, 1e-4 * j.to(torch.float64))[None, :]
    # the continuum: mu and a draw of the latent directions M c, on the
    # rest-frame grid, interpolated (clamped) to each sightline's pixels
    coeffs = torch.randn((cfg["k"], n), generator=gen, **f64)
    latent = (torch.as_tensor(model["M"], **f64) @ coeffs).T          # (n, R)
    grid_mu = torch.as_tensor(model["mu"], **f64)
    R = grid_mu.shape[0]
    pos = torch.clamp((lam / (1.0 + z_qso[:, None]) - cfg["min_lambda"]) / cfg["dlambda"], 0.0, R - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, R - 2)
    t = pos - i0
    cont = (grid_mu[i0] * (1 - t) + grid_mu[i0 + 1] * t
            + torch.gather(latent, 1, i0) * (1 - t) + torch.gather(latent, 1, i0 + 1) * t)
    flux = cont + p["noise_sd"] * torch.randn((n, P), generator=gen, **f64)
    mask = j[None, :] < n_px[:, None]
    bad = torch.floor(torch.rand((n, p["masked_pixels"]), generator=gen, **f64) * n_px[:, None])
    mask.scatter_(1, bad.to(torch.int64), False)

    # absorbers, Poisson in X over the searchable range
    last = torch.gather(lam, 1, (n_px - 1)[:, None])[:, 0]
    zmin = torch.maximum(lam[:, 0] / lya - 1.0,
                         ll * (1.0 + z_qso) / lya - 1.0 + physics.kms_to_z(cfg["min_z_cut_kms"]))
    zmax = (torch.minimum(last, cfg["max_lambda"] * (1.0 + z_qso)) / lya - 1.0
            - physics.kms_to_z(cfg["max_z_cut_kms"]))
    zt, Xt = _path_table(p["omega_m"])
    zt_d, Xt_d = torch.as_tensor(zt, **f64), torch.as_tensor(Xt, **f64)
    to_x = lambda z: torch.as_tensor(np.interp(z.cpu().numpy(), zt, Xt), **f64)
    x_lo, x_hi = to_x(zmin), to_x(torch.maximum(zmax, zmin))
    n_dla = torch.clamp(torch.poisson(p["dla_dndx"] * (x_hi - x_lo), generator=gen),
                        max=p["max_dlas"]).to(torch.int64)
    tries = 8
    u = torch.rand((n, p["max_dlas"], tries), generator=gen, **f64)
    x_draw = x_lo[:, None, None] + (x_hi - x_lo)[:, None, None] * u
    idx = torch.clamp(torch.searchsorted(Xt_d, x_draw.contiguous()), 1, len(zt) - 1)
    w = (x_draw - Xt_d[idx - 1]) / (Xt_d[idx] - Xt_d[idx - 1])
    z_cand = zt_d[idx - 1] + w * (zt_d[idx] - zt_d[idx - 1])
    a_exp = 1.0 + p["nhi_slope"]
    lo, hi = 10.0 ** p["log_nhi"][0], 10.0 ** p["log_nhi"][1]
    nhi = (torch.rand((n, p["max_dlas"]), generator=gen, **f64) * (hi**a_exp - lo**a_exp)
           + lo**a_exp) ** (1.0 / a_exp)
    z_abs = z_cand[:, :, 0].clone()
    present = torch.arange(p["max_dlas"], device=device)[None, :] < n_dla[:, None]
    if p["max_dlas"] > 1:
        # later absorbers keep min_separation_factor x the model's minimum
        # separation from the first: the first candidate that does
        sep = math.log1p(p["min_separation_factor"] * physics.kms_to_z(cfg["min_separation_kms"]))
        far = torch.abs(torch.log1p(z_cand[:, 1:]) - torch.log1p(z_abs[:, :1, None])) > sep
        first = torch.argmax(far.to(torch.int64), dim=2)
        z_abs[:, 1:] = torch.gather(z_cand[:, 1:], 2, first[..., None])[..., 0]
        present[:, 1:] &= far.any(dim=2)
    hosts = torch.nonzero(present.any(dim=1))[:, 0]
    taps = physics.instrument_taps(cfg["instrument_width"], cfg["pixel_spacing"],
                                   cfg["resolving_power"])
    for c0 in range(0, len(hosts), chunk):
        rows = hosts[c0 : c0 + chunk]
        ext = physics.extend_wavelengths(lam[rows], cfg["instrument_width"], cfg["pixel_spacing"])
        col = torch.where(present[rows], nhi[rows], torch.zeros_like(nhi[rows]))
        absorbers = [(z_abs[rows, d : d + 1], col[:, d : d + 1]) for d in range(p["max_dlas"])]
        flux[rows] *= physics.absorption(ext, absorbers, cfg["num_lines"], taps)[:, 0]
    host = lambda a: a.cpu().numpy()
    return {
        "wavelengths": host(lam), "flux": host(flux),
        "noise_variance": np.full((n, P), p["noise_sd"] ** 2), "mask": host(mask),
        "z_qso": host(z_qso), "n_dlas": host(present.sum(dim=1)),
    }
