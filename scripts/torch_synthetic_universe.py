"""Synthetic-universe science check of the PyTorch port, on the card.

The counterpart of ``validation/synthetic_universe.py``.  Injects DLAs
into synthetic quasar spectra at a KNOWN line density and column-density
distribution, runs the port's inference (``process_spectra_sharded``;
``--multi``: ``process_spectra_multi_sharded``, the classic {0,1,2}-DLA
flow) with no device, dtype or backend named (the card, float32, the
kernels) and the analysis layer, and holds the recovered detections,
dN/dX and pair redshifts to the injected truth with the JAX harness's
assertions, unchanged:

- single (512 spectra, dN/dX = 0.12, seed 12): completeness > 0.85,
  false positives <= max(2, 2 %), the recovered DLA count in z = [2.0,
  3.4] within max(15 %, 2 sigma) of the injected count there;
- multi (256 spectra, dN/dX = 0.35, seed 21): >= 1-DLA detection rate >
  0.85, 2-DLA classification rate > 0.7, false positives <= max(2, 2 %)
  of the clean sightlines, the best pair's median |dz| < 0.01.

The universe is the JAX harness's, draw for draw (the same numpy draws
in the same order); the absorption profiles come from the port's
``ops.voigt.voigt_absorption`` on the run's device and dtype.  The
report goes to stdout (the JAX harness writes ``validation/RESULTS*.md``;
this one writes nothing) and ends with ``UNIVERSE {json}``.

Run:  python scripts/torch_synthetic_universe.py [--multi] [--n-spectra N]
      [--rate R]
The card by default (float32, the kernels); a default run that finds no
card raises.  ``--device cpu`` (float32, the plain path) is for the
tests, which hold the float64 plain path to JAX's through
``infer_single`` and ``infer_multi``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for path in (REPO, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from torch_scale_rehearsal import launch_counts  # noqa: E402

LYA = 1215.6701
LYMAN_LIMIT = 911.7633
P_PIXELS = 1280
NOISE_SD = 0.1


@dataclass
class Universe:
    """A synthetic universe as the JAX harness builds it: the generating
    model's arrays, the spectra, the QMC samples, the prior catalogue and
    the injected truth (single: [(row, z, log10 N_HI)]; multi: {row:
    [(z, log10 N_HI), ...]})."""

    params: object
    model: dict
    spectra: object
    samples: object
    prior_z: np.ndarray
    prior: np.ndarray         # DLA flags (single) or DLA counts (multi)
    injected: object


def generating_model(rng, params) -> dict:
    """The generating ("true") quasar emission model (one ``rng.normal``
    draw of (R, 20))."""
    grid = params.null_model.rest_wavelengths()
    return {
        "rest_wavelengths": grid,
        "mu": 1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2) + 0.1 * np.sin(grid / 60.0),
        "M": rng.normal(size=(grid.size, 20)) * 0.04,
        "log_omega": np.log(0.12 + 0 * grid),
        "log_c_0": np.log(0.1),
        "log_tau_0": np.log(0.0023),
        "log_beta": np.log(3.65),
    }


def _absorption(lam_row, z_dla, nhi, params, device, dtype):
    """The port's Voigt absorption of one absorber on one sightline's
    grid (extended by the convolution's margins), on ``device`` at
    ``dtype``, as float64 numpy."""
    import torch

    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption

    ext = torch.as_tensor(extend_wavelengths(lam_row, params.instrument), device=device).to(dtype)
    scalar = lambda x: torch.tensor(x, device=device, dtype=dtype)
    profile = voigt_absorption(ext, scalar(z_dla), scalar(nhi), num_lines=3)
    return profile.cpu().numpy().astype(np.float64)


def _search_range(lam_row, z_qso, params, path):
    """(zmin, zmax, dX) of the searchable range: the engine's search tops
    out at the last MODELLED pixel (rest <= max_lambda), not the last
    pixel of the grid."""
    zmin = max(lam_row[0] / LYA - 1, LYMAN_LIMIT * (1 + z_qso) / LYA - 1 + params.min_z_cut)
    lam_search_max = min(lam_row[-1], params.null_model.max_lambda * (1 + z_qso))
    zmax = lam_search_max / LYA - 1 - params.max_z_cut
    return zmin, zmax, float(path(zmin, zmax))


def _log_nhi_draw(rng) -> float:
    """N_HI ~ N^-1.8 on [10^20.3, 10^22.0] (one ``rng.uniform``)."""
    a = 1.0 - 1.8
    nlo, nhi_ = 10**20.3, 10**22.0
    return (rng.uniform() * (nhi_**a - nlo**a) + nlo**a) ** (1 / a)


def _sightlines(rng, n_spectra: int):
    z_qso = rng.uniform(2.4, 3.4, n_spectra)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P_PIXELS))[None, :]
    return z_qso, lam


def build_single(n_spectra: int = 512, rate_dndx: float = 0.12, seed: int = 12,
                 device="cpu", dtype=None) -> Universe:
    """The JAX harness's ``main`` universe: at most one DLA a sightline,
    constant dN/dX, uniform in X over the searchable range."""
    import torch

    from gp_dla_detection_tpu_torch.analysis import AbsorptionPath
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters
    from gp_dla_detection_tpu_torch.samples import generate_dla_samples

    dtype = dtype or torch.float64
    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=20))
    grid = params.null_model.rest_wavelengths()
    model = generating_model(rng, params)
    z_qso, lam = _sightlines(rng, n_spectra)
    path = AbsorptionPath()
    injected = []
    flux = np.empty((n_spectra, P_PIXELS))
    for i in range(n_spectra):
        rest = lam[i] / (1 + z_qso[i])
        mu_i = np.interp(rest, grid, model["mu"])
        latent = np.interp(rest, grid, model["M"] @ rng.normal(size=20))
        f = mu_i + latent + rng.normal(0, NOISE_SD, P_PIXELS)
        zmin, zmax, dX = _search_range(lam[i], z_qso[i], params, path)
        n_dla = min(rng.poisson(rate_dndx * dX), 1)   # the model selects 0 or 1 DLA
        if n_dla:
            # uniform in X within the searchable range
            u = rng.uniform()
            zgrid = np.linspace(zmin, zmax, 4001)
            cdf = path(zmin, zgrid) / dX
            z_dla = float(np.interp(u, cdf, zgrid))
            nhi = _log_nhi_draw(rng)
            f *= _absorption(lam[i], z_dla, nhi, params, device, dtype)
            injected.append((i, z_dla, np.log10(nhi)))
        flux[i] = f
    spectra = PaddedSpectra(lam, flux, np.full((n_spectra, P_PIXELS), NOISE_SD**2),
                            np.ones((n_spectra, P_PIXELS), bool), z_qso)
    # QMC prior samples from a synthetic concordance catalogue
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)
    # a flat, neutral DLA-rate prior catalogue (p ~ 0.1)
    prior_z = rng.uniform(2.2, 3.6, 5000)
    prior_f = rng.uniform(size=5000) < 0.1
    return Universe(params, model, spectra, samples, prior_z, prior_f, injected)


def build_multi(n_spectra: int = 256, rate_dndx: float = 0.35, seed: int = 21,
                device="cpu", dtype=None) -> Universe:
    """The JAX harness's ``main_multi`` universe: up to two DLAs a
    sightline, at least three times the model's 3,000 km/s minimum
    separation apart."""
    import torch

    from gp_dla_detection_tpu_torch.analysis import AbsorptionPath
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters, kms_to_z
    from gp_dla_detection_tpu_torch.samples import generate_dla_samples

    dtype = dtype or torch.float64
    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=20))
    grid = params.null_model.rest_wavelengths()
    model = generating_model(rng, params)
    z_qso, lam = _sightlines(rng, n_spectra)
    path = AbsorptionPath()
    min_sep = float(kms_to_z(3000.0)) * 3  # comfortably outside the NaN cut
    injected: dict[int, list] = {}
    flux = np.empty((n_spectra, P_PIXELS))
    for i in range(n_spectra):
        rest = lam[i] / (1 + z_qso[i])
        f = (np.interp(rest, grid, model["mu"])
             + np.interp(rest, grid, model["M"] @ rng.normal(size=20))
             + rng.normal(0, NOISE_SD, P_PIXELS))
        zmin, zmax, dX = _search_range(lam[i], z_qso[i], params, path)
        n_dla = min(rng.poisson(rate_dndx * dX), 2)
        zs: list[float] = []
        zgrid = np.linspace(zmin, zmax, 4001)
        cdf = path(zmin, zgrid) / dX
        for _ in range(n_dla):
            for _attempt in range(20):
                z_dla = float(np.interp(rng.uniform(), cdf, zgrid))
                if all(abs(np.log1p(z_dla) - np.log1p(z0)) > np.log1p(min_sep) for z0 in zs):
                    break
            else:
                continue
            zs.append(z_dla)
            nhi = _log_nhi_draw(rng)
            f *= _absorption(lam[i], z_dla, nhi, params, device, dtype)
            injected.setdefault(i, []).append((z_dla, np.log10(nhi)))
        flux[i] = f
    spectra = PaddedSpectra(lam, flux, np.full((n_spectra, P_PIXELS), NOISE_SD**2),
                            np.ones((n_spectra, P_PIXELS), bool), z_qso)
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)
    prior_z = rng.uniform(2.2, 3.6, 5000)
    prior_num = np.minimum(rng.poisson(0.35, 5000), 2)
    return Universe(params, model, spectra, samples, prior_z, prior_num, injected)


def gp_model(u: Universe, device=None, dtype=None):
    """The generating model as the port's ``GPModel`` on ``device`` (the
    card by default) at ``dtype`` (float32 by default)."""
    import torch

    from gp_dla_detection_tpu_torch.models.qso_model import GPModel

    m = u.model
    return GPModel.from_numpy(m["rest_wavelengths"], m["mu"], m["M"], m["log_omega"],
                              m["log_c_0"], m["log_tau_0"], m["log_beta"], device=device,
                              dtype=dtype or torch.float32)


def run_config(per_device_batch: int, device=None, dtype=None):
    """The drivers' config: with nothing named, the card, float32 and the
    kernels (``ShardedRunConfig``'s defaults)."""
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig

    kw = {} if device is None else {"device": device}
    if dtype is not None:
        kw["dtype"] = dtype
    return ShardedRunConfig(per_device_batch=per_device_batch, sample_chunk=2500, **kw)


def infer_single(u: Universe, spectra=None, device=None, dtype=None):
    """``process_spectra_sharded`` on the universe's spectra (or
    ``spectra``), batch min(256, N)."""
    import torch

    from gp_dla_detection_tpu_torch.parallel import process_spectra_sharded

    spectra = spectra or u.spectra
    n = len(spectra.z_qso)
    torch_dtype = None if dtype is None else getattr(torch, dtype)
    return process_spectra_sharded(
        gp_model(u, device, torch_dtype), u.samples.offset_samples, u.samples.nhi_samples,
        spectra, u.prior_z, u.prior, params=u.params,
        config=run_config(min(256, n), device, dtype))


def infer_multi(u: Universe, spectra=None, device=None, dtype=None):
    """``process_spectra_multi_sharded`` (the classic flow) on the
    universe's spectra (or ``spectra``), batch min(64, N)."""
    import torch

    from gp_dla_detection_tpu_torch.parallel import process_spectra_multi_sharded

    spectra = spectra or u.spectra
    n = len(spectra.z_qso)
    torch_dtype = None if dtype is None else getattr(torch, dtype)
    return process_spectra_multi_sharded(
        gp_model(u, device, torch_dtype), u.samples.offset_samples, u.samples.nhi_samples,
        spectra, u.prior_z, u.prior, params=u.params,
        config=run_config(min(64, n), device, dtype))


def recovered_dla_total(cat, z_cent, dNdX, z_lo, z_hi) -> float:
    """A line_density result integrated back to a recovered DLA count
    (``validation/_universe.py``'s helper).  line_density DROPS zero-path
    bins, so each returned center's bin edges come from the full grid it
    binned on."""
    nbins = max(int((z_hi - z_lo) * cat.bins_per_z), 1)
    width = (z_hi - z_lo) / nbins
    return float(sum(dNdX[b] * cat.path_length(zc - width / 2, zc + width / 2)
                     for b, zc in enumerate(z_cent)))


def build_kernels(device) -> float:
    """Seconds to build (or find built) the kernels the path runs on a
    CUDA ``device``, before the inference is timed."""
    import torch

    from gp_dla_detection_tpu_torch import _build

    if torch.device(device).type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    for name in ("evidence", "null_evidence"):
        _build.load_library(name)
    return time.perf_counter() - t0


def on_label(device) -> str:
    import torch

    if device is None or torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return str(device)


def main(n_spectra: int = 512, rate_dndx: float = 0.12, seed: int = 12, device=None) -> dict:
    """The single-DLA universe through the port; its report, assertions
    and ``UNIVERSE {json}`` line."""
    import torch

    from gp_dla_detection_tpu_torch.analysis import DLACatalogue
    from gp_dla_detection_tpu_torch.runtime import default_device

    dev = default_device(device)
    t0 = time.perf_counter()
    u = build_single(n_spectra, rate_dndx, seed, dev, torch.float32)
    build_s = time.perf_counter() - t0
    nvcc_s = build_kernels(dev)
    t0 = time.perf_counter()
    results = infer_single(u, device=device)
    wall = time.perf_counter() - t0
    samples = u.samples
    cat = DLACatalogue(results.p_dlas, results.min_z_dlas, results.max_z_dlas,
                       results.sample_log_likelihoods_dla, results.log_likelihoods_dla,
                       samples.offset_samples, samples.log_nhi_samples)

    # --- truth vs recovery
    injected = u.injected
    n_inj = len(injected)
    detections = results.p_dlas > 0.9
    inj_idx = np.array([i for i, _, _ in injected], dtype=int)
    tp = int(detections[inj_idx].sum())
    fp = int(detections.sum() - tp)
    # dN/dX over [2.0, 3.4] (search ranges extend below 2.0; the truth is
    # restricted to the same window)
    z_lo, z_hi = 2.0, 3.4
    z_cent, dNdX, _, _, _ = cat.line_density(z_min=z_lo, z_max=z_hi)
    dX_total = cat.path_length(z_lo, z_hi)
    recovered_total = recovered_dla_total(cat, z_cent, dNdX, z_lo, z_hi)
    recovered_rate = recovered_total / dX_total
    n_in_range = sum(1 for _, z, logn in injected if z_lo < z < z_hi and logn > 20.3)
    lines = [
        "# Synthetic-universe validation (the PyTorch port)",
        "",
        f"- spectra: {n_spectra}, injected DLAs: {n_inj} (rate dN/dX = {rate_dndx}, seed {seed})",
        f"- inference wall time (process_spectra_sharded, {on_label(device)}, "
        f"{results.sample_log_likelihoods_dla.dtype}, incl. fetches): {wall:.2f} s "
        f"(the universe built in {build_s:.2f} s, the kernels in {nvcc_s:.2f} s)",
        f"- detections at p > 0.9: {int(detections.sum())} (true positives {tp}/{n_inj}, "
        f"false positives {fp})",
        f"- recovered DLA count in z=[{z_lo}, {z_hi}]: {recovered_total:.2f} (injected in "
        f"range: {n_in_range})",
        f"- recovered mean dN/dX = {recovered_rate:.4f} (injected in-range rate "
        f"{n_in_range / dX_total:.4f}; nominal {rate_dndx} before the <=1-DLA truncation and "
        "the z window)",
    ]
    errs_z, errs_n = [], []
    for i, z_true, logn_true in injected:
        if not detections[i]:
            continue
        mi = int(np.argmax(results.sample_log_likelihoods_dla[i]))
        z_map = results.min_z_dlas[i] + (
            results.max_z_dlas[i] - results.min_z_dlas[i]) * samples.offset_samples[mi]
        errs_z.append(z_map - z_true)
        errs_n.append(samples.log_nhi_samples[mi] - logn_true)
    if errs_z:
        lines.append(f"- MAP accuracy (true positives): |dz| median "
                     f"{np.median(np.abs(errs_z)):.4f}, |dlogN| median "
                     f"{np.median(np.abs(errs_n)):.3f}")
    print("\n".join(lines), flush=True)
    limit = max(0.15 * n_in_range, 2 * np.sqrt(max(n_in_range, 1)))
    checks = {
        "completeness > 0.85": bool(tp / max(n_inj, 1) > 0.85),
        "false positives <= max(2, 2 %)": bool(fp <= max(2, 0.02 * n_spectra)),
        "recovered count within max(15 %, 2 sigma) of the injected": bool(abs(
            recovered_total - n_in_range) < limit),
    }
    out = {"run": "single", "n_spectra": n_spectra, "rate_dndx": rate_dndx, "seed": seed,
           "device": on_label(device), "wall_s": wall, "build_s": build_s, "nvcc_s": nvcc_s,
           "injected": n_inj, "detections": int(detections.sum()), "true_positives": tp,
           "false_positives": fp, "completeness": tp / max(n_inj, 1),
           "recovered_in_range": recovered_total, "injected_in_range": n_in_range,
           "recovered_dndx": recovered_rate, "injected_dndx": n_in_range / dX_total,
           "map_dz_median": float(np.median(np.abs(errs_z))) if errs_z else None,
           "map_dlogn_median": float(np.median(np.abs(errs_n))) if errs_n else None,
           "launches": launch_counts(), "checks": checks, "ok": all(checks.values())}
    print(f"UNIVERSE {json.dumps(out)}", flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"synthetic universe: failed {failed}")
    print("VALIDATION OK", flush=True)
    return out


def main_multi(n_spectra: int = 256, rate_dndx: float = 0.35, seed: int = 21,
               device=None) -> dict:
    """The two-DLA universe through the port's classic {0,1,2}-DLA flow;
    its report, assertions and ``UNIVERSE {json}`` line."""
    import torch

    from gp_dla_detection_tpu_torch.runtime import default_device

    dev = default_device(device)
    t0 = time.perf_counter()
    u = build_multi(n_spectra, rate_dndx, seed, dev, torch.float32)
    build_s = time.perf_counter() - t0
    nvcc_s = build_kernels(dev)
    t0 = time.perf_counter()
    res = infer_multi(u, device=device)
    wall = time.perf_counter() - t0
    samples, injected = u.samples, u.injected

    truth = np.array([len(injected.get(i, [])) for i in range(n_spectra)])
    picks = np.argmax(res.model_posteriors, axis=1)
    conf = np.zeros((3, 3), int)
    for t, p_ in zip(truth, picks):
        conf[t, p_] += 1
    # pair-parameter recovery on correctly classified 2-DLA sightlines
    errs = []
    for i in np.flatnonzero((truth == 2) & (picks == 2)):
        j = int(np.nanargmax(res.sample_log_likelihoods_dla2[i]))
        zr = res.single.max_z_dlas[i] - res.single.min_z_dlas[i]
        z_f = res.single.min_z_dlas[i] + zr * samples.offset_samples[j]
        z_b = res.single.min_z_dlas[i] + zr * samples.offset_samples[res.base_sample_inds[i, j]]
        found = sorted([z_f, z_b])
        true_z = sorted(z for z, _ in injected[i])
        errs.extend([abs(a - b) for a, b in zip(found, true_z)])
    acc2 = conf[2, 2] / max(conf[2].sum(), 1)
    acc_ge1 = (conf[1, 1:].sum() + conf[2, 1:].sum()) / max(conf[1].sum() + conf[2].sum(), 1)
    fp0 = int(conf[0, 1:].sum())
    lines = [
        "# Synthetic-universe validation: two-DLA model selection (the PyTorch port)",
        "",
        f"- spectra: {n_spectra}; injected multiplicities 0/1/2 = "
        f"{conf[0].sum()}/{conf[1].sum()}/{conf[2].sum()} (rate dN/dX = {rate_dndx}, seed {seed})",
        f"- inference wall time (process_spectra_multi_sharded, {on_label(device)}, "
        f"{res.model_posteriors.dtype} posteriors): {wall:.2f} s (the universe built in "
        f"{build_s:.2f} s, the kernels in {nvcc_s:.2f} s)",
        "- confusion matrix (rows = injected count, cols = MAP model):",
        "",
        "  | truth\\pick | 0 | 1 | 2 |",
        "  |---|---|---|---|",
    ] + [f"  | {t} | {conf[t, 0]} | {conf[t, 1]} | {conf[t, 2]} |" for t in range(3)] + [
        "",
        f"- 2-DLA exact-classification rate: {acc2:.3f}",
        f"- >=1-DLA detection rate on hosting sightlines: {acc_ge1:.3f}",
        f"- clean sightlines misclassified as hosting: {fp0}",
    ]
    if errs:
        lines.append(f"- best-pair redshift accuracy (both absorbers, correctly classified "
                     f"2-DLA sightlines): |dz| median {np.median(errs):.4f}, max "
                     f"{np.max(errs):.4f}")
    print("\n".join(lines), flush=True)
    checks = {
        ">=1-DLA detection rate > 0.85": bool(acc_ge1 > 0.85),
        "2-DLA classification rate > 0.7": bool(acc2 > 0.7),
        "false positives <= max(2, 2 %) of the clean": bool(fp0 <= max(2, 0.02 * conf[0].sum())),
    }
    if errs:
        checks["median pair |dz| < 0.01"] = bool(np.median(errs) < 0.01)
    out = {"run": "multi", "n_spectra": n_spectra, "rate_dndx": rate_dndx, "seed": seed,
           "device": on_label(device), "wall_s": wall, "build_s": build_s, "nvcc_s": nvcc_s,
           "confusion": conf.tolist(), "acc_2dla": acc2, "acc_ge1": acc_ge1,
           "false_positives": fp0,
           "pair_dz_median": float(np.median(errs)) if errs else None,
           "pair_dz_max": float(np.max(errs)) if errs else None,
           "launches": launch_counts(), "checks": checks, "ok": all(checks.values())}
    print(f"UNIVERSE {json.dumps(out)}", flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"synthetic universe (multi): failed {failed}")
    print("MULTI VALIDATION OK", flush=True)
    return out


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-spectra", type=int, default=None, help="default: 512 single / 256 multi")
    p.add_argument("--rate", type=float, default=None,
                   help="injected dN/dX (default: 0.12 single / 0.35 multi)")
    p.add_argument("--multi", action="store_true",
                   help="two-DLA injection and recovery instead of single")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the tests)")
    a = p.parse_args(argv)
    if a.multi:
        main_multi(a.n_spectra if a.n_spectra is not None else 256,
                   a.rate if a.rate is not None else 0.35, device=a.device)
    else:
        main(a.n_spectra if a.n_spectra is not None else 512,
             a.rate if a.rate is not None else 0.12, device=a.device)


if __name__ == "__main__":
    cli()
