"""Survey-scale demo of the PyTorch port: 1024 spectra x 10,000 QMC
samples through the classic two-stage {0, 1, 2}-DLA model selection.

The counterpart of ``scripts/scale_demo.py``: the same synthetic
workload, drawn in the same order from ``np.random.default_rng(seed)``
(the model, z_QSO, the flux with 0, 1 or 2 DLAs injected at 3 Lyman
lines, the QMC samples, the prior catalogue), run through
``parallel.process_spectra_multi_sharded`` on ``make_mesh()`` with the
single stage's and the pair stage's per-batch checkpoints in a temporary
directory (removed afterwards), float32, through the CUDA kernels by
default.  The injected profiles are computed in float32 on the CPU,
as the JAX script computes them without x64, so both scripts see the
same spectra for one seed.  The JAX script's persistent compilation
cache has no counterpart here: the kernels are built once per checkout
(``_build``).

Run:  python scripts/torch_scale_demo.py [--n-spectra 1024] [--backend cuda]
      [--device cpu]
Across cards: torchrun --nproc-per-node N scripts/torch_scale_demo.py
(each rank joins the process group and takes its card; rank 0 prints).
Prints one JSON line per stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def synthetic_survey(n_spectra: int, seed: int, num_samples: int) -> dict:
    """The JAX script's workload: (params, model arrays, spectra arrays,
    the injected DLA counts, the QMC samples, the prior catalogue)."""
    import torch

    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters
    from gp_dla_detection_tpu_torch.samples import generate_dla_samples

    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=20))
    if num_samples != params.dla_sampling.num_dla_samples:
        params = dataclasses.replace(
            params,
            dla_sampling=dataclasses.replace(params.dla_sampling, num_dla_samples=num_samples),
        )
    grid = params.null_model.rest_wavelengths()
    P = params.pixel_pad
    mu = 1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2) + 0.1 * np.sin(grid / 60.0)
    M = rng.normal(size=(grid.size, 20)) * 0.04

    z_qso = rng.uniform(2.4, 3.4, n_spectra)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P))[None, :]
    noise_sd = 0.1
    flux = np.empty((n_spectra, P))
    injected = np.zeros(n_spectra, np.int64)
    lya = 1215.6701
    for i in range(n_spectra):
        rest = lam[i] / (1 + z_qso[i])
        f = (
            np.interp(rest, grid, mu)
            + np.interp(rest, grid, M @ rng.normal(size=20))
            + rng.normal(0, noise_sd, P)
        )
        # ~35% of sightlines host 1 DLA, ~10% host 2
        n_dla = rng.choice([0, 1, 2], p=[0.55, 0.35, 0.10])
        zmin = lam[i, 0] / lya - 1 + 0.02
        # inside the searched range: capped at the last modelled pixel
        lam_search_max = min(lam[i, -1], params.null_model.max_lambda * (1 + z_qso[i]))
        zmax = lam_search_max / lya - 1 - params.max_z_cut
        ext = (
            torch.as_tensor(extend_wavelengths(lam[i], params.instrument), dtype=torch.float32)
            if n_dla else None
        )
        for z_dla in rng.uniform(zmin, zmax, n_dla):
            nhi = 10 ** rng.uniform(20.3, 21.8)
            f *= voigt_absorption(ext, float(z_dla), float(nhi), num_lines=3).numpy()
        injected[i] = n_dla
        flux[i] = f

    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)
    prior_z = rng.uniform(2.2, 3.6, 5000)
    # per-prior-sightline DLA multiplicities (the pipeline derives them
    # with multi_dla.prior_dla_multiplicity from the catalogue's flags)
    prior_num = rng.choice([0, 0, 0, 0, 0, 0, 0, 1, 1, 2], 5000)
    return {
        "params": params, "grid": grid, "mu": mu, "M": M, "z_qso": z_qso, "lam": lam,
        "flux": flux, "noise_variance": np.full((n_spectra, P), noise_sd**2),
        "injected": injected, "samples": samples, "prior_z": prior_z, "prior_num": prior_num,
    }


def main(
    n_spectra: int = 1024,
    backend: str = "cuda",
    seed: int = 7,
    num_samples: int = 10000,
    device: str | None = None,
) -> dict:
    """Run the demo; print (on the coordinator) and return the
    ``two_stage_model_selection`` line's fields, with the run's result,
    the injected DLA counts and its inputs (the model, the spectra and
    the ``synthetic_survey`` workload)."""
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.parallel import (
        ShardedRunConfig,
        initialize_distributed,
        make_mesh,
        process_spectra_multi_sharded,
        shutdown,
    )

    # under torchrun: one rank per card, as the pipeline CLI joins
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        initialize_distributed(None, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    try:
        mesh = make_mesh()
        say = print if mesh.is_coordinator else (lambda *a, **kw: None)
        if device is None and mesh.device is not None:
            device = str(mesh.device)

        t_prep = time.perf_counter()
        w = synthetic_survey(n_spectra, seed, num_samples)
        model = GPModel.from_numpy(
            w["grid"], w["mu"], w["M"], np.log(0.12 + 0 * w["grid"]),
            np.log(0.1), np.log(0.0023), np.log(3.65), device=device,
        )
        P = w["params"].pixel_pad
        spectra = PaddedSpectra(
            w["lam"], w["flux"], w["noise_variance"], np.ones((n_spectra, P), bool), w["z_qso"]
        )
        say(json.dumps({"stage": "prepare", "seconds": round(time.perf_counter() - t_prep, 3)}),
            flush=True)

        # size the super-batch to the workload: padding a small run up to
        # 256 per rank wastes compute
        pdb = max(1, min(256, -(-n_spectra // mesh.shape["data"])))
        ckpt = Path(tempfile.mkdtemp(prefix="torch_scale_demo_")) if mesh.is_coordinator else None
        try:
            t0 = time.perf_counter()
            res = process_spectra_multi_sharded(
                model, w["samples"].offset_samples, w["samples"].nhi_samples, spectra,
                w["prior_z"], w["prior_num"], params=w["params"], mesh=mesh,
                config=ShardedRunConfig(
                    per_device_batch=pdb, sample_chunk=min(2500, num_samples),
                    dtype="float32", backend=backend, device=device,
                    checkpoint_dir=None if ckpt is None else str(ckpt),
                ),
            )
            total = time.perf_counter() - t0
        finally:
            if ckpt is not None:
                shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        if joined:
            shutdown()

    injected = w["injected"]
    picks = np.argmax(res.model_posteriors, axis=1)
    acc = float(np.mean(picks == np.minimum(injected, 2)))
    # np.mean over an empty selection is NaN (invalid JSON downstream)
    rate = lambda sel: round(float(np.mean(sel)), 3) if sel.size else None
    line = {
        "stage": "two_stage_model_selection",
        "n_spectra": n_spectra,
        "num_samples": len(w["samples"].offset_samples),
        "backend": backend,
        "seconds": round(total, 3),
        "spectra_per_sec_end_to_end": round(n_spectra / total, 1),
        "exact_multiplicity_acc": round(acc, 3),
        "detection_rate": rate(picks[injected >= 1] >= 1),
        "clean_false_positive_rate": rate(picks[injected == 0] >= 1),
    }
    say(json.dumps(line), flush=True)
    return {**line, "results": res, "injected": injected, "model": model, "spectra": spectra,
            "workload": w}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-spectra", type=int, default=1024)
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' with --backend torch)")
    a = p.parse_args()
    main(a.n_spectra, a.backend, a.seed, a.num_samples, a.device)
