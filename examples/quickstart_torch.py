"""Minimal end-to-end DLA detection on synthetic spectra, with the
PyTorch port.

Builds a known GP quasar-emission model, draws three spectra from it
(one clean, one with an injected DLA, one with TWO), runs the Bayesian
{0, 1, 2}-DLA model selection, and prints the posteriors and recovered
absorber parameters.  Runs on the CUDA card in float32 through the
evidence kernels; ``--device cpu`` runs the plain PyTorch path on the
CPU.

    python examples/quickstart_torch.py [--device cpu] [--num-samples N]
"""

import argparse

import numpy as np
import torch

from gp_dla_detection_tpu_torch.inference import PaddedSpectra
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi
from gp_dla_detection_tpu_torch.ops.voigt import voigt_absorption
from gp_dla_detection_tpu_torch.params import DLASamplingParams, NullModelParams, Parameters
from gp_dla_detection_tpu_torch.samples import generate_dla_samples


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--num-samples", type=int, default=10000,
                    help="QMC (z_DLA, N_HI) samples (the reference's 10,000)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    params = Parameters(
        null_model=NullModelParams(k=6),
        dla_sampling=DLASamplingParams(num_dla_samples=args.num_samples),
    )
    grid = params.null_model.rest_wavelengths()

    # a "learned" emission model (in real runs: Pipeline.run_learn / GPModel.load)
    model = GPModel.from_numpy(
        rest_wavelengths=grid,
        mu=1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2),
        M=rng.normal(size=(grid.size, 6)) * 0.04,
        log_omega=np.log(0.12 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
        device=args.device,
    )

    # three synthetic sightlines at z_QSO = 3
    P, z_qso = 1280, np.full(3, 3.0)
    lam = np.stack([10 ** (np.log10(911.9 * 4.0) + 1e-4 * np.arange(P))] * 3)
    noise_sd = 0.1
    mu = model.mu.double().cpu().numpy()
    flux = np.stack(
        [np.interp(lam[i] / 4.0, grid, mu) + rng.normal(0, noise_sd, P) for i in range(3)]
    )

    def inject(i, z_dla, log_nhi):
        ext = np.concatenate([  # conv padding: 3 extra log-spaced px per side
            lam[i, :1] * 10 ** (-1e-4 * np.arange(3, 0, -1)),
            lam[i],
            lam[i, -1:] * 10 ** (1e-4 * np.arange(1, 4)),
        ])
        flux[i] *= voigt_absorption(torch.as_tensor(ext), z_dla, 10.0 ** log_nhi).numpy()

    inject(1, 2.62, 20.8)                         # one DLA
    inject(2, 2.45, 20.7)
    inject(2, 2.85, 21.0)                         # two DLAs

    spectra = PaddedSpectra(lam, flux, np.full((3, P), noise_sd**2), np.ones((3, P), bool), z_qso)

    # QMC prior samples from an "observed" concordance column-density set
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 300), params)

    # a neutral counting-prior catalog (real runs use the DR9 concordance)
    prior_z = rng.uniform(2.2, 3.6, 2000)
    prior_num = np.minimum(rng.poisson(0.3, 2000), 2)

    res = process_spectra_multi(
        model, samples.offset_samples, samples.nhi_samples, spectra,
        prior_z, prior_num, params=params, batch_size=3, sample_chunk=1000,
        device=model.mu.device,
    )

    names = ["clean", "one DLA (z=2.62)", "two DLAs (z=2.45, 2.85)"]
    for i, name in enumerate(names):
        p0, p1, p2 = res.model_posteriors[i]
        print(f"{name:26s} p(0,1,2 DLAs) = {p0:.3f} {p1:.3f} {p2:.3f}")

    # MAP absorber parameters
    i = 1
    j = int(np.argmax(res.single.sample_log_likelihoods_dla[i]))
    zr = res.single.max_z_dlas[i] - res.single.min_z_dlas[i]
    z_single = res.single.min_z_dlas[i] + zr * samples.offset_samples[j]
    print(f"MAP single absorber: z = {z_single:.3f}, "
          f"logN = {samples.log_nhi_samples[j]:.2f}  (injected 2.62, 20.8)")

    i = 2
    j = int(np.nanargmax(res.sample_log_likelihoods_dla2[i]))
    zr = res.single.max_z_dlas[i] - res.single.min_z_dlas[i]
    z_f = res.single.min_z_dlas[i] + zr * samples.offset_samples[j]
    z_b = res.single.min_z_dlas[i] + zr * samples.offset_samples[res.base_sample_inds[i, j]]
    print(f"MAP pair: z = {min(z_f, z_b):.3f}, {max(z_f, z_b):.3f}  (injected 2.45, 2.85)")
    return {
        "model_posteriors": res.model_posteriors,
        "z_single": float(z_single),
        "z_pair": (float(min(z_f, z_b)), float(max(z_f, z_b))),
    }


if __name__ == "__main__":
    main()
