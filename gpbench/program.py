"""What the benchmark takes from the program: its entry points, its
parameters and model types, and its launch counters.  The one module of
the harness that imports ``gp_dla_detection_tpu_torch``."""

from __future__ import annotations

import dataclasses

import numpy as np


def parameters(cfg: dict):
    """The program's ``Parameters`` with the configuration's numbers."""
    from gp_dla_detection_tpu_torch.params import (
        DLASamplingParams, InstrumentParams, NullModelParams, Parameters,
    )

    return Parameters(
        null_model=NullModelParams(min_lambda=cfg["min_lambda"], max_lambda=cfg["max_lambda"],
                                   dlambda=cfg["dlambda"], k=cfg["k"]),
        dla_sampling=dataclasses.replace(DLASamplingParams(),
                                         num_dla_samples=cfg["num_dla_samples"]),
        instrument=InstrumentParams(width=cfg["instrument_width"],
                                    pixel_spacing=cfg["pixel_spacing"],
                                    resolving_power=cfg["resolving_power"]),
        num_lines=cfg["num_lines"], pixel_pad=cfg["pixel_pad"],
        max_z_cut_kms=cfg["max_z_cut_kms"], min_z_cut_kms=cfg["min_z_cut_kms"],
        prior_z_qso_increase=cfg["prior_z_qso_increase_kms"] / 299792.458,
    )


def gp_model(model: dict, device, dtype):
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel

    return GPModel.from_numpy(model["grid"], model["mu"], model["M"], model["log_omega"],
                              model["log_c_0"], model["log_tau_0"], model["log_beta"],
                              device=device, dtype=dtype)


def spectra(pool: dict, rows: np.ndarray):
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra

    return PaddedSpectra(pool["wavelengths"][rows], pool["flux"][rows],
                         pool["noise_variance"][rows], pool["mask"][rows], pool["z_qso"][rows])


def run_config(cell: dict, cfg: dict, checkpoint_dir, device, dtype: str, backend):
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig

    d = cell["driver"]
    return ShardedRunConfig(
        per_device_batch=d["per_device_batch"], pipeline_depth=d["pipeline_depth"],
        store_sample_likelihoods=not d.get("lean", True),
        store_cddf_inputs=d.get("store_cddf_inputs", False),
        checkpoint_dir=checkpoint_dir, dtype=dtype, backend=backend,
        base_replicates=cfg.get("base_replicates") if backend != "torch" else None,
        device=None if device is None else str(device),
    )


def process_multi(*args, **kwargs):
    from gp_dla_detection_tpu_torch.parallel import process_spectra_multi_sharded

    return process_spectra_multi_sharded(*args, **kwargs)


def process_single(*args, **kwargs):
    from gp_dla_detection_tpu_torch.parallel import process_spectra_sharded

    return process_spectra_sharded(*args, **kwargs)


def counters() -> dict:
    """The program's kernel launch counters."""
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn, redraw

    return {"single": evidence.launch_count, "pair": evidence.pair_launch_count,
            "redraw": redraw.launch_count, "null": low_rank_mvn.launch_count,
            "cddf": cddf_inputs.launch_count}


def load_kernels(names) -> float:
    """Build (or find built) the kernels the cell runs; seconds taken."""
    import time

    from gp_dla_detection_tpu_torch import _build

    t0 = time.perf_counter()
    for name in names:
        _build.load_library(name)
    return time.perf_counter() - t0
