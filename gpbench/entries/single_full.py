"""Entry: the single-DLA stage of the release,
``parallel.sharded_inference.process_spectra_sharded`` in its full mode
(on one card; each batch's (B, S) sample log likelihoods fetched to the
host, the evidences and p(DLA) formed there)."""

from __future__ import annotations

import numpy as np

from gpbench import program

MULTI = False
KERNELS = ("evidence", "null_evidence")


def call(run, rows, checkpoint_dir) -> dict:
    """One call of the driver on the pool's ``rows``; the outputs the
    comparison reads, in the order of ``rows``."""
    res = program.process_single(
        run.gp_model, run.samples[0], run.samples[1], program.spectra(run.pool, rows),
        run.catalogue[0], run.catalogue[1] >= 1, params=run.params,
        config=run.driver_config(checkpoint_dir),
    )
    return {"ll0": res.log_likelihoods_no_dla, "ev1": res.log_likelihoods_dla,
            "p_dla": res.p_dlas, "sll": res.sample_log_likelihoods_dla}


def launches(batches: int) -> dict:
    return {"single": batches, "pair": 0, "redraw": 0, "null": batches, "cddf": 0}


def failed(out: dict) -> np.ndarray:
    return ~(np.isfinite(out["ll0"]) & np.isfinite(out["ev1"]) & np.isfinite(out["p_dla"]))
