"""Entry: the fused lean {0,1,2}-DLA chain with CDDF inputs,
``parallel.sharded_multi.process_spectra_multi_sharded`` (lean, on one
card, per-batch checkpoints when the cell asks for them)."""

from __future__ import annotations

import numpy as np

from gpbench import program

MULTI = True
KERNELS = ("evidence", "null_evidence", "redraw", "cddf")


def call(run, rows, checkpoint_dir) -> dict:
    """One call of the driver on the pool's ``rows``; the outputs the
    comparison reads, in the order of ``rows``."""
    res = program.process_multi(
        run.gp_model, run.samples[0], run.samples[1], program.spectra(run.pool, rows),
        run.catalogue[0], run.catalogue[1], params=run.params,
        config=run.driver_config(checkpoint_dir),
    )
    s = res.single
    return {"ll0": s.log_likelihoods_no_dla, "ev1": s.log_likelihoods_dla,
            "map1": s.map_sample_inds, "p_dla": s.p_dlas, "ev2": res.log_likelihoods_dla2,
            "map2": res.map_sample_inds2, "map_base": res.map_base_sample_inds,
            "post": res.model_posteriors, "hist": res.cddf_inputs.hist,
            "ex": res.cddf_inputs.ex}


def launches(batches: int) -> dict:
    """The kernel launches a call of ``batches`` batches makes."""
    return {"single": batches, "pair": batches, "redraw": batches, "null": batches,
            "cddf": batches}


def failed(out: dict) -> np.ndarray:
    """Rows whose outputs are not finite: the null, the single and pair
    evidences, p(DLA) or any of the {0,1,2} posteriors."""
    bad = ~(np.isfinite(out["ll0"]) & np.isfinite(out["ev1"]) & np.isfinite(out["p_dla"])
            & np.isfinite(out["ev2"]))
    return bad | ~np.isfinite(out["post"]).all(axis=1)
