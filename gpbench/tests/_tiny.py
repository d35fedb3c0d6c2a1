"""A run of a cell at a size the CPU holds: a few sightlines, most with
absorbers, a few hundred QMC samples, batches of 4, each call the whole
pool, the program's plain path in float64."""

import time

from gpbench import harness

TINY = dict(device="cpu", backend="torch", dtype="float64", pool_size=6, samples=300,
            driver={"per_device_batch": 4, "pipeline_depth": 2},
            # absorbers on most sightlines, noise that leaves the few samples
            # here a broad posterior, and a prior catalogue whose every
            # quasar has two: the few samples here fit no absorber well, and
            # the posteriors' masses would underflow on the model's odds
            traffic={"dla_dndx": 3.0, "noise_sd": 1.0, "call_size": None},
            config={"prior_catalogue": {"dla_rate": 50.0}})


def run(cell, seed=2147483999, trace=False, **kw):
    args = {**TINY, **kw}
    return harness.run(cell, seed, 0.01, trace, t_process=time.perf_counter(),
                       log=lambda *a, **k: None, **args)
