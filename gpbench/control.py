"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place at the nearest precision below the
configuration's float32 (float32 with TF32 matrix products), compared
with the float64 reference exactly as a run compares the program, on
the sample a run draws from the seed.

    python3 gpbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: the numbers, the cell's limits and the
numbers the control fails.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpbench import check, harness  # noqa: E402


def control_numbers(workload: str, seed: int, device=None, pool_size=None, samples=None,
                    root: Path = harness.ROOT) -> dict:
    """The control's numbers on ``seed``'s sample, beside the cell's limits."""
    cell = harness.sized_cell(harness.load_cell(workload, root), pool_size, samples)
    device = torch.device(device) if device is not None else harness.card(cell.spec.get("chips", 1))
    r = harness.Run(cell, seed, 0.0, False, device, None)
    harness.make_inputs(r)
    pick = harness.check_rows(r, np.arange(len(r.pool["z_qso"])))
    cfg, multi, spec = cell.cfg, cell.entry.MULTI, check.cddf_spec()
    priors = check.priors_of(cfg, r.catalogue, r.pool["z_qso"][pick])
    outputs = {}
    for name, dtype, tf32 in (("reference", torch.float64, False),
                              ("control", torch.float32, True)):
        ref = check.reference_for(cfg, r.model, r.samples, device, dtype=dtype, tf32=tf32)
        outputs[name] = (ref, check.reference_outputs(
            ref, r.pool, pick, priors, multi, log_nhis=r.samples[2], spec=spec,
            full=not cell.driver.get("lean", True)))
    got = {k: v for k, v in outputs["control"][1].items() if k != "_ref"}
    ref, want = outputs["reference"]
    nums = check.compare(ref, got, want, multi, spec=spec)
    limits = cell.spec["check"]["limits"]
    return {"workload": workload, "seed": seed,
            "numbers": {k: nums[k] for k in limits}, "limits": limits,
            "fails": sorted(k for k in limits if nums[k] > limits[k]), "all": nums}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    for seed in a.seeds:
        t0 = time.perf_counter()
        out = control_numbers(a.workload, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
