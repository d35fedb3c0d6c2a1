"""The numbers of a benchmark cell's comparison (``gpbench/check.py``)
for the program and for its TF32 control, on given seeds, from one
float64 reference a seed: what a cell's limits are calibrated on.

    python3 scripts/torch_check_calibration.py --workload <cell> --seeds <n> [<n> ...]
        [--out runs/calibration_<cell>.jsonl]

For each seed: the run's inputs from the seed (``gpbench.harness``), the
sample of rows a bulk run compares (every row of the pool finishes in a
bulk call, so the sample is the one ``check_rows`` draws from the whole
pool), the float64 reference of those rows, the control's outputs (the
reference at float32 with TF32 matrix products, as ``gpbench/control.py``
computes them) and the program's (the cell's entry on those rows alone:
the port's drivers give a row the same bits at any batch), each compared
with the reference as a run compares.  One JSON line a seed: the
numbers of each, the cell's limits, which numbers each fails, and the
seconds the reference took.  Needs the card the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def calibrate(workload: str, seed: int, device=None, **sized) -> dict:
    """One seed's numbers.  ``device`` None: the card, which must be
    there; ``sized``: ``harness.sized_cell``'s settings (a rehearsal at a
    size the CPU holds)."""
    import numpy as np
    import torch

    from gpbench import check, harness, program

    cell = harness.sized_cell(harness.load_cell(workload), **sized)
    device = torch.device(device) if device is not None else harness.card(
        cell.spec.get("chips", 1))
    r = harness.Run(cell, seed, 0.0, False, device, None)
    harness.make_inputs(r)
    if cell.mix["loop"].get("call_size"):
        raise ValueError(f"{workload} makes calls of part of its pool: its sample depends "
                         "on the window, which this script does not run")
    pick = harness.check_rows(r, np.arange(len(r.pool["z_qso"])))
    cfg, multi, spec = cell.cfg, cell.entry.MULTI, check.cddf_spec()
    full = not cell.driver.get("lean", True)
    priors = check.priors_of(cfg, r.catalogue, r.pool["z_qso"][pick])

    t0 = time.perf_counter()
    ref = check.reference_for(cfg, r.model, r.samples, device)
    want = check.reference_outputs(ref, r.pool, pick, priors, multi, log_nhis=r.samples[2],
                                   spec=spec, full=full)
    ref_s = time.perf_counter() - t0
    ctl = check.reference_for(cfg, r.model, r.samples, device, dtype=torch.float32, tf32=True)
    got_ctl = {k: v for k, v in check.reference_outputs(
        ctl, r.pool, pick, priors, multi, log_nhis=r.samples[2], spec=spec,
        full=full).items() if k != "_ref"}

    if device.type == "cuda":
        program.load_kernels(cell.entry.KERNELS)
    r.params = program.parameters(cfg)
    r.gp_model = program.gp_model(r.model, device, torch.float32)
    got = cell.entry.call(r, pick, None)

    limits = cell.spec["check"]["limits"]
    out = {"workload": workload, "seed": seed, "limits": limits, "reference_s": ref_s,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    for name, outputs in (("program", got), ("control", got_ctl)):
        nums = check.compare(ref, outputs, want, multi, spec=spec)
        out[name] = {"numbers": {k: nums[k] for k in limits},
                     "fails": sorted(k for k in limits if nums[k] > limits[k]), "all": nums}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    for seed in a.seeds:
        line = json.dumps(calibrate(a.workload, seed))
        if a.out:
            a.out.parent.mkdir(parents=True, exist_ok=True)
            with a.out.open("a") as f:
                f.write(line + "\n")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
