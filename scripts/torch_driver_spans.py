"""One traced run of a benchmark cell with the program's span recorder
on: the device's idle time and device time by driver span, and the
evidence kernels' launches and paths.

    python3 scripts/torch_driver_spans.py --workload <cell> --seed <n> [--seconds 30]
        [--out runs/spans_<cell>.json]

runs ``gpbench``'s traced run of the cell (``--trace 1``: the window
under ``torch.profiler``), records the spans of every call made while the
profiler is on, keeps the profiler's trace that the harness reduces,
and puts the spans against it (``gpbench/spans.py``).  The last line of
standard output is one JSON object: the cell, the seed, the card, the
harness's result (its per-layer metrics and ``breakdown``),
``spans``: the alignment, idle and device time by span, and the drivers'
quantities; ``stages``: each ``gpdla.stage.*`` span's device time with
the ``lines`` and ``window`` ids it carried (the evidence stages; window
0 is the full grid); and ``launches``: the evidence kernels' launch
counters over the profiled calls, the full-grid ones among them, and the
drivers' evidence reductions on the card (``evidence_reduce_count``, one
a batch).  Needs the card the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
# the evidence kernels' launch counters (ops/evidence.py)
COUNTERS = ("launch_count", "pair_launch_count", "full_grid_launch_count",
            "full_grid_pair_launch_count")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def traced_run(workload: str, seed: int, seconds: float, **harness_kw) -> dict:
    """The cell's traced run with the span recorder on for the calls in
    the profiled window; ``harness_kw`` go to ``gpbench.harness.run``."""
    import torch.autograd.profiler as torch_profiler

    from gp_dla_detection_tpu_torch.ops import evidence
    from gp_dla_detection_tpu_torch.parallel import streaming
    from gp_dla_detection_tpu_torch.utils import observability
    from gpbench import harness, spans
    from gpbench import trace as tr

    recorded, raw = [], []
    counts = lambda: {**{c: getattr(evidence, c) for c in COUNTERS},
                      "evidence_reduce_count": streaming.evidence_reduce_count}
    launches = dict.fromkeys(counts(), 0)
    load_events = tr.load_events

    def keep_raw(path):
        # the harness deletes its trace once reduced: keep the raw events
        raw.extend(spans.load_raw(path))
        return load_events(path)

    def hook(call):
        def recorded_call(*args):
            if not torch_profiler._is_profiler_enabled:
                return call(*args)
            before = counts()
            with observability.recording() as rec:
                try:
                    return call(*args)
                finally:
                    recorded.extend(rec.drain())
                    for c, n in counts().items():
                        launches[c] += n - before[c]
        return recorded_call

    tr.load_events = keep_raw
    try:
        result, checks = harness.run(workload, seed, seconds, True, t_process=T_PROCESS,
                                     call_hook=hook, **harness_kw)
    finally:
        tr.load_events = load_events
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    result["spans"] = spans.reduce(raw, [tuple(s) for s in recorded])
    result["stages"] = stages(recorded, result["spans"]["device_by_span"])
    result["launches"] = launches
    return {"workload": workload, "seed": seed, **result}


def stages(recorded, device_by_span) -> dict:
    """Each stage span's device time (s) and the ``lines`` and ``window``
    ids its spans carried."""
    device = dict(device_by_span)
    out = {}
    for s in recorded:
        if s.name.startswith("gpdla.stage."):
            st = out.setdefault(s.name, {"device_s": device.get(s.name, 0.0),
                                         "lines": set(), "window": set()})
            for key in ("lines", "window"):
                if key in s.ids:
                    st[key].add(s.ids[key])
    return {name: {**st, "lines": sorted(st["lines"]), "window": sorted(st["window"])}
            for name, st in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    out = traced_run(a.workload, a.seed, a.seconds)
    line = json.dumps(out)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
