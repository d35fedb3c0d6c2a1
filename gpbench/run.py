"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace
1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` a
``breakdown``, then ``run`` (what the window did) and last ``checks``
(each number compared, with its limit).  The checks are also the last
lines of standard error.  Without the card(s), or with JAX or the JAX
package loaded once the window has closed, it exits non-zero and prints
no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the checkout's root: the harness and the program import from it
sys.path[:0] = [str(HERE.parent)]
# the caches a kernel library would keep, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / "_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from gpbench import harness

    try:
        result, checks = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                                     t_process=T_PROCESS)
    except harness.NoChip as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 2
    found = result["run"]["forbidden_modules"]
    if found:
        print(f"gpbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    info = result["run"]
    print(json.dumps({"spectra_per_s": info["spectra_per_s"], "calls": info["calls"],
                      "window_s": info["window_s"], "setup_s": info["setup_s"],
                      "traced": bool(a.trace)}), flush=True)
    print(json.dumps({"bytes_written": info["bytes_written"],
                      "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                      "launches": info["launches"],
                      "expected_launches": info["expected_launches"]}), flush=True)
    # a gap that is not finite (an output missing or NaN) prints as 1e300
    for c in checks:
        c["value"] = c["value"] if c["value"] < 1e300 else 1e300
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
