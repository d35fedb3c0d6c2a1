"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell, configuration, traffic mix, entry
or metric lives in a file of its own, found by name:

- ``gpbench/workloads/<cell>.json``: the configuration, the traffic mix,
  the entry, the driver's settings, the chips, the comparison's sample
  and limits, the ``why``, and optionally ``host_threads`` (the torch
  threads of a run on the card);
- ``gpbench/configs/<config>.json``: the configuration's numbers;
- ``gpbench/traffic/<mix>.json``: the mix, read by ``traffic.generate``;
- ``gpbench/entries/<entry>.py``: how a call drives the program;
- ``gpbench/metrics/<quantity>.py``: one reader per quantity;
  ``read(run)`` returns the value, or None where it finds nothing to
  read.  A metric of ``BENCHMARK.json`` named ``<quantity>`` or
  ``<quantity>.<variant>`` (the same quantity in cells that report
  another end-to-end metric) is read by ``metrics/<name>.py`` where that
  file exists, else by ``metrics/<quantity>.py``.

``BENCHMARK.json`` says which metrics a cell reports: every end-to-end
metric and per-layer metric whose ``workloads`` lists it, or that has
no ``workloads``.

A run: set-up (the pool, model and samples from the seed on the card,
the kernels from the program's build directory, a warm-up of the cell's
own shapes), then back-to-back calls from one caller until the first
call that ends ``seconds`` after the window opened, then the checks.
With ``trace`` the window runs under ``torch.profiler``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from gpbench import check, opcount
from gpbench.traffic import generate

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_dla_detection_tpu")


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A module of the harness's folders, by file path (names may hold
    dots)."""
    name = "gpbench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: dict
    cfg: dict
    mix: dict
    entry: object

    @property
    def driver(self) -> dict:
        return self.spec["driver"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = read_json(root / "workloads" / f"{name}.json")
    cfg = read_json(root / "configs" / f"{spec['config']}.json")
    mix = read_json(root / "traffic" / f"{spec['traffic']}.json")
    return Cell(name, spec, cfg, mix, load_module(root / "entries" / f"{spec['entry']}.py"))


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of metric ``name``: its own file, else its quantity's."""
    own = root / "metrics" / f"{name}.py"
    return own if own.is_file() else root / "metrics" / f"{name.split('.')[0]}.py"


def metric_plan(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" | "per_layer") metrics ``cell`` reports."""
    return [m for m in bench.get(kind, []) if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


@dataclass
class Run:
    """Everything one run made and measured, as the metric readers see it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    backend: str | None
    dtype: str = "float32"
    model: dict = field(default_factory=dict)
    pool: dict = field(default_factory=dict)
    samples: tuple = ()
    catalogue: tuple = ()
    params: object = None
    gp_model: object = None
    calls: list = field(default_factory=list)        # (t0, t1, rows)
    outputs: list = field(default_factory=list)      # (rows, outputs) still kept
    setup_s: float = 0.0
    window_s: float = 0.0
    bytes_written: int = 0
    batches: int = 0                                  # batches the window's calls made
    launches: dict = field(default_factory=dict)
    expected_launches: dict = field(default_factory=dict)
    trace_summary: object = None
    phases: dict = field(default_factory=dict)        # set-up's parts, s
    all_numbers: dict = field(default_factory=dict)   # every statistic of the comparison

    def driver_config(self, checkpoint_dir):
        from gpbench import program

        return program.run_config(self.cell.spec, self.cell.cfg, checkpoint_dir, self.device,
                                  self.dtype, self.backend)

    @property
    def on_card(self) -> bool:
        """A device metric is read only from a run on the card."""
        return self.device.type == "cuda"

    @property
    def spectra(self) -> int:
        return sum(len(r) for _, _, r in self.calls)

    def shapes(self) -> dict:
        cfg, d = self.cell.cfg, self.cell.driver
        taps = 2 * cfg["instrument_width"] + 1
        P = cfg["pixel_pad"]
        return {
            "B": d["per_device_batch"], "S": cfg["num_dla_samples"], "P": P, "k": cfg["k"],
            "lines": cfg["num_lines"], "taps": taps,
            "window": opcount.sample_window(self.samples[0], P + taps - 1, cfg["num_lines"],
                                            cfg["pixel_spacing"]),
            "draws": opcount.base_draws(cfg["num_dla_samples"], cfg.get("base_replicates", 1)),
        }

    def work_per_batch(self) -> dict:
        """The frozen count of each kernel's work in one batch."""
        s = self.shapes()
        B, S, P, k, L, T, W = s["B"], s["S"], s["P"], s["k"], s["lines"], s["taps"], s["window"]
        work = {"null": opcount.null_evidence(B, P, k),
                "single": opcount.evidence_single(B, S, P, k, L, T, W)}
        if self.cell.entry.MULTI:
            spec = check.cddf_spec()
            work["pair"] = opcount.evidence_pair(B, S, P, k, L, T, W, s["draws"])
            work["redraw"] = opcount.redraw(B, S)
            work["cddf"] = opcount.cddf(B, S, 8 * spec.n_z_window * (spec.n_lnhi + 1),
                                        5 * spec.top_k + 4)
        return work


def card(chips: int) -> torch.device:
    """The first card, where the machine has the ``chips`` a cell asks for."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoChip(f"the cell needs {chips} CUDA device(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0)


def sized_cell(cell: Cell, pool_size=None, samples=None, driver=None, traffic=None,
               config=None) -> Cell:
    """``cell`` with a smaller pool, fewer QMC samples, other driver, pool
    or configuration settings (the harness's tests)."""
    cfg, mix, spec = (json.loads(json.dumps(x)) for x in (cell.cfg, cell.mix, cell.spec))
    if samples:
        cfg["num_dla_samples"] = samples
    if pool_size:
        mix["pool"]["n_sightlines"] = pool_size
    spec["driver"].update(driver or {})
    for key, value in (traffic or {}).items():
        mix["loop" if key in mix["loop"] else "pool"][key] = value
    for key, value in (config or {}).items():
        cfg[key] = {**cfg[key], **value} if isinstance(value, dict) else value
    return Cell(cell.name, spec, cfg, mix, cell.entry)


def make_inputs(r: "Run") -> None:
    """The run's inputs from its seed, on its device: the generating
    model, the pool of sightlines, the QMC samples, the prior catalogue."""
    cfg = r.cell.cfg
    gen = torch.Generator(device=r.device)
    gen.manual_seed(int(r.seed) % (1 << 64))
    r.model = generate.generating_model(cfg, gen, r.device)
    cfg["_model"] = r.model
    r.pool = generate.survey_pool(r.cell.mix, cfg, gen, r.device)
    r.samples = generate.qmc_samples(cfg)
    r.catalogue = generate.prior_catalogue(cfg)


def check_rows(r: "Run", finished: np.ndarray) -> np.ndarray:
    """The comparison's sample of the ``finished`` rows, drawn from the
    seed, with the finished row of the most absorbers in it.  The cell's
    ``check.pair_rows`` of them are drawn from the finished rows with two
    absorbers, where the pair stage carries mass (as many as there are)."""
    rng = np.random.default_rng(_seed_words(r.seed) + [7])
    chk = r.cell.spec["check"]
    n = min(chk["rows"], len(finished))
    two = finished[r.pool["n_dlas"][finished] >= 2]
    n2 = min(chk.get("pair_rows", 0), len(two), n)
    pick = list(rng.choice(two, size=n2, replace=False)) if n2 else []
    rest = np.setdiff1d(finished, pick)
    pick += list(rng.choice(rest, size=n - n2, replace=False))
    most = int(finished[np.argmax(r.pool["n_dlas"][finished])])
    if most not in pick:
        pick[-1] = most
    return np.array(pick)


def call_plan(cell: Cell, n_pool: int):
    """The rows of each call, in order, forever: the whole pool each
    call, or the next ``call_size`` rows, cycling."""
    size = cell.mix["loop"].get("call_size") or n_pool
    start = 0
    while True:
        yield (np.arange(start, start + size) % n_pool)
        start = (start + size) % n_pool


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_process: float,
        device=None, backend=None, dtype: str = "float32", root: Path = ROOT,
        bench: dict | None = None, pool_size: int | None = None, samples: int | None = None,
        driver: dict | None = None, traffic: dict | None = None, config: dict | None = None,
        call_hook=None, log=print) -> tuple[dict, list]:
    """One run of ``workload``; returns (result line, checks).  ``device``
    None: the card, which must be there.  ``pool_size``, ``samples``,
    ``driver``, ``traffic``, ``config`` (settings over the cell's, its
    pool's and its configuration's) and ``call_hook`` (wraps the entry's
    call) are for the harness's tests."""
    from gpbench import program

    cell = sized_cell(load_cell(workload, root), pool_size, samples, driver, traffic, config)
    if bench is None:
        bench = read_json(root.parent / "BENCHMARK.json")
    chips = int(cell.spec.get("chips", 1))
    if device is None:
        device = card(chips)
    device = torch.device(device)
    cfg = cell.cfg
    if device.type == "cuda" and cell.spec.get("host_threads"):
        torch.set_num_threads(int(cell.spec["host_threads"]))
    r = Run(cell, seed, seconds, trace, device, backend, dtype)
    t0 = time.perf_counter()
    make_inputs(r)
    r.phases["inputs_s"] = time.perf_counter() - t0
    n_pool = len(r.pool["z_qso"])
    t0 = time.perf_counter()
    if device.type == "cuda":
        program.load_kernels(cell.entry.KERNELS)
        torch.cuda.synchronize(device)
    r.phases["kernels_s"] = time.perf_counter() - t0
    r.params = program.parameters(cfg)
    torch_dtype = getattr(torch, dtype)
    r.gp_model = program.gp_model(r.model, device, torch_dtype)

    batch = cell.driver["per_device_batch"]
    ckpt_root = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    use_ckpt = bool(cell.driver.get("checkpoints"))

    call = cell.entry.call if call_hook is None else call_hook(cell.entry.call)

    def one_call(rows):
        ckpt = tempfile.mkdtemp(prefix="gpbench-ckpt-", dir=ckpt_root) if use_ckpt else None
        try:
            out = call(r, rows, ckpt)
            written = tree_bytes(Path(ckpt)) if ckpt else 0
        finally:
            if ckpt:
                shutil.rmtree(ckpt, ignore_errors=True)
        return out, written

    # warm-up: the cell's own shapes, as many batches as the pipeline
    # holds (bulk calls) or one call (calls of call_size)
    size = cell.mix["loop"].get("call_size") or min(n_pool, batch * cell.driver["pipeline_depth"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = program.counters()
    t0 = time.perf_counter()
    warm_batches = 0
    for _ in range(int(cell.spec.get("warmup_calls", 1))):
        one_call(np.arange(size) % n_pool)
        warm_batches += -(-size // batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    r.phases["warmup_s"] = time.perf_counter() - t0

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t_open = time.perf_counter()
    r.setup_s = t_open - t_process
    plan = call_plan(cell, n_pool)
    failed = 0
    with torch.profiler.record_function("gpbench.window"):
        while True:
            rows = next(plan)
            t0 = time.perf_counter()
            out, written = one_call(rows)
            t1 = time.perf_counter()
            r.calls.append((t0, t1, rows))
            r.bytes_written += written
            r.batches += -(-len(rows) // batch)
            failed += int(cell.entry.failed(out).sum())
            if len(rows) >= n_pool:
                r.outputs.clear()
            r.outputs.append((rows, out))
            if t1 - t_open >= seconds:
                break
    r.window_s = r.calls[-1][1] - t_open
    if prof is not None:
        prof.__exit__(None, None, None)
        from gpbench import trace as tr

        path = ckpt_root / f"gpbench-trace-{os.getpid()}.json"
        try:
            prof.export_chrome_trace(str(path))
            r.trace_summary = tr.summarize(tr.load_events(path))
        finally:
            path.unlink(missing_ok=True)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    after = program.counters()
    r.launches = {k: after[k] - before[k] for k in after}
    expect = cell.entry.launches(warm_batches + r.batches)
    r.expected_launches = expect if r.backend != "torch" and device.type == "cuda" else {}

    # what the window produced, then the program's state freed
    attempted = r.spectra
    r.gp_model = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(r, log=log)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metric_plan(bench, cell.name, kind):
        value = load_module(reader_path(m["name"], root)).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the last look: whatever the run, the comparison and the readers loaded
    found = forbidden_modules()
    launches_ok = all(r.launches.get(k) == v for k, v in r.expected_launches.items())
    correct = (not found and launches_ok and failed == 0
               and all(c["value"] <= c["limit"] for c in checks))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if r.trace_summary is not None:
        dev["busy_s"] = r.trace_summary.busy_us * 1e-6
        dev["window_s"] = r.trace_summary.window_us * 1e-6
        result["breakdown"] = {"device_ops": r.trace_summary.device_ops,
                               "idle_gaps": r.trace_summary.idle_gaps}
    result["run"] = {"calls": len(r.calls), "spectra": r.spectra, "window_s": r.window_s,
                     "setup_s": r.setup_s, "setup_phases": r.phases, "spectra_per_s": r.spectra / r.window_s,
                     "bytes_written": r.bytes_written, "launches": r.launches,
                     "expected_launches": r.expected_launches, "forbidden_modules": found,
                     "numbers": r.all_numbers}
    return result, checks


def compare(r: Run, log=print) -> list[dict]:
    """The comparison's numbers with their limits, on the sample of the
    window's finished spectra drawn from the seed."""
    cell, cfg = r.cell, r.cell.cfg
    chk = cell.spec["check"]
    done = {}
    for rows, out in r.outputs:
        for i, row in enumerate(rows):
            done[int(row)] = (out, i)
    finished = np.array(sorted(done))
    pick = check_rows(r, finished)
    n = len(pick)
    got = {}
    for key in done[int(pick[0])][0]:
        got[key] = np.stack([np.asarray(done[int(p)][0][key])[done[int(p)][1]] for p in pick])
    multi = cell.entry.MULTI
    t0 = time.perf_counter()
    ref = check.reference_for(cfg, r.model, r.samples, r.device,
                              plain_program=(r.backend == "torch"))
    priors = check.priors_of(cfg, r.catalogue, r.pool["z_qso"][pick])
    want = check.reference_outputs(ref, r.pool, pick, priors, multi, log_nhis=r.samples[2],
                                   spec=check.cddf_spec())
    nums = check.compare(ref, got, want, multi, spec=check.cddf_spec())
    log(f"reference of {n} spectra in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    r.all_numbers = nums
    limits = chk["limits"]
    return [{"name": k, "value": nums[k], "limit": v} for k, v in limits.items()]


def _seed_words(seed: int):
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]
