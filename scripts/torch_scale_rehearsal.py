"""Survey-scale kill-and-resume rehearsal of the PyTorch port: 16,384
sightlines, two SIGKILLs, a resume, and the result bit for bit that of
an uninterrupted run.

The counterpart of ``validation/scale_rehearsal.py``.  The full
two-stage {0,1,2}-DLA flow (``Pipeline.run_inference``, then
``Pipeline.run_multi``: the classic flow, full sample matrices,
per-batch checkpoints) over 16,384 synthetic sightlines x 10,000 QMC
samples, on the card in float32 through the kernels by default, is
killed with SIGKILL once during the single-DLA stage and once during
the pair stage, resumed, and required to give BIT-IDENTICAL results to
an uninterrupted run.

Protocol (``python scripts/torch_scale_rehearsal.py``):
  1. build  - synthesize the universe once, save the stage artifacts
  2. run A  - SIGKILL while the single-DLA manifest is mid-flight
  3. run A  - resume; SIGKILL while the pair manifest is mid-flight
  4. run A  - resume to completion
  5. run B  - uninterrupted, fresh checkpoint directory
  6. compare A with B field by field (np.array_equal, NaN-aware)
The report goes to stdout and to ``<workdir>/rehearsal_report.md``; the
last lines are ``REHEARSAL {json}`` and ``SCALE REHEARSAL OK``.

The subcommands ``build`` and ``run`` exist so that the orchestrator can
run each worker in a process of its own (a SIGKILL must take down a
real process).  Each worker prints ``RUN COMPLETE {json}`` with its
stage seconds and the launches of every kernel it made, which the
orchestrator holds to the batches the worker computed.  Without a CUDA
device pass ``--device cpu`` (the plain path); a default run that finds
no card raises.

Run:  python scripts/torch_scale_rehearsal.py [--n-spectra 16384]
      [--batch 1024] [--seed 40] [--workdir runs/torch_scale_rehearsal]
      [--device cpu]
Disk: ~3.3 GB per run at 16,384 sightlines (float32 (N, S) matrices in
the checkpoints and the result files), two runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# the port's package from this checkout, as every worker process needs it
sys.path.insert(0, str(HERE.parent))

DEFAULT_N = 16384
PER_DEVICE_BATCH = 1024
NUM_SAMPLES = 10000
DEFAULT_WORKDIR = "runs/torch_scale_rehearsal"
RESULT_FILES = ("processed_qsos_dr12q.npz", "processed_qsos_multi_dr12q.npz")


def _artifacts(workdir: Path) -> Path:
    return workdir / "artifacts"


def rehearsal_params(num_samples: int = NUM_SAMPLES):
    """The harness's parameters: the defaults with k = 20 (and the QMC
    sample count, when cut)."""
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters

    params = Parameters(null_model=NullModelParams(k=20))
    if num_samples != params.dla_sampling.num_dla_samples:
        params = dataclasses.replace(
            params,
            dla_sampling=dataclasses.replace(params.dla_sampling, num_dla_samples=num_samples),
        )
    return params


def build(workdir: Path, n_spectra: int = DEFAULT_N, seed: int = 40,
          num_samples: int = NUM_SAMPLES, device: str | None = None) -> dict:
    """Synthesize the universe and save the stage artifacts the two
    inference stages consume (catalog, ragged spectra, model, samples),
    drawn in the JAX harness's order from ``np.random.default_rng(seed)``.
    The injected profiles are computed in float32 on ``device`` (the
    card by default).  Returns the seconds of the synthesis, of the
    saves, and of the ragged spectra's save alone."""
    import torch

    from gp_dla_detection_tpu_torch.catalog import Catalog, DLACatalog
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.ops.voigt import voigt_absorption
    from gp_dla_detection_tpu_torch.params import kms_to_z
    from gp_dla_detection_tpu_torch.runtime import default_device
    from gp_dla_detection_tpu_torch.samples import generate_dla_samples
    from gp_dla_detection_tpu_torch.spectra import RaggedSpectra

    dev = default_device(device)
    rng = np.random.default_rng(seed)
    params = rehearsal_params(num_samples)
    grid = params.null_model.rest_wavelengths()
    mu = (1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2)
          + 0.1 * np.sin(grid / 60.0))
    M = rng.normal(size=(grid.size, 20)) * 0.04
    model = GPModel.from_numpy(
        grid, mu, M, np.log(0.12 + 0 * grid), np.log(0.1), np.log(0.0023), np.log(3.65),
        device="cpu", dtype=torch.float64,
    )

    lya = 1215.6701
    noise_sd = 0.1
    z_qso = rng.uniform(2.4, 3.4, n_spectra)
    t0 = time.perf_counter()
    # a fixed full-width grid, truncated per sightline at the end
    P = params.pixel_pad
    n_px_arr = rng.integers(1000, P + 1, n_spectra)
    lam_full = (911.9 * (1 + z_qso))[:, None] * (10 ** (1e-4 * np.arange(P)))[None, :]
    flux_full = np.empty((n_spectra, P))
    for i in range(n_spectra):
        rest = lam_full[i] / (1 + z_qso[i])
        flux_full[i] = (
            np.interp(rest, grid, mu)
            + np.interp(rest, grid, M @ rng.normal(size=20))
            + rng.normal(0, noise_sd, P)
        )

    # ~30% of sightlines host one DLA inside their searchable range, and
    # ~20% of those a second at >= 3x the pair-selection separation cut
    # (so that the two-DLA counting prior is not zero and the pair stage
    # is tested two-sided)
    min_sep_log = float(np.log1p(kms_to_z(3000.0)))
    dla_flag = np.zeros(n_spectra, bool)
    z_rows: list[np.ndarray] = [np.empty(0)] * n_spectra
    n_rows: list[np.ndarray] = [np.empty(0)] * n_spectra
    inj: list[tuple[int, float, float]] = []
    for i in range(n_spectra):
        if rng.uniform() >= 0.3:
            continue
        last = lam_full[i, n_px_arr[i] - 1]
        zmin = max(
            lam_full[i, 0] / lya - 1,
            911.7633 * (1 + z_qso[i]) / lya - 1 + params.min_z_cut,
        )
        zmax = (
            min(last, params.null_model.max_lambda * (1 + z_qso[i]))
            / lya - 1 - params.max_z_cut
        )
        if zmax > zmin:
            z_dla = rng.uniform(zmin, zmax)
            entries = [(z_dla, rng.uniform(20.3, 21.8))]
            if rng.uniform() < 0.2:
                for _ in range(12):
                    z2 = rng.uniform(zmin, zmax)
                    if abs(np.log1p(z2) - np.log1p(z_dla)) > 3 * min_sep_log:
                        entries.append((z2, rng.uniform(20.3, 21.5)))
                        break
            inj.extend((i, z, ln) for z, ln in entries)
            dla_flag[i] = True
            z_rows[i] = np.array([z for z, _ in entries])
            n_rows[i] = np.array([ln for _, ln in entries])

    # the absorption profiles in float32 chunks, with the JAX harness's
    # log-continuation padding (its rounding, not extend_wavelengths')
    w = params.instrument.width
    dex = 10 ** (params.instrument.pixel_spacing * np.arange(1, w + 1))
    chunk_rows = 4096
    for c0 in range(0, len(inj), chunk_rows):
        chunk = inj[c0 : c0 + chunk_rows]
        idx = np.array([i for i, _, _ in chunk])
        lam_c = lam_full[idx]
        ext = np.concatenate([lam_c[:, :1] / dex[::-1], lam_c, lam_c[:, -1:] * dex], axis=1)
        as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        absorb = voigt_absorption(
            as_f32(ext),
            as_f32([[z] for _, z, _ in chunk]),
            as_f32([[10.0**ln] for _, _, ln in chunk]),
            num_lines=3,
        )[:, 0].cpu().numpy()
        # unbuffered: a sightline hosting TWO absorbers appears twice in
        # idx, and fancy-index *= would apply only one of them
        np.multiply.at(flux_full, idx, absorb)

    waves, fluxes, noises, masks = [], [], [], []
    for i in range(n_spectra):
        n_px = int(n_px_arr[i])
        pm = np.zeros(n_px, bool)
        pm[rng.choice(n_px, size=8, replace=False)] = True
        waves.append(lam_full[i, :n_px])
        fluxes.append(flux_full[i, :n_px])
        noises.append(np.full(n_px, noise_sd**2))
        masks.append(pm)
    synth_s = time.perf_counter() - t0
    print(f"built {n_spectra} sightlines in {synth_s:.1f}s", flush=True)

    spectra = RaggedSpectra.from_lists(waves, fluxes, noises, masks, np.ones(n_spectra))
    catalog = Catalog(
        sdss_names=np.array([f"J{i:017d}" for i in range(n_spectra)]),
        ras=rng.uniform(0, 360, n_spectra),
        decs=rng.uniform(-10, 70, n_spectra),
        thing_ids=np.arange(n_spectra, dtype=np.int64),
        plates=np.full(n_spectra, 4055, np.int64),
        mjds=np.full(n_spectra, 55359, np.int64),
        fiber_ids=np.arange(1, n_spectra + 1, dtype=np.int64),
        z_qsos=z_qso,
        snrs=rng.uniform(1, 20, n_spectra),
        bal_visual_flags=np.zeros(n_spectra, bool),
        in_dr9=np.ones(n_spectra, bool),
        in_dr10=np.ones(n_spectra, bool),
        filter_flags=np.zeros(n_spectra, np.uint8),
        dla_catalogs={
            "dr9q_concordance": DLACatalog(
                los_ind=np.ones(n_spectra, bool), dla_ind=dla_flag, z_dlas=z_rows,
                log_nhis=n_rows,
            )
        },
    )
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)

    art = _artifacts(workdir)
    art.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    catalog.save(art / "catalog.npz")
    t1 = time.perf_counter()
    spectra.save(art / "preloaded_qsos.npz")
    spectra_s = time.perf_counter() - t1
    model.save(art / "model.npz")
    samples.save(art / "samples.npz")
    save_s = time.perf_counter() - t0
    print(f"artifacts saved in {save_s:.1f}s (the ragged spectra {spectra_s:.1f}s)", flush=True)
    return {"synthesize_s": synth_s, "save_s": save_s, "spectra_save_s": spectra_s}


def launch_counts() -> dict:
    """This process's launches of every kernel of the port."""
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn, redraw

    return {
        "single": evidence.launch_count, "pair": evidence.pair_launch_count,
        "null": low_rank_mvn.launch_count, "redraw": redraw.launch_count,
        "cddf": cddf_inputs.launch_count,
    }


def load_artifacts(workdir: Path, device):
    """(catalog, spectra, model on ``device`` in float64, samples)."""
    import torch

    from gp_dla_detection_tpu_torch.catalog import Catalog
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.samples import DLASamples
    from gp_dla_detection_tpu_torch.spectra import RaggedSpectra

    art = _artifacts(workdir)
    return (
        Catalog.load(art / "catalog.npz"),
        RaggedSpectra.load(art / "preloaded_qsos.npz"),
        GPModel.load(art / "model.npz", device=device, dtype=torch.float64),
        DLASamples.load(art / "samples.npz"),
    )


def run(workdir: Path, run_name: str, batch: int = PER_DEVICE_BATCH, stage: str = "both",
        device: str | None = None, dtype: str = "float32",
        backend: str | None = None) -> dict:
    """One worker pass: run_inference (and, with stage="both", run_multi)
    under workdir/<run_name>, resuming from whatever checkpoints exist.
    stage="inference" is the reference's own headline workload (the
    single-DLA {0,1} selection of process_qsos.m), used by
    torch_survey_run.py at DR12Q scale.  Returns (and prints after ``RUN
    COMPLETE``) the stage seconds and the kernel launches."""
    from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig
    from gp_dla_detection_tpu_torch.runtime import default_device

    dev = default_device(device)
    catalog, spectra, model, samples = load_artifacts(workdir, dev)
    pipe = Pipeline(
        rehearsal_params(),
        PipelineConfig(
            workdir=str(workdir / run_name), per_device_batch=batch, dtype=dtype,
            backend=backend, device=str(dev),
        ),
    )
    timings = {}
    t0 = time.time()
    results = pipe.run_inference(catalog, spectra, model, samples)
    timings["inference_s"] = round(time.time() - t0, 2)
    if stage == "both":
        test_mask = Pipeline.default_test_mask(catalog, spectra)
        t0 = time.time()
        pipe.run_multi(catalog, spectra, model, samples, results, test_mask)
        timings["multi_s"] = round(time.time() - t0, 2)
    timings["launches"] = launch_counts()
    (workdir / run_name / "timings.json").write_text(json.dumps(timings))
    print(f"RUN COMPLETE {json.dumps(timings)}", flush=True)
    return timings


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _manifest_count(path: Path) -> int:
    try:
        return len(json.loads(path.read_text())["completed_batches"])
    except (FileNotFoundError, json.JSONDecodeError, KeyError):
        return 0


def worker_process(script: Path, argv: list[str], log: Path) -> subprocess.Popen:
    """``script`` with ``argv`` in a process of its own, its output in
    ``log``."""
    with open(log, "w") as fh:  # the child keeps its own descriptor
        proc = subprocess.Popen(
            [sys.executable, str(script), *argv], stdout=fh, stderr=subprocess.STDOUT,
            text=True,
        )
    proc._log_path = log  # type: ignore[attr-defined]
    return proc


def device_args(device: str | None) -> list[str]:
    return [] if device is None else ["--device", device]


def kernels_expected(device: str | None) -> bool:
    """Whether a worker on ``device`` runs the kernels (the card's
    default backend)."""
    return (device or "cuda").startswith("cuda")


def _launch(workdir: Path, run_name: str, batch: int, tag: str,
            device: str | None) -> subprocess.Popen:
    return worker_process(
        HERE / "torch_scale_rehearsal.py",
        ["run", "--workdir", str(workdir), "--run-name", run_name, "--batch", str(batch),
         *device_args(device)],
        workdir / f"worker_{tag}_{run_name}.log",
    )


def _kill_when(proc: subprocess.Popen, manifest: Path, at_least: int,
               timeout: float = 3600.0) -> int:
    """SIGKILL the worker once ``manifest`` shows >= at_least completed
    batches.  Returns the completed-batch count at kill time.

    The manifest is checked BEFORE the process: a worker that crosses
    the kill point and exits within one poll interval must count as
    reaching it (killing an already-dead process is a no-op), not raise
    a spurious 'exited before the kill point'.
    """
    t0 = time.time()
    while time.time() - t0 < timeout:
        n = _manifest_count(manifest)
        if n >= at_least:
            proc.kill()
            proc.wait()
            return n
        if proc.poll() is not None:
            state = (
                "completed the whole run before the kill point — "
                "n_spectra/batch too small to exercise kill/resume "
                f"(need at_least={at_least} < total batches)"
                if proc.returncode == 0
                else f"crashed (rc={proc.returncode})"
            )
            raise RuntimeError(
                f"worker {state}; see {getattr(proc, '_log_path', '?')}"
            )
        time.sleep(1.0)
    proc.kill()
    proc.wait()
    raise TimeoutError(f"kill point not reached within {timeout}s")


def _wait_ok(proc: subprocess.Popen, what: str) -> float:
    t0 = time.time()
    proc.wait()
    if proc.returncode != 0:
        log = getattr(proc, "_log_path", None)
        tail = log.read_text()[-3000:] if log else ""
        raise RuntimeError(f"{what} failed (rc={proc.returncode}):\n{tail}")
    return time.time() - t0


def was_killed(proc: subprocess.Popen) -> bool:
    """Whether the SIGKILL took the worker down (not already exited)."""
    return proc.returncode == -signal.SIGKILL


def marked_json(text: str, marker: str) -> dict:
    """The JSON printed after ``marker`` on a line of ``text``."""
    for line in text.splitlines():
        if line.startswith(marker + " {"):
            return json.loads(line[len(marker) + 1:])
    raise RuntimeError(f"no {marker!r} line")


def completion(proc: subprocess.Popen, marker: str) -> dict:
    """The JSON a finished worker printed after ``marker``."""
    return marked_json(proc._log_path.read_text(), marker)  # type: ignore[attr-defined]


def pending_batches(stage_dir: Path, result: str, manifest: Path, n_batches: int) -> int:
    """The batches a worker about to start computes in one stage: none
    when the stage's result file exists, else those its manifest lacks."""
    return 0 if (stage_dir / result).exists() else n_batches - _manifest_count(manifest)


def check_launches(got: dict, expected: dict, what: str) -> None:
    """Each kernel's launches equal to the batches that ran it."""
    bad = {k: (got[k], v) for k, v in expected.items() if got[k] != v}
    if bad:
        raise SystemExit(f"{what}: launches (made, batches) {bad}")


def checkpoint_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("batch_*.npz"))


def compare_results(dir_a: Path, dir_b: Path, files) -> list[str]:
    """The arrays of ``files`` that differ between the two run
    directories (np.array_equal, NaN-aware for floats)."""
    mismatches = []
    for fname in files:
        with np.load(dir_a / fname) as fa, np.load(dir_b / fname) as fb:
            if set(fa.files) != set(fb.files):
                mismatches.append(f"{fname}: keys {sorted(set(fa.files) ^ set(fb.files))}")
                continue
            for key in fa.files:
                a, b = fa[key], fb[key]
                same = a.shape == b.shape and (
                    np.array_equal(a, b, equal_nan=True)
                    if np.issubdtype(a.dtype, np.floating)
                    else np.array_equal(a, b)
                )
                if not same:
                    mismatches.append(f"{fname}:{key}")
    return mismatches


def orchestrate(workdir: Path, n_spectra: int = DEFAULT_N, batch: int = PER_DEVICE_BATCH,
                seed: int = 40, num_samples: int = NUM_SAMPLES,
                device: str | None = None) -> dict:
    """The protocol of the module docstring; returns the summary that
    the ``REHEARSAL`` line prints.  Raises SystemExit when the resumed
    run differs from the uninterrupted one or a worker's launches differ
    from its batches."""
    workdir.mkdir(parents=True, exist_ok=True)
    built = None
    if not (_artifacts(workdir) / "samples.npz").exists():
        t0 = time.time()
        built = build(workdir, n_spectra, seed, num_samples, device)
        built["build_s"] = time.time() - t0

    report: list[str] = [
        f"# Survey-scale rehearsal of the PyTorch port: kill/resume at {n_spectra} sightlines",
        "",
        f"- {n_spectra} synthetic sightlines x {num_samples:,} QMC samples, "
        "two-stage {0,1,2}-DLA model selection (the classic flow)",
        f"- Pipeline.run_inference + run_multi on {device or 'cuda'} "
        f"({'float32, the kernels' if kernels_expected(device) else 'the plain path'}), "
        f"super-batch {batch}, float32 (N, S) matrices, per-batch checkpoints "
        "(atomic writes, background writer), the pipelined loop",
        "",
    ]

    def say(line: str) -> None:
        report.append(line)
        print(line, flush=True)

    if built is not None:
        say(f"- universe build: {built['build_s']:.1f} s (synthesis "
            f"{built['synthesize_s']:.1f} s, artifacts saved {built['save_s']:.1f} s, of "
            f"which the ragged spectra {built['spectra_save_s']:.1f} s)")
    run_a = workdir / "runA"
    inf_manifest = run_a / "inference_ckpt" / "manifest.json"
    pair_manifest = run_a / "multi_ckpt" / "pair" / "manifest.json"
    n_batches = -(-n_spectra // batch)

    # leg 1: kill during the single-DLA stage
    t0 = time.time()
    proc = _launch(workdir, "runA", batch, "leg1", device)
    killed_at_1 = _kill_when(proc, inf_manifest, max(2, n_batches // 4))
    leg1 = time.time() - t0
    killed = [was_killed(proc)]
    say(f"- leg 1: SIGKILL during single-DLA stage at {killed_at_1}/{n_batches} "
        f"checkpointed batches ({leg1:.1f} s in"
        f"{'' if killed[-1] else '; the worker had already exited'})")

    # leg 2: resume; kill during the pair stage
    t0 = time.time()
    proc = _launch(workdir, "runA", batch, "leg2", device)
    killed_at_2 = _kill_when(proc, pair_manifest, max(2, n_batches // 4))
    leg2 = time.time() - t0
    killed.append(was_killed(proc))
    say(f"- leg 2: resumed ({_manifest_count(inf_manifest)}/{n_batches} single-DLA batches "
        f"on disk); SIGKILL during pair stage at {killed_at_2}/{n_batches} batches "
        f"({leg2:.1f} s in{'' if killed[-1] else '; the worker had already exited'})")

    # leg 3: resume to completion
    expected_3 = {
        "single": pending_batches(run_a, RESULT_FILES[0], inf_manifest, n_batches),
        "pair": pending_batches(run_a, RESULT_FILES[1], pair_manifest, n_batches),
    }
    proc = _launch(workdir, "runA", batch, "leg3", device)
    leg3 = _wait_ok(proc, "resumed run")
    done_3 = completion(proc, "RUN COMPLETE")
    say(f"- leg 3: resumed to completion in {leg3:.1f} s (computed {expected_3['single']} "
        f"single-DLA and {expected_3['pair']} pair batches; launches {done_3['launches']})")

    # leg B: uninterrupted reference run
    proc = _launch(workdir, "runB", batch, "legB", device)
    leg_b = _wait_ok(proc, "uninterrupted run")
    timings = completion(proc, "RUN COMPLETE")
    rate_inf = n_spectra / timings["inference_s"]
    rate_pair = n_spectra / timings["multi_s"]
    rate_total = n_spectra / (timings["inference_s"] + timings["multi_s"])
    say(f"- uninterrupted run: {leg_b:.1f} s wall (single-DLA {timings['inference_s']} s = "
        f"{rate_inf:.0f} spectra/s, pair {timings['multi_s']} s = {rate_pair:.0f} spectra/s; "
        f"two-stage sustained {rate_total:.0f} spectra/s; launches {timings['launches']})")

    mismatches = compare_results(run_a, workdir / "runB", RESULT_FILES)
    if mismatches:
        say(f"- BIT-IDENTITY FAILED: {mismatches}")
    else:
        say("- kill/resume run is BIT-IDENTICAL to the uninterrupted run "
            "(every array in both result files, NaN-aware equality)")
    ckpt = checkpoint_bytes(workdir / "runB")
    results_bytes = sum((workdir / "runB" / f).stat().st_size for f in RESULT_FILES)
    say(f"- checkpoint volume (uninterrupted run): {ckpt / 1e6:.0f} MB across per-batch "
        f"files, written on a background thread; result files {results_bytes / 1e6:.0f} MB")
    (workdir / "rehearsal_report.md").write_text("\n".join(report) + "\n")

    summary = {
        "n_spectra": n_spectra, "num_samples": num_samples, "batch": batch,
        "n_batches": n_batches, "kill_points": [killed_at_1, killed_at_2], "killed": killed,
        "leg_s": {"leg1": leg1, "leg2": leg2, "leg3": leg3, "runB": leg_b},
        "stage_s": {"inference": timings["inference_s"], "multi": timings["multi_s"]},
        "spectra_per_s": {"inference": rate_inf, "multi": rate_pair, "two_stage": rate_total},
        "build_s": None if built is None else built["build_s"],
        "build": built, "checkpoint_mb": ckpt / 1e6, "result_files_mb": results_bytes / 1e6,
        "launches": {"leg3": done_3["launches"], "runB": timings["launches"]},
        "expected_launches": {"leg3": expected_3,
                              "runB": {"single": n_batches, "pair": n_batches}},
        "identical": not mismatches, "mismatches": mismatches,
    }
    print("REHEARSAL " + json.dumps(summary), flush=True)
    if mismatches:
        raise SystemExit("bit-identity check failed")
    if kernels_expected(device):
        # one single (and null) launch per single-stage batch, one pair
        # launch per pair-stage batch, in every worker that finished
        for leg, exp in summary["expected_launches"].items():
            got = summary["launches"][leg]
            check_launches(got, {**exp, "null": exp["single"]}, leg)
    print("SCALE REHEARSAL OK", flush=True)
    return summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cmd", nargs="?", default="orchestrate",
                   choices=["orchestrate", "build", "run"])
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--run-name", default="runA")
    p.add_argument("--n-spectra", type=int, default=DEFAULT_N)
    p.add_argument("--batch", type=int, default=PER_DEVICE_BATCH)
    p.add_argument("--stage", default="both", choices=["both", "inference"])
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--num-samples", type=int, default=NUM_SAMPLES,
                   help="QMC samples of the universe (build, orchestrate)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain path)")
    a = p.parse_args(argv)
    wd = Path(a.workdir)
    if a.cmd == "build":
        build(wd, a.n_spectra, a.seed, a.num_samples, a.device)
    elif a.cmd == "run":
        run(wd, a.run_name, a.batch, a.stage, a.device)
    else:
        orchestrate(wd, a.n_spectra, a.batch, a.seed, a.num_samples, a.device)


if __name__ == "__main__":
    main()
