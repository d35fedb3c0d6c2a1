"""DR12Q-scale survey of the PyTorch port on one card: 162,861
sightlines through the single-DLA stage, with a SIGKILL and a resume.

The counterpart of ``validation/survey_run.py``.  The reference's
headline workload is process_qsos.m over the 162,861 non-filtered DR12Q
sightlines (the reference's README.md:113-116): single-DLA {0,1}
Bayesian model selection, 10,000 QMC samples per sightline, ragged
1000-1274 px spectra.  This harness runs that workload size through
``Pipeline.run_inference`` (the sharded single-DLA driver, float32, the
kernels, per-batch checkpoints) on one card, killed once and resumed.

Protocol (``python scripts/torch_survey_run.py``):
  1. build   - synthesize the 162,861-sightline universe
               (torch_scale_rehearsal.build: ~30% host an injected DLA
               whose truth lands in the catalogue artifact)
  2. leg 1   - run the single-DLA stage; SIGKILL at a third
  3. leg 2   - resume to completion
  4. report  - rates, detection against the injection truth, the
               checkpoint volume
``--pair`` then runs the classic pair stage over the completed single
stage and appends the {0,1,2} confusion against the truth.  The report
goes to stdout and to ``<workdir>/survey_report.md``.

Bit-identity of kill/resume against an uninterrupted run is shown at
16,384 by ``torch_scale_rehearsal.py`` (same driver and checkpoints);
this harness shows the scale.

Run:  python scripts/torch_survey_run.py [--workdir runs/torch_survey]
      [--n-spectra 162861] [--batch 1024] [--pair] [--device cpu]
Disk at 162,861: ~4 GB of artifacts, 6.5 GB of single-stage checkpoints
and 6.5 GB of results (float32 (N, S) matrices); --pair adds ~26 GB.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from torch_scale_rehearsal import (  # noqa: E402
    NUM_SAMPLES,
    PER_DEVICE_BATCH,
    _artifacts,
    _kill_when,
    _manifest_count,
    _wait_ok,
    build,
    check_launches,
    checkpoint_bytes,
    completion,
    device_args,
    kernels_expected,
    was_killed,
    worker_process,
)

DR12Q_N = 162861  # the reference's README.md:113-116
# DR12Q in one hour on one card: the bench's vs_baseline (PERF.md)
ONE_HOUR_RATE = DR12Q_N / 3600.0
DEFAULT_WORKDIR = "runs/torch_survey"


def _launch(workdir: Path, batch: int, tag: str, device: str | None,
            stage: str = "inference"):
    return worker_process(
        HERE / "torch_scale_rehearsal.py",
        ["run", "--workdir", str(workdir), "--run-name", "survey", "--batch", str(batch),
         "--stage", stage, *device_args(device)],
        workdir / f"survey_{tag}.log",
    )


def truth_multiplicity(catalog) -> np.ndarray:
    """Injected absorbers per sightline, capped at 2."""
    dc = catalog.dla_catalogs["dr9q_concordance"]
    return np.array([min(len(z), 2) for z in dc.z_dlas])


def pair_stage(workdir: Path, batch: int = PER_DEVICE_BATCH, device: str | None = None) -> dict:
    """The two-DLA stage over the full catalogue, reusing the completed
    single stage on disk (the pipeline's stage resume).  Appends to the
    report: wall, rate, and the 3x3 multiplicity confusion against the
    injection truth (the universe hosts 0-, 1- and 2-DLA sightlines, so
    the check is two-sided)."""
    from gp_dla_detection_tpu_torch.catalog import Catalog

    t0 = time.time()
    proc = _launch(workdir, batch, "pair", device, stage="both")
    _wait_ok(proc, "full-catalog pair stage")
    wall = time.time() - t0
    timings = completion(proc, "RUN COMPLETE")
    pair_s = timings["multi_s"]

    catalog = Catalog.load(_artifacts(workdir) / "catalog.npz")
    truth_mult = truth_multiplicity(catalog)
    with np.load(workdir / "survey" / "processed_qsos_multi_dr12q.npz") as f:
        mult = np.argmax(f["multi_model_posteriors"], axis=1)
    n = truth_mult.size
    confusion = {
        (t, m): int(((truth_mult == t) & (mult == m)).sum())
        for t in (0, 1, 2) for m in (0, 1, 2)
    }
    exact = float((mult == truth_mult).mean())
    if not (truth_mult == 2).any():
        raise SystemExit("the universe must host 2-DLA sightlines for a two-sided validation")
    rate = n / pair_s
    lines = [
        "",
        "## Two-stage follow-up (full catalog {0,1,2}-DLA selection)",
        "",
        f"- pair stage over all {n:,} sightlines: {pair_s:.0f} s = {rate:.0f} spectra/s on "
        f"one card ({wall:.0f} s wall including the worker restart; stage 1 resumed from "
        f"its saved results; launches {timings['launches']})",
        f"- exact-multiplicity accuracy vs injection truth: {exact:.4f} "
        f"(truth populations: {int((truth_mult == 0).sum()):,} clean, "
        f"{int((truth_mult == 1).sum()):,} single, {int((truth_mult == 2).sum()):,} double)",
        "- confusion [truth -> predicted multiplicity]: "
        + "; ".join(
            ", ".join(f"{name}->{m} {confusion[(t, m)]:,}" for m in (0, 1, 2))
            for t, name in ((0, "clean"), (1, "1-DLA"), (2, "2-DLA"))
        ),
    ]
    out = workdir / "survey_report.md"
    out.write_text((out.read_text() if out.exists() else "") + "\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    summary = {"n_spectra": n, "multi_s": pair_s, "wall_s": wall, "spectra_per_s": rate,
               "exact_multiplicity_acc": exact,
               "confusion": {f"{t}->{m}": v for (t, m), v in confusion.items()},
               "launches": timings["launches"]}
    print("SURVEY PAIR " + json.dumps(summary), flush=True)
    if not exact > 0.95:
        raise SystemExit(f"exact-multiplicity accuracy {exact} not above 0.95")
    print("SURVEY PAIR STAGE OK", flush=True)
    return summary


def orchestrate(workdir: Path, n_spectra: int = DR12Q_N, batch: int = PER_DEVICE_BATCH,
                seed: int = 40, num_samples: int = NUM_SAMPLES,
                device: str | None = None) -> dict:
    """The protocol of the module docstring; returns the summary that
    the ``SURVEY`` line prints."""
    from gp_dla_detection_tpu_torch.catalog import Catalog

    workdir.mkdir(parents=True, exist_ok=True)
    built = None
    if not (_artifacts(workdir) / "samples.npz").exists():
        t0 = time.time()
        built = build(workdir, n_spectra, seed, num_samples, device)
        built["build_s"] = time.time() - t0

    manifest = workdir / "survey" / "inference_ckpt" / "manifest.json"
    n_batches = -(-n_spectra // batch)

    t0 = time.time()
    proc = _launch(workdir, batch, "leg1", device)
    killed_at = _kill_when(proc, manifest, max(2, n_batches // 3), timeout=7200.0)
    leg1 = time.time() - t0
    killed = was_killed(proc)
    pending = n_batches - _manifest_count(manifest)
    t0 = time.time()
    proc = _launch(workdir, batch, "leg2", device)
    _wait_ok(proc, "resumed survey run")
    leg2 = time.time() - t0
    total = leg1 + leg2
    timings = completion(proc, "RUN COMPLETE")

    # detection accuracy against the injection truth in the catalogue
    catalog = Catalog.load(_artifacts(workdir) / "catalog.npz")
    truth = catalog.dla_catalogs["dr9q_concordance"].dla_ind
    with np.load(workdir / "survey" / "processed_qsos_dr12q.npz") as f:
        p_dla = f["p_dlas"]
    # every sightline of this universe passes the filters
    if p_dla.shape[0] != n_spectra:
        raise SystemExit(f"{p_dla.shape[0]} results for {n_spectra} sightlines")
    det = p_dla > 0.9
    detection_rate = float(det[truth].mean())
    false_pos = float(det[~truth].mean())

    rate = n_spectra / total
    # the resumed leg computes only the batches the kill left undone
    # (the rest load from checkpoints): its rate is over those spectra
    spectra_leg2 = n_spectra - (n_batches - pending) * batch
    # None: the first worker finished before its kill, so this one computed nothing
    rate_worker = spectra_leg2 / timings["inference_s"] if spectra_leg2 else None
    ckpt = checkpoint_bytes(workdir / "survey")
    on = device or "cuda"
    report = [
        f"# DR12Q-scale survey of the PyTorch port on one card: {n_spectra:,} sightlines",
        "",
        f"- workload: the reference's headline run (process_qsos.m over the {n_spectra:,} "
        f"non-filtered DR12Q sightlines, {num_samples:,} QMC samples each; README.md:113-116), "
        "synthetic universe with ~30% injected DLAs, ragged 1000-1274 px spectra",
        f"- driver: Pipeline.run_inference (the sharded single-DLA driver, super-batch "
        f"{batch}, float32 (N, S) matrices, per-batch atomic checkpoints on a background "
        f"writer, the pipelined loop) on {on}"
        f"{', the kernels' if kernels_expected(device) else ', the plain path'}",
        "",
        "- universe build: "
        + ("reused from the workdir" if built is None else
           f"{built['build_s']:.0f} s (synthesis {built['synthesize_s']:.0f} s, artifacts "
           f"saved {built['save_s']:.0f} s, of which the ragged spectra "
           f"{built['spectra_save_s']:.0f} s)"),
        f"- leg 1: SIGKILL at {killed_at}/{n_batches} checkpointed batches, {leg1:.0f} s in"
        f"{'' if killed else ' (the worker had already exited)'}",
        f"- leg 2: resumed to completion in {leg2:.0f} s (worker-internal inference time "
        f"{timings['inference_s']:.0f} s over the {spectra_leg2:,} spectra it actually "
        f"computed = {rate_worker or 0:.0f} spectra/s; launches {timings['launches']})",
        f"- total wall including the killed leg and both process startups/compiles: {total:.0f} s = "
        f"{rate:.0f} spectra/s sustained on one card",
        f"- against DR12Q in one hour on one card ({ONE_HOUR_RATE:.2f} spectra/s): "
        f"{rate / ONE_HOUR_RATE:.1f}x, kill included",
        "",
        f"- detection at p > 0.9: {detection_rate:.4f} of the {int(truth.sum()):,} injected "
        f"DLAs; false-positive rate {false_pos:.2e} over {int((~truth).sum()):,} clean "
        "sightlines",
        f"- checkpoint volume: {ckpt / 1e9:.2f} GB across {n_batches} per-batch float32 "
        "files (background writer)",
        "",
        "Kill/resume bit-identity for this driver and checkpoint format is shown at 16,384 "
        "by torch_scale_rehearsal.py; this run shows the full-catalog scale.",
    ]
    (workdir / "survey_report.md").write_text("\n".join(report) + "\n")
    print("\n".join(report), flush=True)
    summary = {
        "n_spectra": n_spectra, "batch": batch, "n_batches": n_batches,
        "build_s": None if built is None else built["build_s"], "build": built,
        "kill_point": killed_at, "killed": killed, "leg_s": {"leg1": leg1, "leg2": leg2},
        "inference_s_leg2": timings["inference_s"], "spectra_leg2": spectra_leg2,
        "spectra_per_s": {"leg2_worker": rate_worker, "sustained": rate},
        "detection_rate": detection_rate, "false_positive_rate": false_pos,
        "checkpoint_mb": ckpt / 1e6, "launches": timings["launches"],
        "expected_launches": {"single": pending, "null": pending},
    }
    print("SURVEY " + json.dumps(summary), flush=True)
    if kernels_expected(device):
        check_launches(timings["launches"], summary["expected_launches"], "leg 2")
    if not detection_rate > 0.97:
        raise SystemExit(f"detection rate {detection_rate} not above 0.97")
    if not false_pos < 0.01:
        raise SystemExit(f"false-positive rate {false_pos} not below 0.01")
    print("SURVEY RUN OK", flush=True)
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--n-spectra", type=int, default=DR12Q_N)
    p.add_argument("--batch", type=int, default=PER_DEVICE_BATCH)
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--num-samples", type=int, default=NUM_SAMPLES)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain path)")
    p.add_argument("--pair", action="store_true",
                   help="run the two-DLA stage over a completed survey workdir and append "
                   "its report")
    a = p.parse_args()
    if a.pair:
        pair_stage(Path(a.workdir), a.batch, a.device)
    else:
        orchestrate(Path(a.workdir), a.n_spectra, a.batch, a.seed, a.num_samples, a.device)
