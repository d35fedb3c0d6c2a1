"""One-command lean release of the PyTorch port at DR12Q scale, killed
once and resumed: the catalogue, its ASCII files and the statistics.

The counterpart of ``validation/survey_release.py``.  One pipeline
configuration, ``PipelineConfig(multi_dla=True,
store_sample_likelihoods=False, cddf_inputs=True)`` at the port's
defaults (the card, float32, the kernels): the fused lean two-stage
{0,1,2}-DLA chain with the CDDF inputs reduced on the device, then the
ASCII catalogues and ``analysis/statistics.json`` (CDDF, dN/dX,
Omega_DLA) with the reference figures.  When the classic full-matrix
catalogue of ``torch_survey_run.py --pair`` is in the same workdir, the
lean statistics are compared with the classic ``DLACatalogue``'s.

Protocol (``python scripts/torch_survey_release.py``), on the universe
in ``<workdir>/artifacts`` (``torch_survey_run.py``'s or the
rehearsal's; built here at ``--n-spectra`` when the workdir has none):
  leg 1 - the lean + CDDF multi stage over every sightline, SIGKILL at a
          third of the fused manifest
  leg 2 - resume to completion, then the ASCII stage
  then the analysis stage in this process, and the exact-multiplicity
  accuracy against the injection truth (above 0.95).
The report goes to stdout and to ``<workdir>/release_report.md``; the
last lines are ``RELEASE {json}`` and ``RELEASE OK``.  Each worker
prints ``WORKER COMPLETE {json}`` with its seconds and kernel launches.

Run:  python scripts/torch_survey_release.py [--workdir runs/torch_survey]
      [--batch 1024] [--run-name release] [--device cpu]
Disk at 162,861: ~4 GB of artifacts (when built here), ~2.1 GB of
checkpoints and ~0.3 GB of results.
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
    launch_counts,
    load_artifacts,
    rehearsal_params,
    was_killed,
    worker_process,
)
from torch_survey_run import DEFAULT_WORKDIR, DR12Q_N, ONE_HOUR_RATE, truth_multiplicity  # noqa: E402

LEAN = dict(multi_dla=True, store_sample_likelihoods=False, cddf_inputs=True)


def worker(workdir: Path, batch: int, device: str | None = None, run_name: str = "release",
           dtype: str = "float32", backend: str | None = None) -> dict:
    """The lean + CDDF multi stage and the ASCII stage under
    workdir/<run_name>, resuming from whatever checkpoints exist.
    Returns (and prints after ``WORKER COMPLETE``) the seconds, the
    ASCII files and the kernel launches."""
    from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig
    from gp_dla_detection_tpu_torch.runtime import default_device

    dev = default_device(device)
    catalog, spectra, model, samples = load_artifacts(workdir, dev)
    rel = workdir / run_name
    pipe = Pipeline(
        rehearsal_params(),
        PipelineConfig(workdir=str(rel), per_device_batch=batch, dtype=dtype, backend=backend,
                       device=str(dev), **LEAN),
    )
    samples.save(rel / "dla_samples.npz")
    test_mask = Pipeline.default_test_mask(catalog, spectra)
    t0 = time.time()
    multi = pipe.run_multi(catalog, spectra, model, samples, None, test_mask)
    t_multi = time.time() - t0
    t0 = time.time()
    paths = pipe.run_ascii(catalog, samples, multi.single, test_mask, multi)
    t_ascii = time.time() - t0
    out = {
        "multi_s": round(t_multi, 2), "ascii_s": round(t_ascii, 2),
        "ascii": {k: str(v) for k, v in paths.items()}, "launches": launch_counts(),
    }
    print("WORKER COMPLETE " + json.dumps(out), flush=True)
    return out


def _launch(workdir: Path, batch: int, tag: str, device: str | None, run_name: str):
    return worker_process(
        HERE / "torch_survey_release.py",
        ["--worker", "--workdir", str(workdir), "--batch", str(batch), "--run-name", run_name,
         *device_args(device)],
        workdir / f"release_worker_{tag}.log",
    )


def classic_stats(workdir: Path, z_lo: float, z_hi: float):
    """Full-survey statistics from the classic full-matrix catalogue
    (when present), for the lean-vs-classic A/B."""
    classic_path = workdir / "survey" / "processed_qsos_multi_dr12q.npz"
    if not classic_path.exists():
        return None
    from gp_dla_detection_tpu_torch.analysis.cddf import DLACatalogue
    from gp_dla_detection_tpu_torch.samples import DLASamples

    samples = DLASamples.load(_artifacts(workdir) / "samples.npz")
    with np.load(classic_path) as f:
        cat = DLACatalogue(
            f["p_dlas"], f["min_z_dlas"], f["max_z_dlas"],
            f["sample_log_likelihoods_dla"], f["log_likelihoods_dla"],
            samples.offset_samples, samples.log_nhi_samples,
            sample_log_likelihoods_2=f["sample_log_likelihoods_dla2"],
            base_sample_inds=f["base_sample_inds"],
            p_dla_2=f["multi_model_posteriors"][:, 2],
        )
    return {
        "cddf": cat.column_density_function(z_min=1.0, z_max=6.0)[1],
        "dndx": cat.line_density(z_min=z_lo, z_max=z_hi)[1],
        "omega_direct": cat.omega_dla(z_min=z_lo, z_max=z_hi)[1],
        "omega_cddf": cat.omega_dla_cddf(z_min=z_lo, z_max=z_hi)[1],
    }


def orchestrate(workdir: Path, batch: int = PER_DEVICE_BATCH, device: str | None = None,
                run_name: str = "release", n_spectra: int = DR12Q_N, seed: int = 40,
                num_samples: int = NUM_SAMPLES) -> dict:
    """The protocol of the module docstring; returns the summary that
    the ``RELEASE`` line prints."""
    from gp_dla_detection_tpu_torch.catalog import Catalog
    from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig

    art = _artifacts(workdir)
    built = None
    if not (art / "samples.npz").exists():
        workdir.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        built = build(workdir, n_spectra, seed, num_samples, device)
        built["build_s"] = time.time() - t0
    rel = workdir / run_name
    manifest = rel / "multi_ckpt" / "fused" / "manifest.json"
    catalog = Catalog.load(art / "catalog.npz")
    n = int(catalog.z_qsos.size)
    n_batches = -(-n // batch)

    t0 = time.time()
    proc = _launch(workdir, batch, "leg1", device, run_name)
    killed_at = _kill_when(proc, manifest, max(2, n_batches // 3), timeout=7200.0)
    leg1 = time.time() - t0
    killed = was_killed(proc)
    pending = n_batches - _manifest_count(manifest)
    t0 = time.time()
    proc = _launch(workdir, batch, "leg2", device, run_name)
    _wait_ok(proc, "resumed release run")
    leg2 = time.time() - t0
    done = completion(proc, "WORKER COMPLETE")
    total = leg1 + leg2
    rate = n / total

    # ---- analysis stage (in process: statistics + plots) ----
    pipe = Pipeline(
        rehearsal_params(),
        PipelineConfig(workdir=str(rel), device=device or "cuda", **LEAN),
    )
    t0 = time.time()
    stats = pipe.run_analysis(force=True)
    t_stats = time.time() - t0
    if stats["lean_inputs"] is not True:
        raise SystemExit("the analysis stage did not read the lean CDDF inputs")

    # ---- truth accounting ----
    truth_mult = truth_multiplicity(catalog)
    with np.load(rel / "processed_qsos_multi_dr12q.npz") as f:
        mult = np.argmax(f["multi_model_posteriors"], axis=1)
    exact = float((mult == truth_mult).mean())

    z_lo, z_hi = 2.0, 5.0
    t0 = time.time()
    ref = classic_stats(workdir, z_lo, z_hi)
    t_classic = time.time() - t0
    agreement = []
    if ref is not None:
        lean_vals = {
            "cddf": np.asarray(stats["cddf"]["f_N"]),
            "dndx": np.asarray(stats["line_density"]["dN_dX"]),
            "omega_direct": np.asarray(stats["omega_dla_direct"]["omega"]),
            "omega_cddf": np.asarray(stats["omega_dla_cddf"]["omega"]),
        }
        for k, v in lean_vals.items():
            r = np.asarray(ref[k], np.float64)
            m = min(r.size, v.size)
            denom = np.maximum(np.abs(r[:m]), np.abs(r).max() * 1e-3 + 1e-300)
            agreement.append(
                f"- lean-vs-classic {k} ({n:,}): max rel "
                f"{np.max(np.abs(v[:m] - r[:m]) / denom):.2e}"
            )
        agreement.append(
            f"- classic statistics pass: {t_classic:.0f} s (float64 normalization of the "
            f"(N, S) matrices) vs lean {t_stats:.0f} s"
        )
    else:
        agreement.append(
            "- classic catalog not present — lean-vs-classic survey statistics A/B skipped "
            "(run torch_survey_run.py and torch_survey_run.py --pair first)"
        )

    arts = sorted(str(p.relative_to(rel)) for p in rel.glob("**/*")
                  if p.is_file() and "ckpt" not in str(p))
    ckpt = checkpoint_bytes(rel)
    lines = [
        f"# One-command lean release of the PyTorch port: {n:,} sightlines",
        "",
        "- configuration: `PipelineConfig(multi_dla=True, store_sample_likelihoods=False, "
        "cddf_inputs=True)` at the port's defaults — the fused lean two-stage chain with "
        f"device-reduced CDDF inputs, super-batch {batch}, on {device or 'cuda'}"
        f"{', the kernels' if kernels_expected(device) else ', the plain path'}",
        "- universe build: "
        + ("reused from the workdir" if built is None else
           f"{built['build_s']:.0f} s (synthesis {built['synthesize_s']:.0f} s, artifacts "
           f"saved {built['save_s']:.0f} s, of which the ragged spectra "
           f"{built['spectra_save_s']:.0f} s)"),
        f"- leg 1: SIGKILL at {killed_at}/{n_batches} checkpointed batches, {leg1:.0f} s in"
        f"{'' if killed else ' (the worker had already exited)'}; leg 2 resumed to "
        f"completion in {leg2:.0f} s (multi stage {done['multi_s']} s over {pending} "
        f"batches, ASCII {done['ascii_s']} s; launches {done['launches']})",
        f"- total wall incl. the killed leg, both startups/compiles, and the ASCII stage: "
        f"{total:.0f} s "
        f"= {rate:.0f} spectra/s for the complete catalog + science inputs "
        f"({rate / ONE_HOUR_RATE:.1f}x DR12Q in one hour on one card)",
        f"- L7 statistics + plots from the lean inputs: {t_stats:.0f} s",
        f"- checkpoint volume: {ckpt / 1e6:.1f} MB",
        f"- exact-multiplicity accuracy vs injection truth: {exact:.4f}",
        "",
        *agreement,
        "",
        "Artifacts under the release workdir: "
        + ", ".join(a for a in arts if not a.startswith("analysis/"))
        + f", plus {sum(a.startswith('analysis/') for a in arts)} "
        "statistics/figure/table files under analysis/",
    ]
    (workdir / "release_report.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    summary = {
        "n_spectra": n, "batch": batch, "n_batches": n_batches,
        "build_s": None if built is None else built["build_s"], "build": built,
        "kill_point": killed_at, "killed": killed,
        "leg_s": {"leg1": leg1, "leg2": leg2}, "multi_s_leg2": done["multi_s"],
        "ascii_s": done["ascii_s"], "analysis_s": t_stats, "spectra_per_s": rate,
        "exact_multiplicity_acc": exact, "checkpoint_mb": ckpt / 1e6,
        "artifacts": arts, "launches": done["launches"],
        "expected_launches": {k: pending for k in ("single", "pair", "redraw", "cddf", "null")},
    }
    print("RELEASE " + json.dumps(summary), flush=True)
    if kernels_expected(device):
        check_launches(done["launches"], summary["expected_launches"], "leg 2")
    if not exact > 0.95:
        raise SystemExit(f"exact-multiplicity accuracy {exact} not above 0.95")
    print("RELEASE OK", flush=True)
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--batch", type=int, default=PER_DEVICE_BATCH)
    p.add_argument("--run-name", default="release",
                   help="the release's directory under the workdir")
    p.add_argument("--n-spectra", type=int, default=DR12Q_N,
                   help="sightlines of the universe, when the workdir has none")
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--num-samples", type=int, default=NUM_SAMPLES)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain path)")
    p.add_argument("--worker", action="store_true")
    a = p.parse_args()
    if a.worker:
        worker(Path(a.workdir), a.batch, a.device, a.run_name)
    else:
        orchestrate(Path(a.workdir), a.batch, a.device, a.run_name, a.n_spectra, a.seed,
                    a.num_samples)
