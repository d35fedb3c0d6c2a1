#!/usr/bin/env python3
"""Drive the PyTorch port's inference paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:

1. find the card (a CUDA device is required; nothing runs on the CPU)
   and print its name and power limit as nvidia-smi reports them;
2. build every kernel source (csrc/evidence.cu, redraw.cu, cddf.cu,
   null_evidence.cu, and roofline.cu, the microbenchmarks of phase 12),
   one nvcc each, all started together, and print ptxas's registers,
   shared memory and spills for both k = 20 evidence configurations, the
   redraw, CDDF sums and null evidence kernels and the microbenchmarks;
3. hold the kernel's single-absorber configuration against its plain
   PyTorch version on the card at the production shapes (P = 1274 px,
   k = 20, S = 10,000 samples, 3 lines, windowed and full grid, plus a
   31-line case, and the scale demo's batch of 256) to 5e-5 normalized
   error, and against the float64 plain path; time both versions at the main path's batch shape, beside the
   least time the card could take (``evidence_bound`` of
   scripts/torch_roofline.py, loaded by path) and one FP32
   ``torch.bmm`` of the contraction alone as its yardstick, and the
   kernel at 31 lines on the full grid;
4. run ``inference.process_spectra`` with no device, dtype or backend
   named (the card, float32, the kernel) on a few hundred synthetic
   spectra with the 10,000-sample QMC set, check that every batch
   launched the kernel and every p_DLA is finite, and hold a subset to
   the float64 plain path with the catalog decision gate (no flips at
   p = 0.9 outside +-0.01, |dp| p99 < 1e-3);
5. hold the kernel's two-DLA pair configuration against its plain
   version in the same way: the fresh axis z-sorted (windowed and full
   grid), the base axis per-spectrum posterior-like draws in the R = 4
   layout of the 256-column tile, 3 and 31 lines, and a batch of 256;
   the kernel at R = 4 bit-identical to R = 1 on that layout; time both at B = 128 (R = 4
   and R = 1, and R = 4 at 31 lines on the full grid) beside the bound;
6. run the fused lean two-stage {0,1,2}-DLA chain
   ``parallel.sharded_multi.process_spectra_multi_lean``, with no
   device, dtype or backend named, at its default R = 4 on the same spectra with a
   second DLA in every fourth one: one single, one pair and one redraw
   launch per batch, the R = 4 pattern on the base redshifts the pair kernel
   receives, finite evidences, posteriors that sum to 1, NaN pair
   evidence only where a row has no valid pair; the process's first
   pipelined run under ``torch.profiler``, then the main run at the
   pipelined loop's defaults (4 batches in flight), then depths 1, 2
   and 4 in turns, every run bit-identical to it, and one run with every ``issue``
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), and
   ``torch.profiler`` splits of warm runs at the default and at depth 1
   (kernels, other device ops, device idle, the host's wait) beside the
   first run's, with the host ops that the first run paid more for; the
   redraw kernel (csrc/redraw.cu) on the inputs the chain gave it: its
   CDF within twice the plain float32 cumsum's distance from float64 and
   bit for bit ``posterior_cdf_in_kernel_order`` (its order of additions
   emulated with torch ops), its draws equal to the grid counts of its
   own CDF, its rows bit-identical at B = 1 and 128 and permuted, the
   draws that differ from the plain version's counted (knife edges), its
   time with the host's issue (``cuda_ms``, as every kernel's) and queued
   behind a spin kernel (the card's alone), beside the plain sequence's
   and its bound; then at R = 1
   (depth 1 and the default in turns),
   holding a subset against the classic driver on the float64 plain path
   (no decision flips where the float64 winner's posterior exceeds 0.91,
   pair evidences within rtol 5e-4 / atol 5e-3);
7. the one-command catalogue release: the lean chain's rate with and
   without the CDDF reduction on phase 6's spectra (same posteriors);
   then a synthetic release written to disk at survey widths (~256
   training and 512 test sightlines, speclite FITS files, DLA catalogues)
   and ``python -m gp_dla_detection_tpu_torch.pipeline --lean --multi-dla
   --cddf-inputs`` (no device, dtype or backend flags), stage by stage, with
   the L-BFGS budget cut to 40 iterations: each stage's wall time, one
   single launch per batch in the process stage and one single, pair,
   redraw and CDDF sums launch per batch in the multi stage, finite
   statistics, posteriors
   that sum to 1; on 32 release spectra the float32 CUDA CDDF reduction
   against the float64 plain one (mass channel = p_DLA to 1e-5, the same
   exact entries away from knife edges); the lean R = 1 statistics
   against the classic full-matrix run's within the R = 1 bounds of
   validation/RESULTS_LEAN_CDDF.md; the R = 4 statistics' distance from
   classic beside the scatter of the base redraw (R = 1 and R = 4 at
   other base seeds); the device reductions of the R = 1 and R = 4 runs
   redone by the float64 host reducer from their recorded inputs; on the
   32 release spectra whose pair evidence moves most between R = 1 and
   R = 4 (broad first-DLA posteriors), the second-DLA exact entries that
   the float32 kernel and the float32 plain path miss against float64,
   each away from p_switch's knife edge in a row where float32 drew
   another base sample for some pair column (the inverse-CDF draw's
   knife edge);
8. the drivers across ranks (``torch.multiprocessing``, one free port,
   each rank's output in a file, a timeout on the wait): two gloo ranks
   sharing the card (NCCL refuses two ranks on one GPU), then one NCCL
   rank, run ``process_spectra_sharded`` (full and lean), the fused lean
   chain (R = 4, CDDF inputs) and the classic flow on phase 6's spectra
   with the defaults (the card, float32, the kernels, the pipelined
   loop), with ``GPDLA_DRIVER_TIMING=1`` (each batch's upload, dispatch
   and fetch seconds, summarized per driver and depth): this process runs
   each at depth 1 and at the default in turns, bit-identical; every rank
   holds the whole result, bit-identical to this process's depth-1 run at
   the same per-rank batch (the CDDF inputs included), one
   single (and one pair) launch per rank per super-batch, checkpoints
   written by rank 0 alone and resumed by a one-rank rerun; on a data 1 x
   sample 2 mesh the single driver within 5e-5 normalized and the
   decision gate, and the fused lean chain with CDDF inputs under
   ``backend="torch"`` (float32, the plain path: the kernels run
   data-parallel only, and the defaults are refused there) on phase 6's
   first 64 spectra, against this process's run: bit-identical, or within
   5e-5 normalized and the decision gate with the reason printed, the
   same 3-class picks, the CDDF hist within 1e-6, on every rank; the
   training on phase 7's release data: the device
   L-BFGS against the host one on the card (scalar reads per evaluation
   counted), and two gloo ranks to the one-rank NLL within 1e-6; each
   run's wall seconds (two ranks on one card measure correctness, not
   scaling);
9. ``scripts/torch_scale_demo.py`` at its defaults: 1024 spectra x
   10,000 samples through ``process_spectra_multi_sharded``'s classic
   two-stage flow with per-batch checkpoints, float32, the kernels; its
   JSON lines, the single and pair launches per batch from the counters,
   each launch's device time (CUDA events) and the kernels' share of the
   wall, finite posteriors that sum to 1, exact-multiplicity accuracy >=
   0.95; the demo at depth 1 and at its default in turns, bit-identical,
   and a ``torch.profiler`` split of its wall at the default into the
   kernels, the other device ops, the device's idle time and the host's
   wait; then the demo's first batch of 256 through both wrappers: each
   half launched alone gives the same rows bit for bit, the kernel as
   close to float64 as its plain float32 version; the decision gate on
   p_DLA and on the 3-class posteriors against the plain driver path;
10. the port's bench, ``python -m gp_dla_detection_tpu_torch.bench``, run
   as a user runs it (no device, dtype or backend flags): at its
   defaults (the kernel mode at B = 1024, then the fused lean chain's
   sustained marginal rate at 16,384 spectra, batch 1024, R = 4, with
   checkpoints) and with ``--driver`` (the full single driver at 8,192):
   every JSON line printed, finite, from the kernels (the launch counts in
   each line); in this process the kernel mode at B = 128, 256, 512 and
   1024 (spectra/s, peak memory), its device function at B = 1024 with no
   host sync (the sync-debug mode), both kernels at B = 1024 (CUDA
   events, beside the bound) row for row bit-identical to B = 128
   launches, their first 128 rows held against the plain versions on the
   bench's own inputs (5e-5 normalized), and the fused lean chain with
   the CDDF inputs on the bench's first 1,024 spectra at batch 1024
   against batches 256 and 128: bit-identical in every array, or the
   phase fails with the kernel inputs that differ; one single, pair,
   redraw and CDDF sums launch per batch; the same chain at S = 10,001
   (a sample count that is not a multiple of 4) on 256 spectra at
   batches 256 and 128, bit-identical in every array; the plain redraw (the
   backend="torch" path) replayed op by op on the chain's inputs at both
   batches, the first of its ops whose output depends on the batch
   printed; ``inference.process_spectra`` on the bench's first 1,024
   spectra at batches 1024 and 128, bit-identical in every array (the
   values that differ counted); the redraw kernel's checks of phase 6 on
   the bench's inputs (R = 4), its rows at B = 1, 128 and 1024, its time
   at B = 1024; the
   CDDF sums kernel (csrc/cddf.cu) on the chain's own inputs at B = 1024:
   within 1e-12 relative of the plain float64 sums, bit-identical over
   three runs and for a row alone, its time at B = 128 and 1024 beside
   the plain sums', its bound and one ``scatter_add_`` of the prebuilt
   values (the same histogram with atomics), and the CDDF reducer's
   device time on the chain's batch split by op (CUDA events: the sums,
   each of the two stable sorts, the rest, the copies to the host); the
   null evidence kernel
   (csrc/null_evidence.cu) on the bench's spectra: within 5e-5
   normalized of its plain version and 5e-4 of float64, each row the same
   bits at B = 1, 128 and 256, shifted by one and permuted (the plain
   version's rows that move printed), its time at B = 128 and 1024;
   the pair kernel also at R = 1 at B = 1024 (its time only); beside each
   kernel's B = 1024 time nvidia-smi's clock and power, read as the
   window closes;
11. the survey harnesses, in subprocesses as a user runs them, in one
   temporary workdir removed afterwards (on failure too): (a)
   ``scripts/torch_scale_rehearsal.py`` at its defaults (16,384
   sightlines x 10,000 samples, batch 1024, the classic two-stage flow
   with per-batch checkpoints, the seed from ``--seed``): a worker
   SIGKILLed during the single-DLA stage and one during the pair stage,
   resumed, and the result bit-identical in every array to an
   uninterrupted run, each finished worker's single, pair and null
   launches equal to the batches it computed; the kill points, each
   leg's wall, run B's spectra/s per stage, the build's seconds and the
   checkpoint volume printed; (b) the classic flow under
   ``backend="cuda"`` on the universe's first 2,048 sightlines at
   batches 1024 and 128, bit-identical in every array, one launch of
   each kernel per batch; (c) ``scripts/torch_survey_release.py`` on the
   same universe (the lean chain with CDDF inputs killed at a third and
   resumed at batch 1024, the ASCII and analysis stages) against an
   uninterrupted lean worker at batch 256: every array of the catalogue
   bit-identical, ``cddf_*`` included, one launch of each kernel per
   batch, exact multiplicity >= 0.95 against the injection truth, the
   four ASCII files and a finite ``analysis/statistics.json`` written;
12. the measured roofline (``scripts/torch_roofline.py``, in this
   process): the ceilings of the op classes the kernels use, from the
   microbenchmarks of csrc/roofline.cu (FP32 FMA, expf, logf,
   __fdiv_rn, the evidence kernel's branchless division, mma.sync TF32,
   FP64 FMA, the read bandwidth; torch.matmul in FP32 and FP64 beside
   them as library yardsticks), each held to its plain chain of torch
   ops and to 1.05x its published peak, nvidia-smi's clock and power
   read in each window; phase 10's B = 1024 time of each of the five
   kernels (the pair at R = 1 and 4), on phase 10's inputs, against the
   published-peak bound and the bound at the measured ceilings, with
   the class that bounds it and the composite: no kernel is faster than
   its bound at the measured ceilings;
13. ``scripts/torch_training_convergence.py`` as a user runs it, in
   float64 on the card, two processes side by side: ``compare`` at N =
   4,096 with budget 2000 (both optimizers converged, within 1e-5 of
   each other and 1e-6 of the JAX record) and ``part-a`` at N = 25,000
   (SIGKILLed while it runs, after a checkpoint, resumed, ended by a
   convergence test,
   within 1e-5 of the JAX record); whether the objective gives the same
   bits twice;
14. ``scripts/torch_synthetic_universe.py`` and ``--multi`` as a user
   runs them (the card, float32, the kernels): every assertion of the
   JAX harness, one launch of each kernel per batch;
15. print the run time, a JSON line describing both evidence kernel
   configurations, the redraw, the CDDF sums and the null evidence
   kernels (times, bound, yardstick, launches, errors, the card; the B =
   1024 times and bounds, the measured-ceiling bounds and the bench's
   lines) with the ceilings, the training and the universe (what this
   run measured: the published peaks, the JAX record and the runs'
   settings stay in the report lines), and, last, a JSON line with the
   device.

Weights and data are random, made from ``--seed`` with numpy.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NORMALIZED_BOUND = 5e-5       # kernel vs plain float32 (tests/test_evidence_pallas.py)
F64_BOUND = 5e-4              # float32 kernel vs the float64 plain path: fast
                              # Faddeeva (1.3e-5 rel) + float32 roundoff of x
DECISION_MARGIN = 0.01        # tests/test_f32_decisions.py
DECISION_P99 = 1e-3
N_SPECTRA = 512               # main-path run: 4 batches of 128
BATCH = 128
F64_SUBSET = 32               # spectra re-run on the float64 plain path
PAIR_RTOL, PAIR_ATOL = 5e-4, 5e-3   # pair evidence, f32 lean vs f64 classic
                                    # (tests/test_lean_multi.py:234-238)
RELEASE_TEST = 512            # release phase: test sightlines (4 batches of 128)
RELEASE_DR9 = 430             # DR9 sightlines: the prior set, ~256 of them training
RELEASE_LBFGS = (40, 80)      # the cut L-BFGS budget: iterations, evaluations
MASS_RTOL = 1e-5              # CDDF mass channel vs p_DLA, per spectrum
KNIFE_EDGE = 0.1              # exact entries within 10 % of p_switch may flip
STAT_BOUNDS = {"cddf": 2.5e-2, "line_density": 2e-3}   # lean R=1 vs classic
                              # (validation/RESULTS_LEAN_CDDF.md, R = 1)
REPLAY_RTOL = 1e-6           # device reduction vs the host reducer, same inputs:
                              # float64 sums in another order, stored as float32
REDRAWS = ((1, 0), (1, 1), (1, 2), (1, 3), (4, 0), (4, 1), (4, 2), (4, 3))   # (R, base seed)
RANK_BATCH = BATCH            # phase 8: per-rank batch (super-batch 2 x 128 on 2 ranks)
RANK_TIMEOUT = 600            # phase 8: seconds the ranks of one spawn may take
SAMPLE_CHAIN = 64             # phase 8: spectra of the sample-axis chain (plain path)
SAMPLE_CHAIN_BATCH = 32
SCALE_DEMO_ACC = 0.95         # phase 9: exact-multiplicity accuracy floor (the JAX
                              # script's recorded seed-7 run: 0.987)
SCALE_BATCH = 256             # phase 9: the demo's per-device batch on one card
F32_ACCURACY_RATIO = 1.25     # phase 9: the kernel's distance from float64 over
                              # its plain float32 version's, at most
BENCH_BATCH = 1024            # phase 10: the bench's batch (its default, bench.py's)
BENCH_SWEEP = (128, 256, 512, 1024)   # phase 10: the kernel mode's batches
BENCH_TIMEOUT = 300           # phase 10: seconds one bench process may take
BENCH_CHAIN_BATCHES = (1024, 256, 128)   # phase 10: the chain's batches, bit-identical
ODD_S = 10001                 # phase 10: a sample count that is not a multiple of 4
ODD_S_SPECTRA = 256           # phase 10: the chain at ODD_S on this many spectra, at
                              # batches ODD_S_SPECTRA and BATCH, bit-identical
SURVEY_SPECTRA = 16384        # phase 11: the rehearsal's sightlines (its default)
SURVEY_BATCH = 1024           # phase 11: the rehearsal's and the release's batch
SURVEY_SUBSET = 2048          # phase 11 (b): the classic flow on this many sightlines
SURVEY_SUBSET_BATCHES = (1024, 128)   # at these batches, bit-identical
RELEASE_B_BATCH = 256         # phase 11 (c): the uninterrupted lean run's batch
SURVEY_ACC = 0.95             # phase 11 (c): exact-multiplicity floor (the JAX harness's)
SURVEY_TIMEOUT = 900          # phase 11: seconds one harness run may take
TRAINING_B = ("4096", "2000")   # phase 13: part B's quasars and L-BFGS budget (the JAX record's)
TRAINING_A = "25000"            # phase 13: part A's quasars (the JAX record's)
TRAINING_RTOL = 1e-5            # phase 13: host vs device NLL, both converged (the JAX harness's)
TRAINING_JAX_RTOL = 1e-6        # phase 13: part B's NLLs vs the JAX record (9 digits)
HARNESS_TIMEOUT = 900           # phases 13-14: seconds one harness run may take
HARNESS_LINES = ("- ", "  |", "host:", "device:")   # phases 13-14: report lines printed
KERNEL_SOURCES = ("evidence", "redraw", "cddf", "null_evidence", "roofline")   # csrc/<name>.cu
# scripts/torch_roofline.py, loaded by path in main(): the op model, the
# published-peak bounds, the kernels' inputs and the measured roofline
ROOFLINE_SCRIPT = Path(__file__).resolve().parent / "scripts" / "torch_roofline.py"
RL = None
# the previous design's kernel times at the phase-3/5 shapes, for
# comparison (PERF.md, PR 3's chip runs on NVIDIA H100 80GB HBM3, 700.00 W)
PR3_MS = {"single": "72.78-72.96", "pair R=4": "91.48-91.58"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def normalized_error(a, b) -> tuple[float, float]:
    """(max |a-b| / max(|b|, 1), max |a-b|) over all entries, in float64."""
    import torch

    a, b = a.double(), b.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return float("inf"), float("inf")
    diff = (a - b).abs()
    return float((diff / b.abs().clamp(min=1.0)).max()), float(diff.max())


def cuda_ms(fn, reps: int, samples: list | None = None) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls after
    one warm-up call, timed with CUDA events.  ``samples``, where given,
    gets nvidia-smi's clock and power read as the window closes (before
    the host waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    if samples is not None:
        samples.append(RL.gpu_sample())
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


SPIN_HZ = 2e9   # spin-kernel cycles a second: above the H100's top SM clock (1.98 GHz)


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls
    queued behind a spin kernel, after one warm-up call: the host is
    ahead of the card, so the events time the card's work back to back
    (the card's own gaps between launches included), not the host's
    issue of each call, which ``cuda_ms`` also times where it is the
    longer."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ahead = time.perf_counter() - t0   # at least the host's issue of the calls
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * ahead * SPIN_HZ) + 10_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_usage(report: str) -> str:
    """ptxas's register, shared-memory and spill lines for a library's
    one kernel (-Xptxas -v)."""
    keep = [l.strip().removeprefix("ptxas info    : ") for l in report.splitlines()
            if "Used" in l or "spill" in l]
    return " | ".join(keep) or "no ptxas report"


def kernel_report(report: str, k: int) -> str:
    """ptxas's register, shared-memory and spill lines for the rank-k
    instances of both configurations (-Xptxas -v)."""
    lines = report.splitlines()
    found = []
    for pair, name in ((False, "single"), (True, "pair")):
        tag = f"ILi{k}ELb{int(pair)}E"
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and tag in line:
                keep = [l.strip().removeprefix("ptxas info    : ")
                        for l in lines[i + 1 : i + 4] if "Used" in l or "spill" in l]
                found.append(f"{name}: " + " | ".join(keep))
                break
    return "; ".join(found) or "no ptxas report"


def contraction_ms(B: int, S: int, P: int, device) -> float:
    """The contraction's yardstick: one torch.bmm (B, S, P) x (B, P, 240)
    in FP32 with TF32 off, the Gram and projection of one evidence call
    alone (no single PyTorch call computes the whole evidence function;
    the port never calls this)."""
    import torch

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device=device).manual_seed(0)
        a = torch.rand((B, S, P), generator=g, device=device)
        w = torch.rand((B, P, 240), generator=g, device=device)
        return cuda_ms(lambda: torch.bmm(a, w), 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def torch_tensor(a):
    import torch

    return torch.as_tensor(a, dtype=torch.float64)


def build_workload(seed: int, n_spectra: int):
    """Synthetic production-shape spectra + model (utils.synthetic) and
    the real 10,000-sample QMC set (samples.generate_dla_samples)."""
    import numpy as np

    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption
    from gp_dla_detection_tpu_torch.params import LYA_WAVELENGTH, LYMAN_LIMIT
    from gp_dla_detection_tpu_torch.samples import generate_dla_samples
    from gp_dla_detection_tpu_torch.utils import synthetic_workload

    w = synthetic_workload(n_spectra, 1, pixels=1274, k=20, seed=seed, dtype=np.float64)
    params = w["params"]
    rng = np.random.default_rng(seed + 1)
    # a DLA in every other spectrum, inside the searched z range, so the
    # decision gate sees both classes
    lam, zq = w["wavelengths"][::2], w["z_qso"][::2]
    z_lo = np.maximum(
        lam[:, 0] / LYA_WAVELENGTH - 1,
        LYMAN_LIMIT * (1 + zq) / LYA_WAVELENGTH - 1 + params.min_z_cut,
    )
    z_hi = (
        np.minimum(lam[:, -1], params.null_model.max_lambda * (1 + zq)) / LYA_WAVELENGTH
        - 1 - params.max_z_cut
    )
    z_dla = rng.uniform(z_lo, np.maximum(z_hi, z_lo))
    nhi = 10 ** rng.uniform(20.0, 22.5, len(zq))
    ext = torch_tensor(extend_wavelengths(lam, params.instrument))
    absorption = voigt_absorption(ext, torch_tensor(z_dla[:, None]), torch_tensor(nhi[:, None]))
    w["flux"][::2] *= absorption[:, 0, :].numpy()
    w["dla_z"] = np.full(len(w["z_qso"]), np.nan)
    w["dla_z"][::2] = z_dla
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)
    spectra = PaddedSpectra(
        w["wavelengths"], w["flux"], w["noise_variance"], w["mask"], w["z_qso"]
    )
    prior_z = rng.uniform(2.0, 4.4, 5000)
    prior_flags = rng.uniform(size=5000) < 0.15
    return w, params, samples, spectra, prior_z, prior_flags


def inject_second_dlas(w, params, seed: int):
    """A copy of the workload's flux with a second DLA in every fourth
    spectrum (each already holds one): z uniform in the searched range,
    at least 0.05 in log(1+z) (15,000 km/s) from the first DLA."""
    import numpy as np

    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption
    from gp_dla_detection_tpu_torch.params import LYA_WAVELENGTH, LYMAN_LIMIT

    rng = np.random.default_rng(seed + 2)
    lam, zq = w["wavelengths"][::4], w["z_qso"][::4]
    z_lo = np.maximum(
        lam[:, 0] / LYA_WAVELENGTH - 1,
        LYMAN_LIMIT * (1 + zq) / LYA_WAVELENGTH - 1 + params.min_z_cut,
    )
    z_hi = np.maximum(
        np.minimum(lam[:, -1], params.null_model.max_lambda * (1 + zq)) / LYA_WAVELENGTH
        - 1 - params.max_z_cut,
        z_lo,
    )
    z_first = w["dla_z"][::4]
    z2 = rng.uniform(z_lo, z_hi)
    for _ in range(50):   # redraw the ones too close to the first DLA
        close = np.abs(np.log1p(z2) - np.log1p(z_first)) < 0.05
        if not close.any():
            break
        z2[close] = rng.uniform(z_lo[close], z_hi[close])
    nhi = 10 ** rng.uniform(20.3, 22.0, len(zq))
    ext = torch_tensor(extend_wavelengths(lam, params.instrument))
    absorption = voigt_absorption(ext, torch_tensor(z2[:, None]), torch_tensor(nhi[:, None]))
    flux = w["flux"].copy()
    flux[::4] *= absorption[:, 0, :].numpy()
    return flux


def write_spec_file(path, loglam, flux, ivar):
    """One SDSS speclite coadd (the columns spectra.read_spec reads)."""
    import numpy as np

    from gp_dla_detection_tpu_torch.io import write_bintable

    zeros = np.zeros(len(loglam), np.int32)
    write_bintable(
        path,
        ["FLUX", "LOGLAM", "IVAR", "AND_MASK", "OR_MASK"],
        [flux.astype(np.float32), loglam.astype(np.float32), ivar.astype(np.float32),
         zeros, zeros],
    )


def write_release(base, seed: int, device, n_test: int, n_dr9: int):
    """A synthetic DR12Q release on disk, in the layout the pipeline reads
    (tests/conftest.py's, at survey widths): the DR12Q/DR9Q/DR10Q FITS
    catalogues, the three DLA text catalogues and one speclite FITS file
    per quasar, rest frame 890-1400 A at 1e-4 dex.

    ``n_test`` sightlines pass the catalogue filters (the test set); 8
    more are filtered (4 below the z cut, 4 BAL).  The first ``n_dr9``
    are DR9 sightlines searched by the concordance catalogue (the prior
    set; the training set is those of them without a DLA).  Continua are
    a Lya/Lyb emission mean plus six smooth random components, the
    forest a log-normal optical depth about tau_0 (1+z)^beta, and 60 / 30
    / 10 % of sightlines hold 0 / 1 / 2 DLAs (Voigt profiles, log N_HI
    about 20.8).  Returns the truth: the DLAs per sightline."""
    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.io import write_bintable
    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption
    from gp_dla_detection_tpu_torch.params import LYA_WAVELENGTH, LYMAN_LIMIT, Parameters

    rng = np.random.default_rng(seed + 10)
    params = Parameters(base_directory=str(base))
    n = n_test + 8
    thing_ids = np.arange(1001, 1001 + n)
    z_qso = rng.uniform(2.3, 3.5, n)
    z_qso[n_test : n_test + 4] = rng.uniform(1.7, 2.1, 4)
    bal = np.zeros(n, np.int32)
    bal[n_test + 4 :] = 1
    plates = (4055 + np.arange(n) // 500).astype(np.int32)
    fibers = (1 + np.arange(n) % 500).astype(np.int32)
    mjds = np.full(n, 55359, np.int32)
    snr = rng.uniform(4.0, 15.0, n)

    # DR12Q: the columns the catalogue builder reads by position
    names, cols = [], []
    for name, col in (
        ("SDSS_NAME", np.array([f"J{i:017d}" for i in range(n)], dtype="S18")),
        ("RA", rng.uniform(0, 360, n)), ("DEC", rng.uniform(-10, 70, n)),
        ("THING_ID", thing_ids.astype(np.int32)), ("PLATE", plates), ("MJD", mjds),
        ("FIBERID", fibers), ("Z_VI", z_qso),
    ):
        names.append(name)
        cols.append(col)
    for j in range(9, 56):
        names.append("SNR_SPEC" if j == 33 else f"PAD{j}")
        cols.append(snr if j == 33 else np.zeros(n, np.float32))
    names.append("BAL_FLAG_VI")
    cols.append(bal)
    d12 = params.distfiles_directory("dr12q")
    d12.mkdir(parents=True)
    write_bintable(d12 / "DR12Q.fits", names, cols)
    for rel, fname, members in (("dr9q", "DR9Q.fits", thing_ids[:n_dr9]),
                                ("dr10q", "DR10Q_v2.fits", thing_ids)):
        d = params.distfiles_directory(rel)
        d.mkdir(parents=True)
        write_bintable(
            d / fname, ["SDSS_NAME", "RA", "DEC", "THING_ID"],
            [np.array(["x"] * len(members), dtype="S18"), np.zeros(len(members)),
             np.zeros(len(members)), members.astype(np.int32)],
        )

    # the DLAs: inside the searched range, pairs at least 0.05 apart in z
    truth = []
    for i in range(n_test):
        k = rng.choice(3, p=[0.6, 0.3, 0.1])
        lo = LYMAN_LIMIT * (1 + z_qso[i]) / LYA_WAVELENGTH - 1 + params.min_z_cut
        hi = params.null_model.max_lambda * (1 + z_qso[i]) / LYA_WAVELENGTH - 1 - params.max_z_cut
        zs = np.sort(rng.uniform(lo, hi - 0.05, k))
        if k == 2 and zs[1] - zs[0] < 0.05:
            zs[1] = zs[0] + 0.05
        for z in zs:
            truth.append((i, float(z), float(np.clip(rng.normal(20.8, 0.35), 20.3, 22.0))))
    for name, los, rows in (
        ("dr9q_concordance", thing_ids[:n_dr9], [t for t in truth if t[0] < n_dr9]),
        ("dr12q_noterdaeme", thing_ids[:n_test], truth),
        ("dr12q_visual", thing_ids[:n_test], truth),
    ):
        d = params.dla_catalog_directory(name)
        d.mkdir(parents=True)
        np.savetxt(d / "los_catalog", los, fmt="%d")
        np.savetxt(d / "dla_catalog", np.array([(thing_ids[i], z, l) for i, z, l in rows]))

    n_px = int(np.log10(1400.0 / 890.0) / 1e-4)
    loglam = np.log10(890.0 * (1 + z_qso))[:, None] + 1e-4 * np.arange(n_px)[None, :]
    lam = 10.0**loglam
    rest = lam / (1 + z_qso[:, None])
    bump = lambda c, w: np.exp(-0.5 * ((rest - c) / w) ** 2)
    mean = 1 + 0.8 * bump(1215.67, 15.0) + 0.25 * bump(1033.0, 8.0) + 0.05 * np.sin(rest / 40.0)
    shapes = np.stack([bump(c, w) for c, w in zip(rng.uniform(900, 1400, 6), rng.uniform(20, 80, 6))])
    coeff = rng.normal(0, 0.08, (6, n))
    scale = 10 ** rng.uniform(0.7, 1.3, n)[:, None]
    continuum = scale * (mean + np.einsum("jn,jnp->np", coeff, shapes))
    forest = rest < LYA_WAVELENGTH
    tau = 0.0023 * (lam / LYA_WAVELENGTH) ** 3.65 * rng.lognormal(0.0, 0.7, lam.shape)
    flux = continuum * np.where(forest, np.exp(-tau), 1.0)
    rows = np.array([t[0] for t in truth])
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    absorption = voigt_absorption(
        t64(extend_wavelengths(lam[rows], params.instrument)),
        t64([[t[1]] for t in truth]), t64([[10.0 ** t[2]] for t in truth]),
    )[:, 0, :].cpu().numpy()
    np.multiply.at(flux, rows, absorption)   # a sightline may hold two
    sigma = scale / snr[:, None]
    flux = flux + sigma * rng.normal(size=flux.shape)

    spec_dir = params.spectra_directory("dr12q")
    for i in range(n):
        plate_dir = spec_dir / str(plates[i])
        plate_dir.mkdir(parents=True, exist_ok=True)
        write_spec_file(
            plate_dir / f"spec-{plates[i]}-{mjds[i]}-{fibers[i]:04d}.fits",
            loglam[i], flux[i], np.broadcast_to(1.0 / sigma[i] ** 2, (n_px,)),
        )
    return np.bincount(rows, minlength=n_test)


def run_cli_stages(argv, stages, params_factory):
    """``python -m gp_dla_detection_tpu_torch.pipeline <argv> --stage s``
    for each stage in turn, in this process so that the kernels' launch
    counts can be read: per stage the wall seconds, the launches of each
    kernel (``launch_counts``) and what it printed.  ``params_factory`` stands in for
    ``Parameters`` inside the CLI (the L-BFGS budget cut)."""
    import io

    import gp_dla_detection_tpu_torch.pipeline as pipeline

    seconds, launches, printed = {}, {}, {}
    full = pipeline.Parameters
    pipeline.Parameters = params_factory
    try:
        for stage in stages:
            out = io.StringIO()
            reset_counts()
            sync()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                pipeline.main([*argv, "--stage", stage])
            sync()
            seconds[stage] = time.perf_counter() - t0
            launches[stage] = launch_counts()
            printed[stage] = out.getvalue()
    finally:
        pipeline.Parameters = full
    return seconds, launches, printed


def release_inputs(pipe):
    """What the pipeline's multi stage hands its driver, from the stage
    artifacts: (model, samples, test spectra, prior z, prior DLA
    counts)."""
    import numpy as np

    from gp_dla_detection_tpu_torch.multi_dla import prior_dla_multiplicity

    catalog = pipe.run_catalog()
    spectra = pipe.run_preload(catalog)
    model = pipe.run_learn(catalog, spectra)
    samples = pipe.run_samples(catalog)
    padded = pipe._padded_test_spectra(catalog, spectra, pipe.default_test_mask(catalog, spectra))
    dc = catalog.dla_catalogs[pipe.config.dla_catalog_name]
    prior_idx = np.flatnonzero(catalog.prior_dr9_concordance())
    prior_num = prior_dla_multiplicity(
        catalog.z_qsos[prior_idx], dc.dla_ind[prior_idx], [dc.z_dlas[int(i)] for i in prior_idx]
    )
    return model, samples, padded, catalog.z_qsos[prior_idx], prior_num


@contextlib.contextmanager
def recorded_reductions(sharded_multi, log: list):
    """Copy to the host the inputs of every CDDF reduction the lean
    driver runs (one entry per batch), without changing them.  The first
    entry also holds the reducer's (spec, offsets, lnhis, order)."""
    make = sharded_multi.make_cddf_reducer

    def spy_make(spec, offsets, lnhis, order=None, device=None, **kw):
        reduce_fn, consts = make(spec, offsets, lnhis, order=order, device=device, **kw)
        log.append((spec, offsets, lnhis, order))

        def spy(c, *args):
            log.append([a.cpu() for a in args])
            return reduce_fn(c, *args)

        return spy, consts

    sharded_multi.make_cddf_reducer = spy_make
    try:
        yield log
    finally:
        sharded_multi.make_cddf_reducer = make


def replay_reductions(log, inputs, batch: int):
    """The recorded reductions of one lean run redone on the host in
    float64 from the same inputs, the pair columns put back in original
    sample order (so that the replay needs no ``order`` and no index
    translation), against what the run stored (``inputs``, a
    CDDFInputs).  Returns (max |run - replay| / (|replay| + 1e-30) over
    ``hist``, the same over the exact entries' probabilities, exact
    entries with p > 0 whose indices differ, counters that differ)."""
    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.cddf_inputs import make_cddf_reducer

    (spec, offsets, lnhis, order), *batches = log
    reduce_fn, consts = make_cddf_reducer(spec, offsets, lnhis)
    K = spec.top_k
    rel = lambda a, b: float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30), initial=0.0))
    hist_err = p_err = 0.0
    bad_idx = bad_counts = 0
    for bi, args in enumerate(batches):
        *head, lls2, ev2, base = args
        if order is not None:
            cols = torch.as_tensor(order)
            lls2_o, base_o = torch.empty_like(lls2), torch.empty_like(base)
            lls2_o[:, cols], base_o[:, cols] = lls2, base
            lls2, base = lls2_o, base_o
        hist, ex = reduce_fn(consts, *head, lls2, ev2, base)
        rows = slice(bi * batch, min((bi + 1) * batch, len(inputs.hist)))
        n = rows.stop - rows.start
        ref_h, ref_ex = hist.numpy()[:n].astype(np.float64), ex.numpy()[:n]
        run_ex = inputs.ex[rows]
        hist_err = max(hist_err, rel(inputs.hist[rows].astype(np.float64), ref_h))
        for p_blk, idx_blks in ((0, (1,)), (2, (3, 4))):
            live = ref_ex[:, p_blk * K : (p_blk + 1) * K] > 0
            blk = lambda e, b: e[:, b * K : (b + 1) * K]
            p_err = max(p_err, rel(blk(run_ex, p_blk)[live].astype(np.float64),
                                   blk(ref_ex, p_blk)[live].astype(np.float64)))
            for b in idx_blks:
                bad_idx += int((blk(run_ex, b) != blk(ref_ex, b))[live].sum())
        bad_counts += int((run_ex[:, 5 * K :] != ref_ex[:, 5 * K :]).sum())
    return hist_err, p_err, bad_idx, bad_counts


def recorded_base_draws(log):
    """The base sample every pair column of one lean run drew, (N, S) in
    original sample numbering and column order, from the inputs that
    ``recorded_reductions`` copied."""
    import numpy as np
    import torch

    (_, _, _, order), *batches = log
    base = torch.cat([args[-1] for args in batches]).numpy()
    if order is not None:
        out = np.empty_like(base)
        out[:, np.asarray(order)] = base
        base = out
    return base


def stat_deviation(a, b) -> float:
    """Max relative deviation of b from a over every array of one
    statistic, each entry against max(|a|, 1e-3 max |a|)
    (validation/lean_cddf_ab.py's measure)."""
    import numpy as np

    worst = 0.0
    for x, y in zip(a, b):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.size:
            denom = np.maximum(np.abs(x), np.abs(x).max() * 1e-3 + 1e-300)
            worst = max(worst, float(np.max(np.abs(y - x) / denom)))
    return worst


def exact_entry_diff(a, b, p_switch: float) -> dict:
    """{(row, key): p} of every exact CDDF entry (p >= p_switch) in one
    reduction and not the other, knife edges included.  ``a``, ``b``:
    (N, K) probabilities and (N, K) index keys."""
    (pa, ka), (pb, kb) = a, b
    out = {}
    for i in range(len(pa)):
        sa = {int(k): p for k, p in zip(ka[i], pa[i]) if p >= p_switch}
        sb = {int(k): p for k, p in zip(kb[i], pb[i]) if p >= p_switch}
        out.update({(i, k): sa.get(k, sb.get(k)) for k in set(sa) ^ set(sb)})
    return out


def exact_entry_mismatches(a, b, p_switch: float) -> int:
    """The entries of ``exact_entry_diff`` away from knife edges: an
    entry whose p lies within KNIFE_EDGE (relative) of p_switch may fall
    on either side."""
    return sum(p >= p_switch * (1 + KNIFE_EDGE) for p in exact_entry_diff(a, b, p_switch).values())


def nonfinite_json(x, path: str = "") -> list[str]:
    """Where a JSON value holds a number that is not finite."""
    import numpy as np

    if isinstance(x, dict):
        return [p for k, v in x.items() for p in nonfinite_json(v, f"{path}.{k}")]
    if isinstance(x, list):
        return [p for i, v in enumerate(x) for p in nonfinite_json(v, f"{path}[{i}]")]
    return [path] if isinstance(x, float) and not np.isfinite(x) else []


COUNTED = "(single, pair, redraw, CDDF sums, null evidence)"


def reset_counts() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn, redraw

    evidence.launch_count = evidence.pair_launch_count = 0
    redraw.launch_count = cddf_inputs.launch_count = low_rank_mvn.launch_count = 0


def launch_counts() -> tuple[int, int, int, int, int]:
    """The launches of each kernel in ``COUNTED`` since ``reset_counts``."""
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn, redraw

    return (evidence.launch_count, evidence.pair_launch_count, redraw.launch_count,
            cddf_inputs.launch_count, low_rank_mvn.launch_count)


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def release_parameters(**kw):
    """The CLI's ``Parameters`` with the L-BFGS budget cut to
    RELEASE_LBFGS."""
    from gp_dla_detection_tpu_torch.params import OptimizationParams, Parameters

    iters, evals = RELEASE_LBFGS
    return dataclasses.replace(
        Parameters(**kw),
        optimization=OptimizationParams(max_iterations=iters, max_fun_evals=evals),
    )


def release_phase(seed: int, smi: str, chain, device: str = "cuda", backend: str = "cuda") -> dict:
    """Phase 7: the one-command catalogue release on the card.

    ``chain``: (model, offsets, nhis, spectra, prior z, prior DLA counts,
    params) of phase 6, for the chain's rate with and without the CDDF
    reduction.  ``device``/``backend`` are the card and the kernels; the
    float64 references run the plain path on the same device.  Returns
    what the kernels line reports."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import gp_dla_detection_tpu_torch.parallel.sharded_multi as sharded_multi
    from gp_dla_detection_tpu_torch.cddf_inputs import CH_P, CH_SMALL2_A

    # ---- the lean chain with and without the reduction, in turns
    *chain_args, chain_params = chain
    n_chain = len(chain_args[3])
    rates = {False: [], True: []}
    catalogues = {}
    for cddf in (False, True, True, False):
        sync()
        t0 = time.perf_counter()
        res = sharded_multi.process_spectra_multi_lean(
            *chain_args, params=chain_params, batch_size=BATCH, dtype=torch.float32,
            backend=backend, store_cddf_inputs=cddf,
        )
        sync()
        rates[cddf].append(n_chain / (time.perf_counter() - t0))
        catalogues[cddf] = res.model_posteriors
    if not np.array_equal(catalogues[False], catalogues[True]):
        fail("the CDDF reduction changed the lean chain's posteriors")
    off_rate, on_rate = np.mean(rates[False]), np.mean(rates[True])
    say(f"phase 7: lean chain (cuda, float32, R=4) on phase 6's {n_chain} spectra, in turns "
        f"off/on/on/off: without the CDDF reduction {rates[False][0]:.1f} / {rates[False][1]:.1f}, "
        f"with it {rates[True][0]:.1f} / {rates[True][1]:.1f} spectra/s "
        f"({(on_rate / off_rate - 1) * 100:+.1f} %); same posteriors ({smi})")

    iters, evals = RELEASE_LBFGS
    with tempfile.TemporaryDirectory(prefix="gpdla_release_") as tmp:
        tmp = Path(tmp)
        data, work = tmp / "data", tmp / "run"
        t0 = time.perf_counter()
        truth = write_release(data, seed, torch.device(device), RELEASE_TEST, RELEASE_DR9)
        say(f"phase 7: wrote a synthetic release of {RELEASE_TEST + 8} quasars "
            f"({RELEASE_TEST} test, {RELEASE_DR9} DR9, {int((truth > 0).sum())} with DLAs, "
            f"{int((truth == 2).sum())} with two) in {time.perf_counter() - t0:.1f} s")

        # ---- the CLI, stage by stage, as a user resumes it
        # no --device, --dtype or --backend: the card, float32, the kernels
        argv = ["--workdir", str(work), "--base-directory", str(data),
                "--lean", "--multi-dla", "--cddf-inputs", "--per-device-batch", str(BATCH)]
        stages = ("catalog", "preload", "learn", "samples", "process", "multi", "all")
        seconds, launches, printed = run_cli_stages(argv, stages, release_parameters)
        n_batches = -(-RELEASE_TEST // BATCH)
        expected = {s: (0, 0, 0, 0, 0) for s in stages}
        expected.update(process=(n_batches, 0, 0, 0, n_batches), multi=(n_batches,) * 5)
        if launches != expected:
            fail(f"release: {COUNTED} launches per stage {launches}, expected {expected}")
        summary = json.loads(printed["all"])
        from gp_dla_detection_tpu_torch.models.qso_model import GPModel
        from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig

        config = lambda workdir, **kw: PipelineConfig(
            workdir=str(workdir), backend=backend, device=device, multi_dla=True,
            per_device_batch=BATCH, **kw,
        )
        params = release_parameters(base_directory=str(data))
        pipe = Pipeline(params, config(work, store_sample_likelihoods=False, cddf_inputs=True))
        meta = GPModel.load(pipe.model_path).metadata
        say("phase 7: python -m gp_dla_detection_tpu_torch.pipeline " + " ".join(argv[4:])
            + ", stage by stage (wall s): " + ", ".join(f"{s} {seconds[s]:.2f}" for s in stages)
            + f"; learn on {RELEASE_DR9 - int((truth[:RELEASE_DR9] > 0).sum())} sightlines, "
            f"L-BFGS budget cut to {iters} iterations / {evals} evaluations: used "
            f"{meta['iterations']} / {meta['fun_evals']} ({meta['termination']}); "
            f"'all' = SNRs + ASCII + analysis; {COUNTED} launches: process "
            f"{launches['process']}, multi {launches['multi']} for {n_batches} batches ({smi})")

        with np.load(pipe.multi_results_path) as f:
            post = f["multi_model_posteriors"]
        stats = json.loads((work / "analysis" / "statistics.json").read_text())
        ok_rows = np.isfinite(post).all(axis=1)
        picks = np.argmax(np.where(ok_rows[:, None], post, -1.0), axis=1)
        say(f"phase 7: {summary['num_processed']} processed; posteriors finite in "
            f"{int(ok_rows.sum())} rows, max |sum - 1| "
            f"{np.abs(post[ok_rows].sum(axis=1) - 1).max():.2e}; 3-class picks "
            f"{np.bincount(picks[ok_rows], minlength=3).tolist()} vs truth "
            f"{np.bincount(truth, minlength=3).tolist()}, exact multiplicity "
            f"{(picks == np.minimum(truth, 2))[ok_rows].mean():.3f}; statistics.json "
            f"lean_inputs={stats['lean_inputs']}, not finite at {nonfinite_json(stats)}")
        if summary["num_processed"] != RELEASE_TEST:
            fail(f"release processed {summary['num_processed']} of {RELEASE_TEST} spectra")
        if ok_rows.mean() < 0.95 or not np.allclose(post[ok_rows].sum(axis=1), 1.0, rtol=0, atol=1e-9):
            fail("release posteriors are not finite or do not sum to 1")
        if not stats["lean_inputs"] or nonfinite_json(stats):
            fail("release statistics.json is not finite or not from the lean inputs")

        # ---- the float32 CUDA reduction vs the float64 plain one (R = 1)
        model, samples, padded, prior_z, prior_num = release_inputs(pipe)
        catalog = pipe.run_catalog()
        training = pipe.training_data(catalog, pipe.run_preload(catalog))
        sub = padded.slice(slice(0, F64_SUBSET))
        reduced = {}
        reduce_r1 = lambda spectra, dtype, be: sharded_multi.process_spectra_multi_lean(
            model.to(dtype=dtype), samples.offset_samples, samples.nhi_samples, spectra,
            prior_z, prior_num, params=params, batch_size=F64_SUBSET, sample_chunk=500,
            dtype=dtype, backend=be, base_replicates=1, store_cddf_inputs=True,
        )
        for name, dtype, be in (("f32", torch.float32, backend), ("f64", torch.float64, "torch")):
            reduced[name] = reduce_r1(sub, dtype, be)
        mass_err = {}
        for name, r in reduced.items():
            keep = r.single.p_dlas > 0.05
            mass = r.cddf_inputs.hist[keep, CH_P].astype(np.float64).sum((1, 2))
            mass_err[name] = float(np.max(np.abs(mass / r.single.p_dlas[keep] - 1), initial=0.0))
        a, b = reduced["f32"].cddf_inputs, reduced["f64"].cddf_inputs
        S = len(samples.offset_samples)
        p_switch = a.spec.p_switch
        bad1 = exact_entry_mismatches((a.ex1_p, a.ex1_idx), (b.ex1_p, b.ex1_idx), p_switch)
        bad2 = exact_entry_mismatches(
            (a.ex2_p, a.ex2_idx * S + a.ex2_base), (b.ex2_p, b.ex2_idx * S + b.ex2_base), p_switch
        )
        n_exact = int((b.ex1_p >= p_switch).sum()), int((b.ex2_p >= p_switch).sum())
        say(f"phase 7: CDDF reduction f32 cuda vs f64 torch (R=1) on {F64_SUBSET} release spectra: "
            f"mass channel vs p_DLA max rel {mass_err['f32']:.2e} (f32) / {mass_err['f64']:.2e} "
            f"(f64); exact entries (f64: {n_exact[0]} first-DLA, {n_exact[1]} second-DLA) "
            f"differing away from knife edges: {bad1} first, {bad2} second")
        if not max(mass_err.values()) < MASS_RTOL:
            fail(f"the CDDF mass channel misses p_DLA: {mass_err}")
        if bad1 or bad2:
            fail("the float32 CUDA reduction's exact entries differ from the float64 ones")

        # ---- the statistics against the classic full-matrix run: lean R=1
        # (gated), and the release's R = 4 read against the scatter of the
        # base redraw (R = 1 and R = 4 at other base seeds)
        def side_run(name, **kw):
            side = tmp / name
            side.mkdir()
            for f in (pipe.catalog_path, pipe.preloaded_path, pipe.model_path, pipe.samples_path):
                shutil.copy(f, side / f.name)
            Pipeline(params, config(side, **kw)).run_all()
            return json.loads((side / "analysis" / "statistics.json").read_text())

        def redraw(R, seed):
            res = sharded_multi.process_spectra_multi_lean(
                model.to(dtype=torch.float32), samples.offset_samples, samples.nhi_samples,
                padded, prior_z, prior_num, params=params, batch_size=BATCH,
                dtype=torch.float32, backend=backend, base_replicates=R, base_seed=seed,
                store_cddf_inputs=True,
            )
            side = tmp / f"redraw_R{R}_seed{seed}"
            side.mkdir()
            for f in (pipe.samples_path, work / "snrs.npz"):
                shutil.copy(f, side / f.name)
            res.save(side / pipe.multi_results_path.name)
            lean = Pipeline(params, config(side, store_sample_likelihoods=False, cddf_inputs=True))
            return res, lean.run_analysis(plots=False)

        t0 = time.perf_counter()
        classic = side_run("classic")
        lean1 = side_run("lean1", store_sample_likelihoods=False, cddf_inputs=True, base_replicates=1)
        side_s = time.perf_counter() - t0
        fields = {
            "cddf": ("f_N", "ci68", "ci95"),
            "line_density": ("dN_dX", "ci68", "ci95"),
            "omega_dla_direct": ("omega", "err"),
            "omega_dla_cddf": ("omega", "ci68", "ci95"),
        }
        dev = lambda ref, s: {k: stat_deviation([ref[k][f] for f in fs], [s[k][f] for f in fs])
                              for k, fs in fields.items()}
        dev1, dev4 = dev(classic, lean1), dev(classic, stats)
        say(f"phase 7: statistics vs the classic full-matrix run (cuda, float32; {side_s:.1f} s for "
            f"both side runs), max rel: lean R=1 "
            + ", ".join(f"{k} {v:.2e}" for k, v in dev1.items())
            + "; the release (R=4) " + ", ".join(f"{k} {v:.2e}" for k, v in dev4.items())
            + "; bounds (R=1) " + ", ".join(f"{k} {v:.1e}" for k, v in STAT_BOUNDS.items()))
        for k, bound in STAT_BOUNDS.items():
            if not dev1[k] <= bound:
                fail(f"lean R=1 {k} deviates {dev1[k]:.3e} from classic (bound {bound:.1e})")

        t0 = time.perf_counter()
        redrawn, logs = {}, {}
        for R, seed in REDRAWS:
            with recorded_reductions(sharded_multi, logs.setdefault((R, seed), [])):
                redrawn[R, seed] = redraw(R, seed)
        redraw_s = time.perf_counter() - t0
        redraws = {key: dev(classic, s) for key, (_, s) in redrawn.items()}
        spread = lambda R: ", ".join(
            f"{k} " + "/".join(f"{d[k]:.2e}" for (r, _), d in redraws.items() if r == R)
            for k in fields
        )
        again = dev(stats, redrawn[4, 0][1])
        say(f"phase 7: the base redraw's scatter, statistics vs classic (max rel, per base seed; "
            f"{len(REDRAWS)} lean runs of {len(padded)} spectra with the analysis in "
            f"{redraw_s:.1f} s): R=1 seeds {[s for r, s in REDRAWS if r == 1]}: {spread(1)}; "
            f"R=4 seeds {[s for r, s in REDRAWS if r == 4]}: {spread(4)}; R=4 seed 0 again vs "
            f"the release: " + ", ".join(f"{k} {v:.2e}" for k, v in again.items()))
        if not max(again.values()) <= 1e-6:
            fail(f"the driver at R=4, seed 0 does not reproduce the release's statistics: {again}")

        # ---- the device reductions of the seed-0 runs redone on the host
        # from their recorded inputs: at R = 4 the base-column scatter and
        # the z-sorted pair axis's index translation do real work
        for R in (1, 4):
            res = redrawn[R, 0][0]
            hist_err, p_err, bad_idx, bad_counts = replay_reductions(
                logs[R, 0], res.cddf_inputs, BATCH
            )
            n_second = int((res.cddf_inputs.ex2_p >= res.cddf_inputs.spec.p_switch).sum())
            small2 = float(res.cddf_inputs.hist[:, CH_SMALL2_A].astype(np.float64).sum())
            say(f"phase 7: the R={R} run's {len(logs[R, 0]) - 1} device reductions (cuda, the "
                f"z-sorted pair axis) vs the float64 host reducer on their recorded inputs (pair "
                f"columns put back in sample order): hist max rel {hist_err:.2e}, exact-entry p max "
                f"rel {p_err:.2e}, indices differing {bad_idx}, counters differing {bad_counts}; "
                f"{n_second} second-DLA exact entries, small-p second-DLA mass {small2:.4f}")
            if not (hist_err <= REPLAY_RTOL and p_err <= REPLAY_RTOL) or bad_idx or bad_counts:
                fail(f"the R={R} device reduction disagrees with the host reducer on its inputs")

        # ---- broad posteriors: the F64_SUBSET spectra whose pair evidence
        # moves most between the R = 1 and R = 4 runs, at R = 1 through the
        # float32 kernel, the float32 plain path (the JAX package's XLA
        # formulas) and the float64 plain path.  A second-DLA exact entry
        # that a float32 run has and float64 has not, or the reverse, is a
        # miss.  Away from p_switch's knife edge a miss must come from the
        # other knife edge, the inverse-CDF draw: a float32 run that draws
        # a row's bases as float64 does gives its pair posteriors to within
        # the float32 evidences' error, so every miss lies in a row where
        # some pair column drew another base sample than in float64 (most
        # on that very column; else its row's normalization moved)
        ev2 = [redrawn[R, 0][0].log_likelihoods_dla2.astype(np.float64) for R in (1, 4)]
        moved = np.nan_to_num(np.abs(ev2[0] - ev2[1]), nan=0.0)
        pick = np.sort(np.argsort(-moved, kind="stable")[:F64_SUBSET])
        broad = padded.slice(pick)
        runs, draws = {}, {}
        for name, dtype, be in (("f32 cuda", torch.float32, backend),
                                ("f32 torch", torch.float32, "torch"),
                                ("f64 torch", torch.float64, "torch")):
            log = []
            with recorded_reductions(sharded_multi, log):
                runs[name] = reduce_r1(broad, dtype, be).cddf_inputs
            draws[name] = recorded_base_draws(log)
        # the recorded draws are the runs' own: each entry's base is the
        # draw of its pair column
        for name, c in runs.items():
            live = c.ex2_p > 0
            rows = np.nonzero(live)[0]
            if not np.array_equal(draws[name][rows, c.ex2_idx[live].astype(np.int64)],
                                  c.ex2_base[live].astype(np.int64)):
                fail(f"phase 7: the recorded base draws of the {name} run are not its entries' bases")
        second = lambda c: (c.ex2_p, c.ex2_idx * S + c.ex2_base)
        ref, f32s = runs["f64 torch"], ("f32 cuda", "f32 torch")
        miss = {name: exact_entry_diff(second(runs[name]), second(ref), p_switch) for name in f32s}
        away = lambda d: {key for key, p in d.items() if p >= p_switch * (1 + KNIFE_EDGE)}
        redrew = {name: draws[name] != draws["f64 torch"] for name in f32s}
        same_draw = {name: sorted((row, key) for row, key in away(miss[name])
                                  if not redrew[name][row, key // S]) for name in f32s}
        same_row = {name: sorted((row, key) for row, key in away(miss[name])
                                 if not redrew[name][row].any()) for name in f32s}
        say(f"phase 7: the {F64_SUBSET} release spectra whose pair evidence moves most between "
            f"R=1 and R=4 (|d ev2| {moved[pick].min():.2f}-{moved[pick].max():.2f}), R=1: f64 holds "
            f"{int((ref.ex2_p >= p_switch).sum())} second-DLA exact entries; missed by f32 cuda "
            f"{len(miss['f32 cuda'])} ({len(away(miss['f32 cuda']))} away from knife edges), by "
            f"f32 torch {len(miss['f32 torch'])} ({len(away(miss['f32 torch']))}), by both "
            f"{len(miss['f32 cuda'].keys() & miss['f32 torch'].keys())}; base draws that differ "
            f"from f64 of {redrew['f32 cuda'].size}: f32 cuda {int(redrew['f32 cuda'].sum())}, "
            f"f32 torch {int(redrew['f32 torch'].sum())}, both "
            f"{int((redrew['f32 cuda'] & redrew['f32 torch']).sum())}, in "
            f"{int(redrew['f32 cuda'].any(axis=1).sum())} / {int(redrew['f32 torch'].any(axis=1).sum())} "
            f"of {len(pick)} rows; misses away from knife edges whose own pair column drew the same "
            f"base: {same_draw}, whose whole row did: {same_row}")
        if any(same_row.values()):
            fail(f"float32 second-DLA exact entries miss float64 in rows that drew every base "
                 f"as float64 does: {same_row}")
    say("phase 7 ok")
    return {
        "launches": launches,
        "batches": n_batches,
        "stage_seconds": seconds,
        "cddf_off_spectra_per_s": off_rate,
        "cddf_on_spectra_per_s": on_rate,
        "training": training,
        "training_params": params,
    }


def result_arrays(res) -> dict:
    """Every array of a driver's result (InferenceResults, or
    MultiDLAResults with its single stage and CDDF inputs), by name."""
    import numpy as np

    single = getattr(res, "single", res)
    out = {f.name: getattr(single, f.name) for f in dataclasses.fields(single)
           if isinstance(getattr(single, f.name), np.ndarray)}
    if single is not res:
        out.update({"multi_" + f.name: getattr(res, f.name) for f in dataclasses.fields(res)
                    if isinstance(getattr(res, f.name), np.ndarray)})
        if res.cddf_inputs is not None:
            out["cddf_hist"], out["cddf_ex"] = res.cddf_inputs.hist, res.cddf_inputs.ex
    return out


def digest(arrays: dict) -> dict:
    """sha256 of each array's bytes, dtype and shape."""
    import hashlib

    return {k: hashlib.sha256(f"{v.dtype}{v.shape}".encode() + v.tobytes()).hexdigest()
            for k, v in arrays.items()}


def rank_runs(mesh, inputs, ckpt_root, serial=False):
    """The phase-8 runs of one rank on ``mesh``, each with the defaults
    (the card, float32, the kernels, the pipelined loop; the serial loop
    when ``serial``): (name, thunk) pairs."""
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
        ShardedRunConfig,
        process_spectra_sharded,
    )
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_sharded

    model, offsets, nhis, spectra, prior_z, prior_num, params = inputs
    config = lambda name, **kw: ShardedRunConfig(
        per_device_batch=RANK_BATCH,
        checkpoint_dir=None if ckpt_root is None else str(ckpt_root / name),
        **(SERIAL if serial else {}), **kw,
    )
    single = lambda name, **kw: process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num >= 1, params=params, mesh=mesh,
        config=config(name, **kw),
    )
    multi = lambda name, **kw: process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num, params=params, mesh=mesh,
        config=config(name, **kw),
    )
    return [
        ("single_full", lambda: single("single_full")),
        ("single_lean", lambda: single("single_lean", store_sample_likelihoods=False)),
        ("chain", lambda: multi("chain", store_sample_likelihoods=False, store_cddf_inputs=True)),
        ("classic", lambda: multi("classic")),
    ]


def sample_chain_run(mesh, inputs):
    """Phase 8's fused lean chain for the sample axis: ``backend="torch"``
    (the kernels run data-parallel only), float32 on the card, CDDF
    inputs, on phase 6's first SAMPLE_CHAIN spectra at full width."""
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import ShardedRunConfig
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_sharded

    model, offsets, nhis, spectra, prior_z, prior_num, params = inputs
    return process_spectra_multi_sharded(
        model, offsets, nhis, spectra.slice(slice(0, SAMPLE_CHAIN)), prior_z, prior_num,
        params=params, mesh=mesh,
        config=ShardedRunConfig(per_device_batch=SAMPLE_CHAIN_BATCH, backend="torch",
                                store_sample_likelihoods=False, store_cddf_inputs=True),
    )


def load_inputs(path):
    """Phase 6's workload as saved by ``ranks_phase``: (model, offsets,
    nhis, spectra, prior z, prior DLA counts) on the card, and the
    release's training data."""
    import numpy as np

    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.models.training import TrainingData

    with np.load(path) as f:
        a = {k: f[k] for k in f.files}
    model = GPModel.from_numpy(a["grid"], a["mu"], a["M"], a["log_omega"],
                               *a["log_params"].tolist())
    spectra = PaddedSpectra(a["wavelengths"], a["flux"], a["noise_variance"], a["mask"],
                            a["z_qso"])
    training = TrainingData(**{k.removeprefix("train_"): v for k, v in a.items()
                               if k.startswith("train_")})
    return (model, a["offsets"], a["nhis"], spectra, a["prior_z"], a["prior_num"]), training


def rank_worker(rank, world, addr, backend, inputs_path, params, training_params, out_dir, log):
    """One rank of phase 8, spawned by ``ranks_phase``: joins the process
    group, runs ``rank_runs`` on the data mesh (and with two ranks the
    single driver on a data 1 x sample 2 mesh and the training), and
    saves per run the wall seconds, the kernel launches, the checkpoint
    writes and the result (its digest; rank 0 also the arrays)."""
    import os

    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.environ["LOCAL_RANK"] = str(rank)
    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.models.training import learn_gp_model
    from gp_dla_detection_tpu_torch.ops import evidence
    from gp_dla_detection_tpu_torch.parallel import batches
    from gp_dla_detection_tpu_torch.parallel.mesh import (
        broadcast_object,
        fetch_global,
        initialize_distributed,
        make_mesh,
        shutdown,
    )
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
        ShardedRunConfig,
        process_spectra_sharded,
    )
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_lean

    writes = [0]
    savez = batches.atomic_savez

    def counted(*a, **kw):
        writes[0] += 1
        return savez(*a, **kw)

    batches.atomic_savez = counted
    initialize_distributed(addr, world, rank, backend=backend)
    try:
        inputs, training = load_inputs(inputs_path)
        inputs = (*inputs, params)
        out_dir = Path(out_dir)
        mesh = make_mesh()
        # the collectives' and the process's first use (connections, the
        # NCCL communicator, cuBLAS, the kernel library, the allocator)
        # before any timed run: one untimed lean run
        fetch_global(np.zeros(1), mesh)
        broadcast_object(None, mesh)
        rank_runs(mesh, inputs, None)[1][1]()
        runs = rank_runs(mesh, inputs, out_dir / f"ckpt_{backend}")
        if world > 1:
            model, offsets, nhis, spectra, prior_z, prior_num, _ = inputs
            sample_mesh = make_mesh(sample_parallelism=world)
            runs.append(("sample_full", lambda: process_spectra_sharded(
                model, offsets, nhis, spectra, prior_z, prior_num >= 1, params=params,
                mesh=sample_mesh, config=ShardedRunConfig(per_device_batch=RANK_BATCH))))
            runs.append(("sample_chain", lambda: sample_chain_run(sample_mesh, inputs)))
            # the defaults (the kernels) on the sample axis: refused
            try:
                process_spectra_multi_lean(model, offsets, nhis, spectra, prior_z, prior_num,
                                           params=params, mesh=sample_mesh)
                refused = ""
            except ValueError as exc:
                refused = str(exc)
            (out_dir / f"{backend}_refused_p{rank}.json").write_text(json.dumps(refused))
        for name, run in runs:
            evidence.launch_count = evidence.pair_launch_count = 0
            writes[0] = 0
            sync()
            t0 = time.perf_counter()
            arrays = result_arrays(run())
            sync()
            seconds = time.perf_counter() - t0
            meta = {"seconds": seconds, "launches": [evidence.launch_count, evidence.pair_launch_count],
                    "writes": writes[0], "digest": digest(arrays)}
            (out_dir / f"{backend}_{name}_p{rank}.json").write_text(json.dumps(meta))
            if rank == 0:
                np.savez(out_dir / f"{backend}_{name}.npz", **arrays)
        if world > 1:
            sync()
            t0 = time.perf_counter()
            _, res = learn_gp_model(training, training_params, mesh=mesh, optimizer="host")
            meta = {"seconds": time.perf_counter() - t0, "f": res.f, "iterations": res.iterations,
                    "fun_evals": res.fun_evals, "message": res.message}
            (out_dir / f"{backend}_train_p{rank}.json").write_text(json.dumps(meta))
    finally:
        shutdown()


def run_ranks(world, backend, inputs_path, params, training_params, out_dir) -> float:
    """Spawn ``world`` ranks of ``rank_worker`` (one free port), wait for
    them (RANK_TIMEOUT), leave none running; fail with their logs if one
    fails.  Returns the wall seconds."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    logs = [out_dir / f"{backend}_rank{r}.log" for r in range(world)]
    procs = [
        ctx.Process(target=rank_worker, args=(r, world, addr, backend, str(inputs_path), params,
                                              training_params, str(out_dir), str(logs[r])))
        for r in range(world)
    ]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, RANK_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            tail = logs[r].read_text()[-3000:] if logs[r].exists() else ""
            fail(f"phase 8: {backend} rank {r} of {world} exited with {p.exitcode}:\n{tail}")
    return seconds


def compare_results(got: dict, ref: dict, plain_cddf: bool = False) -> bool:
    """Every array bit-identical.  ``plain_cddf``: runs on the plain path
    (``backend="torch"``), whose CDDF reduction sums float64 with
    scatter_add_, whose atomics add in another order from run to run: the
    cddf_* arrays are left out (the caller bounds them).  Under the
    kernels (``csrc/cddf.cu``) every array is held bit for bit."""
    import numpy as np

    return sorted(got) == sorted(ref) and all(
        np.array_equal(got[k], v, equal_nan=v.dtype.kind == "f")
        for k, v in ref.items() if not (plain_cddf and k.startswith("cddf_"))
    )


def ranks_phase(smi: str, w: dict, chain, release: dict) -> dict:
    """Phase 8: the drivers across ranks.  Two gloo ranks share the card
    (NCCL refuses two ranks on one GPU), then one NCCL rank; each holds
    the whole result, equal bit for bit to this process's run at the same
    per-rank batch; only rank 0 writes checkpoints, which a one-rank run
    resumes; the sample axis within the kernel bound and the decision
    gate; training on two ranks to the one-rank NLL.  Two ranks on one
    card measure correctness, not scaling."""
    import tempfile

    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.models.training import learn_gp_model
    from gp_dla_detection_tpu_torch.ops import evidence, lbfgs_device
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
        ShardedRunConfig,
        process_spectra_sharded,
    )

    *inputs, params = chain
    model, offsets, nhis, spectra, prior_z, prior_num = inputs
    training, training_params = release["training"], release["training_params"]
    n_super = -(-len(spectra) // (2 * RANK_BATCH))
    os.environ["GPDLA_DRIVER_TIMING"] = "1"    # here and in the ranks it spawns
    with tempfile.TemporaryDirectory(prefix="gpdla_ranks_") as tmp:
        tmp = Path(tmp)
        inputs_path = tmp / "inputs.npz"
        np.savez(
            inputs_path, grid=w["grid"], mu=w["mu"], M=w["M"], log_omega=w["log_omega"],
            log_params=np.array([w["log_c_0"], w["log_tau_0"], w["log_beta"]]),
            offsets=offsets, nhis=nhis, wavelengths=spectra.wavelengths, flux=spectra.flux,
            noise_variance=spectra.noise_variance, mask=spectra.mask, z_qso=spectra.z_qso,
            prior_z=prior_z, prior_num=prior_num,
            **{f"train_{f.name}": getattr(training, f.name) for f in dataclasses.fields(training)},
        )

        # ---- this process, one device, at the per-rank batch, with
        # checkpoints as the ranks write them: the serial loop (the
        # reference) and the default in turns, each batch's stage times
        # printed (GPDLA_DRIVER_TIMING=1, here and in the ranks)
        ref, ref_seconds, pipelined_seconds, stages = {}, {}, {}, {}
        for turn, serial in enumerate((True, False, False, True)):
            runs = rank_runs(None, (*inputs, params), tmp / f"ckpt_one_{turn}", serial=serial)
            for name, run in runs:
                lines = io.StringIO()
                sync()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(lines):
                    got = result_arrays(run())
                sync()
                seconds = time.perf_counter() - t0
                key = (name, "serial" if serial else "default")
                stages.setdefault(key, []).append(stage_means(lines.getvalue()))
                if name not in ref:
                    ref[name], ref_seconds[name], pipelined_seconds[name] = got, [], []
                same = compare_results(got, ref[name])
                if not same:
                    fail(f"phase 8: {name} in one process at depth "
                         f"{1 if serial else 'default'} differs from the serial run")
                (ref_seconds if serial else pipelined_seconds)[name].append(seconds)
        secs = lambda v: "/".join(f"{x:.3f}" for x in v)
        for name in ref:
            mean = lambda d: ", ".join(
                f"{k} {sum(m[k] for m in stages[name, d]) / len(stages[name, d]):.4f}"
                for k in stages[name, d][0] if k != "batches")
            say(f"phase 8: {name} in one process on {len(spectra)} spectra (batch {RANK_BATCH}), "
                f"wall s, in turns: depth 1 {secs(ref_seconds[name])}, the default (depth 4) "
                f"{secs(pipelined_seconds[name])}, bit-identical"
                + (" (the CDDF inputs included)" if name == "chain" else "")
                + f"; per-batch stage s (GPDLA_DRIVER_TIMING=1, {stages[name, 'serial'][0]['batches']} "
                f"batch lines a run): depth 1 {mean('serial')}; the default {mean('default')} ({smi})")
        # the ranks run the default: their one-process yardstick
        ref_seconds = {k: min(v) for k, v in pipelined_seconds.items()}
        sync()
        t0 = time.perf_counter()
        ref_chain = result_arrays(sample_chain_run(None, (*inputs, params)))
        sync()
        ref_chain_s = time.perf_counter() - t0

        wall = {"gloo": run_ranks(2, "gloo", inputs_path, params, training_params, tmp),
                "nccl": run_ranks(1, "nccl", inputs_path, params, training_params, tmp)}
        for backend in wall:
            m = stage_means((tmp / f"{backend}_rank0.log").read_text())
            say(f"phase 8: {backend} rank 0's per-batch stage s over all its runs "
                f"({m.pop('batches')} batch lines): "
                + ", ".join(f"{k} {v:.4f}" for k, v in m.items()) + f" ({smi})")
        meta = lambda backend, name, r: json.loads((tmp / f"{backend}_{name}_p{r}.json").read_text())
        with np.load(tmp / "gloo_sample_full.npz") as f:
            sample_full = {k: f[k] for k in f.files}
        for backend, world in (("gloo", 2), ("nccl", 1)):
            for name in ref:
                with np.load(tmp / f"{backend}_{name}.npz") as f:
                    got = {k: f[k] for k in f.files}
                metas = [meta(backend, name, r) for r in range(world)]
                same = compare_results(got, ref[name])
                replicated = all(m["digest"] == digest(got) for m in metas)
                pair = 1 if name == "chain" or name == "classic" else 0
                n_batches = -(-len(spectra) // (world * RANK_BATCH))
                want = [n_batches, pair * n_batches]
                launches = [m["launches"] for m in metas]
                # the classic flow checkpoints both stages
                want_writes = [n_batches * (2 if name == "classic" else 1)] + [0] * (world - 1)
                writes = [m["writes"] for m in metas]
                say(f"phase 8: {name}, {world} {backend} rank(s) on {len(spectra)} spectra "
                    f"(batch {RANK_BATCH} per rank): wall {max(m['seconds'] for m in metas):.3f} s "
                    f"(one process: {ref_seconds[name]:.3f} s); bit-identical to one process "
                    f"{same}" + (" (the CDDF inputs included)" if name == "chain" else "")
                    + f", every rank holds it {replicated}; (single, pair) launches per rank "
                    f"{launches}; checkpoint files written per rank {writes} "
                    f"(ranks share one card: correctness, not scaling; {smi})")
                if not same or not replicated:
                    fail(f"phase 8: {name} on {world} {backend} rank(s) differs from one process")
                if any(l != want for l in launches) or writes != want_writes:
                    fail(f"phase 8: {name}: launches {launches} (want {want} per rank), "
                         f"writes {writes} (want {want_writes})")

        # ---- a one-rank rerun resumes every batch the two ranks wrote
        evidence.launch_count = 0
        resumed = process_spectra_sharded(
            model, offsets, nhis, spectra, prior_z, prior_num >= 1, params=params,
            config=ShardedRunConfig(per_device_batch=2 * RANK_BATCH,
                                    checkpoint_dir=str(tmp / "ckpt_gloo" / "single_full")),
        )
        resumed_same = all(np.array_equal(v, ref["single_full"][k])
                           for k, v in result_arrays(resumed).items())
        say(f"phase 8: one-rank rerun on the two ranks' checkpoints ({n_super} super-batches of "
            f"{2 * RANK_BATCH}): {evidence.launch_count} launches, results equal {resumed_same}")
        if evidence.launch_count or not resumed_same:
            fail("phase 8: the one-rank rerun did not resume every batch")

        # ---- the sample axis: kernel bound and decision gate
        err = normalized_error(torch.as_tensor(sample_full["sample_log_likelihoods_dla"]),
                               torch.as_tensor(ref["single_full"]["sample_log_likelihoods_dla"]))
        p_one, p_split = ref["single_full"]["p_dlas"], sample_full["p_dlas"]
        flips = (p_one > 0.9) != (p_split > 0.9)
        hard = int((flips & (np.abs(p_one - 0.9) > DECISION_MARGIN)).sum())
        dp = np.abs(p_split - p_one)
        p99 = float(np.quantile(dp, 0.99))
        m = meta("gloo", "sample_full", 0)
        say(f"phase 8: single driver on a data 1 x sample 2 mesh (2 gloo ranks, {len(offsets) // 2} "
            f"z-sorted samples each): wall {m['seconds']:.3f} s; vs one process normalized {err[0]:.3e}, "
            f"abs {err[1]:.3e}; flips outside margin {hard}, |dp| p99 {p99:.3e} max "
            f"{dp.max():.3e}; launches per rank {[meta('gloo', 'sample_full', r)['launches'] for r in range(2)]} "
            f"({smi})")
        if not err[0] < NORMALIZED_BOUND or hard or not p99 < DECISION_P99:
            fail("phase 8: the sample-axis run fails the kernel bound or the decision gate")

        # ---- the fused chain on the sample axis ("torch"), and the
        # kernels' refusal of it
        with np.load(tmp / "gloo_sample_chain.npz") as f:
            got = {k: f[k] for k in f.files}
        metas = [meta("gloo", "sample_chain", r) for r in range(2)]
        same = compare_results(got, ref_chain, plain_cddf=True)
        replicated = all(m["digest"] == digest(got) for m in metas)
        hist_rel = float(np.max(np.abs(got["cddf_hist"].astype(np.float64) - ref_chain["cddf_hist"])
                                / np.maximum(np.abs(ref_chain["cddf_hist"]), 1e-30)))
        pick = lambda a: np.argmax(a["multi_model_posteriors"], axis=1)
        picks_same = np.array_equal(pick(got), pick(ref_chain))
        nan_same = np.array_equal(np.isnan(got["multi_log_likelihoods_dla2"]),
                                  np.isnan(ref_chain["multi_log_likelihoods_dla2"]))
        ev_err = max(
            normalized_error(torch.as_tensor(np.nan_to_num(got[k])),
                             torch.as_tensor(np.nan_to_num(ref_chain[k])))[0]
            for k in ("log_likelihoods_no_dla", "log_likelihoods_dla", "multi_log_likelihoods_dla2")
        )
        p_one, p_split = ref_chain["p_dlas"], got["p_dlas"]
        hard = int((((p_one > 0.9) != (p_split > 0.9)) & (np.abs(p_one - 0.9) > DECISION_MARGIN)).sum())
        p99 = float(np.quantile(np.abs(p_split - p_one), 0.99))
        if same:
            verdict = "bit-identical to one process"
        else:
            diff = sorted(k for k in ref_chain if not k.startswith("cddf_")
                          and not np.array_equal(got[k], ref_chain[k],
                                                 equal_nan=got[k].dtype.kind == "f"))
            verdict = (f"not bit-identical ({', '.join(diff)} differ); evidences normalized "
                       f"{ev_err:.3e}, flips outside margin {hard}, |dp| p99 {p99:.3e}")
        refused = [json.loads((tmp / f"gloo_refused_p{r}.json").read_text()) for r in range(2)]
        chain_launches = [m["launches"] for m in metas]
        say(f"phase 8: fused lean chain (torch, float32, CDDF inputs) on a data 1 x sample 2 mesh "
            f"(2 gloo ranks, {len(offsets) // 2} columns of the one-device layout each, both stages) on "
            f"{SAMPLE_CHAIN} spectra, batch {SAMPLE_CHAIN_BATCH}: wall {max(m['seconds'] for m in metas):.3f} s "
            f"(one process: {ref_chain_s:.3f} s); {verdict}; 3-class picks equal {picks_same}, "
            f"NaN pair rows equal {nan_same}, CDDF hist max rel {hist_rel:.1e}; every rank holds "
            f"it {replicated}; launches per rank {chain_launches}; the kernels (the defaults) "
            f"refused on the sample mesh by every rank {all('data-only mesh' in r for r in refused)} "
            f"({smi})")
        if not replicated or not picks_same or not nan_same or not hist_rel <= REPLAY_RTOL:
            fail("phase 8: the sample-axis chain differs from one process")
        if not same and (not ev_err < NORMALIZED_BOUND or hard or not p99 < DECISION_P99):
            fail("phase 8: the sample-axis chain fails the kernel bound or the decision gate")
        if any(l != [0, 0] for l in chain_launches):
            fail(f"phase 8: the torch sample-axis chain launched kernels: {chain_launches}")
        if not all("data-only mesh" in r for r in refused):
            fail(f"phase 8: the kernels were not refused on the sample mesh: {refused}")

        # ---- training: the device optimizer on the card, and two ranks
        results = {}
        for optimizer in ("host", "device"):
            syncs = lbfgs_device.host_syncs
            sync()
            t0 = time.perf_counter()
            _, res = learn_gp_model(training, training_params, optimizer=optimizer)
            sync()
            results[optimizer] = (res, time.perf_counter() - t0, lbfgs_device.host_syncs - syncs)
        (h, h_s, _), (d, d_s, d_syncs) = results["host"], results["device"]
        train = [meta("gloo", "train", r) for r in range(2)]
        rel2 = abs(train[0]["f"] / h.f - 1)
        say(f"phase 8: training on the release's {training.num_quasars} spectra, budget "
            f"{training_params.optimization.max_iterations} iterations / "
            f"{training_params.optimization.max_fun_evals} evaluations, float64 on the card: host "
            f"L-BFGS NLL {h.f:.6f} ({h.message}, {h.iterations} it, {h.fun_evals} evals, {h_s:.2f} s, "
            f"one gradient to the host per evaluation); device L-BFGS NLL {d.f:.6f} ({d.message}, "
            f"{d.iterations} it, {d.fun_evals} evals, {d_s:.2f} s, {d_syncs} scalar reads = "
            f"{d_syncs / d.fun_evals:.2f} per evaluation); 2 gloo ranks, host L-BFGS: NLL "
            f"{train[0]['f']:.6f} ({train[0]['message']}, {train[0]['iterations']} it, "
            f"{train[0]['seconds']:.2f} s), {rel2:.2e} from one rank ({smi})")
        if not rel2 < 1e-6 or train[0]["f"] != train[1]["f"]:
            fail("phase 8: two-rank training misses the one-rank NLL")
        if not np.isfinite(d.f):
            fail("phase 8: the device L-BFGS did not reach a finite NLL")
    del os.environ["GPDLA_DRIVER_TIMING"]
    say(f"phase 8 ok: 2 gloo ranks {wall['gloo']:.1f} s, 1 NCCL rank {wall['nccl']:.1f} s "
        "(process start and CUDA set-up included)")
    return {"wall": wall, "device_lbfgs_syncs_per_eval": d_syncs / d.fun_evals}


SERIAL = {"pipeline_depth": 1}   # the serial loop


@contextlib.contextmanager
def strict_issue():
    """The drivers with every ``issue`` of the pipelined loop run
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync there
    (a read of a device value, a copy from pageable memory) raises."""
    import torch

    from gp_dla_detection_tpu_torch.parallel import batches as module

    real = module.run_pipelined_split

    def split(items, upload, issue, complete, **kw):
        def strict(item, uploaded):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return issue(item, uploaded)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        real(items, upload, strict, complete, **kw)

    module.run_pipelined_split = split
    try:
        yield
    finally:
        module.run_pipelined_split = real


def same_bits(a: dict, b: dict) -> bool:
    """Every array of two results equal bit for bit (NaNs in place)."""
    import numpy as np

    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k], v, equal_nan=v.dtype.kind == "f") for k, v in b.items())


def stage_means(text: str) -> dict:
    """Mean seconds per batch of each stage in ``[driver]`` lines
    (``GPDLA_DRIVER_TIMING=1``), and the number of batches."""
    import re

    sums, n = {}, 0
    for line in text.splitlines():
        if line.startswith("[driver] batch"):
            n += 1
            for what, sec in re.findall(r"(\w+) ([0-9.]+)s", line):
                sums[what] = sums.get(what, 0.0) + float(sec)
    return {"batches": n, **{k: v / max(n, 1) for k, v in sums.items()}}


def profile_split(fn, window: str = "gpdla_profiled"):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity): (its
    result, the split of the wall of ``window`` -- a ``record_function``
    range that ``fn`` opens, else the whole call -- into the evidence
    kernels' device time, the other device ops' (the union of every
    device interval less the kernels'), the device's idle time and the
    calling thread's wait for the card (CUDA synchronize calls and
    launches blocked on a full launch queue), with the five device
    ops and the five host ops of that thread that took most time), or
    (result, None) when the trace holds no device event.  The profiler's
    own cost is in the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("gpdla_profiled"):
            out = fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == window) if any(
        e.name == window for e in events) else next(e for e in events if e.name == "gpdla_profiled")
    t0, t1 = span.time_range.start, span.time_range.end
    inside = lambda e: t0 <= e.time_range.start <= t1

    def union(spans) -> float:
        total, end = 0.0, t0
        for a, b in sorted(spans):
            a, b = max(a, end), min(b, t1)
            if b > a:
                total += b - a
                end = b
        return total

    def totals(pairs) -> dict:
        sums = {}
        for name, us in pairs:
            sums[name[:48]] = sums.get(name[:48], 0.0) + us / 1e6
        return sums

    def top(pairs) -> list:
        return sorted(totals(pairs).items(), key=lambda kv: -kv[1])[:5]

    # the device timeline also carries the record_function ranges: not work
    device = [e for e in events if e.device_type == DeviceType.CUDA and inside(e)
              and not e.name.startswith("gpdla_") and not getattr(e, "is_user_annotation", False)]
    if not device:
        return out, None
    spans = lambda evs: ((e.time_range.start, e.time_range.end) for e in evs)
    busy = union(spans(device))
    kernels = union(spans(e for e in device
                          if "evidence_kernel" in e.name or "table_kernel" in e.name))
    host = [e for e in events if e.device_type == DeviceType.CPU and e.thread == span.thread
            and inside(e) and e is not span]
    # waiting for the card: a synchronize, or a launch blocked on a full
    # launch queue ("Command Buffer Full")
    waits = sum(e.time_range.end - e.time_range.start for e in host
                if "Synchronize" in e.name or e.name == "Command Buffer Full")
    us = 1e6
    return out, {
        "wall": (t1 - t0) / us, "kernels": kernels / us, "other_device": (busy - kernels) / us,
        "device_idle": (t1 - t0 - busy) / us, "host_waiting": waits / us,
        "device_events": len(device),
        "top_device": top((e.name, e.time_range.end - e.time_range.start) for e in device),
        "top_host": top((e.name, e.self_cpu_time_total) for e in host),
        # every thread's host ops (the checkpoint writer's among them),
        # summed by name: what a cold run pays that a warm one
        # does not
        "host_ops": totals((e.name, e.self_cpu_time_total) for e in events
                           if e.device_type == DeviceType.CPU and inside(e) and e is not span),
    }


def cold_cost(cold, warm) -> str:
    """The host ops (every thread) that took most more time in ``cold``
    than in ``warm`` (two ``profile_split`` splits), with both times."""
    extra = sorted(((cold["host_ops"].get(k, 0.0) - warm["host_ops"].get(k, 0.0), k)
                    for k in cold["host_ops"]), reverse=True)[:6]
    return ", ".join(f"{k} {cold['host_ops'].get(k, 0.0):.4f} s vs {warm['host_ops'].get(k, 0.0):.4f} s"
                     for _, k in extra)


def split_text(split) -> str:
    if split is None:
        return "profiler split not measured (the trace holds no device event)"
    w = split["wall"]
    return (f"profiled wall {w:.3f} s = evidence kernels {split['kernels']:.3f} s "
            f"({split['kernels'] / w:.3f}) + other device ops {split['other_device']:.3f} s "
            f"({split['other_device'] / w:.3f}) + device idle {split['device_idle']:.3f} s "
            f"({split['device_idle'] / w:.3f}); the calling thread waited for the card "
            f"(synchronize, full launch queue) "
            f"{split['host_waiting']:.3f} s and worked {w - split['host_waiting']:.3f} s "
            f"({split['device_events']} device events); device ops by time: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in split["top_device"])
            + "; the calling thread's host ops by self time: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in split["top_host"]))


@contextlib.contextmanager
def timed_wrappers(evidence):
    """Both kernel wrappers, each call bracketed by CUDA events on the
    current stream (nothing synchronizes): yields {"single": [...],
    "pair": [...]} of (start, stop) event pairs, to be read after a
    synchronize.  The wrappers and their counters run unchanged."""
    import torch

    real = {"single": evidence.sample_log_likelihoods, "pair": evidence.sample_log_likelihoods_pair}
    spans = {name: [] for name in real}

    def timed(name):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*a, **kw)
            stop.record()
            spans[name].append((start, stop))
            return out
        return call

    evidence.sample_log_likelihoods = timed("single")
    evidence.sample_log_likelihoods_pair = timed("pair")
    try:
        yield spans
    finally:
        evidence.sample_log_likelihoods = real["single"]
        evidence.sample_log_likelihoods_pair = real["pair"]


def first_rows(results, n: int):
    """``results`` (InferenceResults) with every per-spectrum array cut
    to its first ``n`` rows."""
    import numpy as np

    N = len(results.p_dlas)
    cut = lambda a: a[:n] if isinstance(a, np.ndarray) and a.shape[:1] == (N,) else a
    return dataclasses.replace(
        results, **{f.name: cut(getattr(results, f.name)) for f in dataclasses.fields(results)}
    )


def scale_demo_phase(smi: str) -> dict:
    """Phase 9: ``scripts/torch_scale_demo.py`` at its defaults (1024
    spectra x 10,000 samples, the classic two-stage flow with per-batch
    checkpoints, float32, the kernels): its JSON lines, the launches per
    batch from the counters, each launch's device time (CUDA events around
    the wrapper calls) and the kernels' share of the wall time, finite
    posteriors that sum to 1, and the exact-multiplicity accuracy above
    SCALE_DEMO_ACC.  Then the demo's first batch (SCALE_BATCH spectra, the
    kernels' batch shape and table workspace) through both wrappers, the
    pair on the demo's own base draws: each half launched alone gives the
    same rows bit for bit, and the single kernel is as close to float64
    as its plain float32 version (F32_ACCURACY_RATIO); the batch through
    the plain driver path (float32, the pair stage on the demo's
    single-stage rows so that both draw the same bases) for the decision
    gate on p_DLA and on the 3-class posteriors."""
    import runpy

    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi
    from gp_dla_detection_tpu_torch.ops import evidence
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig, process_spectra_sharded

    demo = runpy.run_path(str(Path(__file__).resolve().parent / "scripts" / "torch_scale_demo.py"))
    with timed_wrappers(evidence) as spans:
        evidence.launch_count = evidence.pair_launch_count = 0
        out = demo["main"]()
        launches = (evidence.launch_count, evidence.pair_launch_count)
    torch.cuda.synchronize()
    call_ms = {name: [a.elapsed_time(b) for a, b in v] for name, v in spans.items()}
    if (len(call_ms["single"]), len(call_ms["pair"])) != launches:
        fail(f"phase 9: {launches} launches but wrapper calls {[len(v) for v in call_ms.values()]}")
    kernel_s = sum(map(sum, call_ms.values())) / 1e3
    res = out["results"]

    # ---- the demo's loop at depth 1 and at its default (depth 4, upload
    # thread) in turns after the main run, every result bit-identical,
    # then a profiled run at the default
    import gp_dla_detection_tpu_torch.parallel as parallel

    default_config = parallel.ShardedRunConfig

    default_driver = parallel.process_spectra_multi_sharded

    def driver(*a, **kw):
        # the demo's timed call, marked for the profiler
        with torch.profiler.record_function("gpdla_driver"):
            res = default_driver(*a, **kw)
            torch.cuda.synchronize()
        return res

    def demo_run(serial: bool):
        parallel.ShardedRunConfig = (
            (lambda **kw: default_config(**SERIAL, **kw)) if serial else default_config)
        parallel.process_spectra_multi_sharded = driver
        try:
            return demo["main"]()
        finally:
            parallel.ShardedRunConfig = default_config
            parallel.process_spectra_multi_sharded = default_driver

    walls = {"serial": [], "default": [out["seconds"]]}
    for serial in (True, False, False, True):
        again = demo_run(serial)
        if not same_bits(result_arrays(again["results"]), result_arrays(res)):
            fail(f"phase 9: the scale demo at depth {1 if serial else 'default'} differs from "
                 "the main run")
        walls["serial" if serial else "default"].append(again["seconds"])
    n_demo = out["n_spectra"]
    rates = lambda v: "/".join(f"{n_demo / t:.1f}" for t in v)
    say(f"phase 9: the scale demo in turns, spectra/s end to end: depth 1 {rates(walls['serial'])}, "
        f"the default {rates(walls['default'])}; every run bit-identical to the main run ({smi})")
    for serial in (False, True):
        profiled, split = profile_split(lambda: demo_run(serial), window="gpdla_driver")
        say(f"phase 9: {'depth 1' if serial else 'the default'} under torch.profiler "
            f"({profiled['seconds']} s timed by the demo): {split_text(split)} ({smi})")
    n_batches = -(-out["n_spectra"] // SCALE_BATCH)
    post = res.model_posteriors
    finite = bool(np.isfinite(post).all() and np.isfinite(res.single.p_dlas).all())
    sums = bool(np.allclose(post.sum(axis=1), 1.0, rtol=0, atol=1e-9))
    ms_text = lambda v: "/".join(f"{x:.2f}" for x in v)
    say(f"phase 9: scale demo, {out['n_spectra']} spectra x {out['num_samples']} samples "
        f"(classic two-stage flow, checkpoints, {out['backend']}, float32): {out['seconds']} s = "
        f"{out['spectra_per_sec_end_to_end']} spectra/s end to end; launches (single, pair) "
        f"{launches} for {n_batches} batches of {SCALE_BATCH} = ({launches[0] / n_batches:.2f}, "
        f"{launches[1] / n_batches:.2f}) per batch; device ms per wrapper call (CUDA events, "
        f"B={SCALE_BATCH}): single {ms_text(call_ms['single'])}, pair {ms_text(call_ms['pair'])}; "
        f"the kernels {kernel_s:.3f} s = {kernel_s / out['seconds']:.3f} of the wall, the rest "
        f"outside them; exact multiplicity {out['exact_multiplicity_acc']}, detection "
        f"{out['detection_rate']}, clean false positives {out['clean_false_positive_rate']}; "
        f"posteriors finite {finite}, sum to 1 {sums} ({smi})")
    if not finite or not sums:
        fail("phase 9: the scale demo's posteriors are not finite or do not sum to 1")
    if not all(launches):
        fail(f"phase 9: the scale demo launched (single, pair) {launches} kernels")
    if not out["exact_multiplicity_acc"] >= SCALE_DEMO_ACC:
        fail(f"phase 9: exact-multiplicity accuracy {out['exact_multiplicity_acc']} < {SCALE_DEMO_ACC}")

    # ---- the first batch through both wrappers, on the demo's inputs at
    # its batch shape (the fresh axis z-sorted and windowed as the driver
    # runs it, the pair's base axis the demo's own draws; these launches
    # come after the counts were read): each half of the batch launched
    # alone gives the same rows bit for bit, so nothing depends on B or on
    # the table workspace.  The demo's noise (sd 0.1) is ~12x below
    # phase 3's, and its evidences pass through 0, so the normalized bound
    # of phases 3 and 5 (which hold both kernels at this B on their
    # workload) is not this workload's measure: here the kernel must be as
    # close to float64 as its plain float32 version is
    from gp_dla_detection_tpu_torch.inference import compute_sample_window

    w, n, model = out["workload"], SCALE_BATCH, out["model"]
    device = model.mu.device
    params = w["params"]
    offsets, nhis = w["samples"].offset_samples, w["samples"].nhi_samples
    order = np.argsort(offsets, kind="stable")
    P6 = params.pixel_pad + 2 * params.instrument.width
    window = compute_sample_window(offsets[order], evidence.SAMPLE_TILE, P6)
    sp = out["spectra"]
    arrays = dict(
        wavelengths=sp.wavelengths, flux=sp.flux, noise_variance=sp.noise_variance, mask=sp.mask,
        z_qso=sp.z_qso, grid=model.rest_wavelengths, mu=model.mu, M=model.M,
        log_omega=model.log_omega, log_c_0=model.log_c_0, log_tau_0=model.log_tau_0,
        log_beta=model.log_beta,
    )
    kin, _ = RL.kernel_inputs(arrays, params, offsets[order], nhis[order], n, device, torch.float32)
    # sorted column j is sample order[j]; its base sample b sits at sorted
    # column argsort(order)[b]
    cols = torch.as_tensor(np.argsort(order)[res.base_sample_inds[:n][:, order]], device=device)
    z2, nhi2 = kin[7].gather(1, cols).contiguous(), kin[8].gather(1, cols).contiguous()
    single_k = lambda a: evidence.sample_log_likelihoods(*a[:9], window=window)
    pair_k = lambda a: evidence.sample_log_likelihoods_pair(*a, window=window)
    halves = (slice(0, n // 2), slice(n // 2, n))
    part = lambda a, rows: [x[rows].contiguous() for x in a]
    whole1, whole2 = single_k(kin), pair_k([*kin, z2, nhi2])
    same_halves = all(
        torch.equal(single_k(part(kin, rows)), whole1[rows])
        and torch.equal(pair_k(part([*kin, z2, nhi2], rows)), whole2[rows])
        for rows in halves
    )
    plain32 = evidence.sample_log_likelihoods_reference(*kin, window=window)
    err_kp = normalized_error(whole1, plain32)
    kin64, _ = RL.kernel_inputs(arrays, params, offsets[order], nhis[order], F64_SUBSET, device,
                             torch.float64)
    ref64 = evidence.sample_log_likelihoods_reference(*kin64, window=None, sample_chunk=500)
    dist64 = {name: normalized_error(out_[:F64_SUBSET], ref64)
              for name, out_ in (("kernel", whole1), ("plain f32", plain32))}
    del kin, kin64, z2, nhi2, cols, whole1, whole2, plain32, ref64
    say(f"phase 9: the demo's first {n} spectra through the wrappers (S={len(offsets)}, "
        f"window={window}, the pair on its own base draws): both halves launched alone give the "
        f"B={n} rows bit for bit {same_halves}; single kernel vs plain f32 normalized "
        f"{err_kp[0]:.3e} (abs {err_kp[1]:.3e}); vs float64 on {F64_SUBSET} spectra, normalized "
        f"(abs): kernel {dist64['kernel'][0]:.3e} ({dist64['kernel'][1]:.3e}), plain f32 "
        f"{dist64['plain f32'][0]:.3e} ({dist64['plain f32'][1]:.3e})")
    if not same_halves:
        fail(f"phase 9: the kernels at B={n} differ from B={n // 2} launches on the same spectra")
    if not dist64["kernel"][1] <= F32_ACCURACY_RATIO * dist64["plain f32"][1]:
        fail("phase 9: the kernel is farther from float64 than its plain float32 version")

    # ---- the decision gate: the same batch through the plain driver path
    # (float32, no launches), the pair stage on the demo's single-stage
    # rows so that both draw the same bases
    spectra = sp.slice(slice(0, n))
    single = first_rows(res.single, n)
    t0 = time.perf_counter()
    plain1 = process_spectra_sharded(
        model, offsets, nhis, spectra, w["prior_z"], np.asarray(w["prior_num"]) >= 1,
        params=params,
        config=ShardedRunConfig(per_device_batch=n, sample_chunk=500, dtype="float32",
                                backend="torch"),
    )
    plain2 = process_spectra_multi(
        model, offsets, nhis, spectra, w["prior_z"], w["prior_num"], params=params,
        batch_size=n, sample_chunk=500, dtype=torch.float32, backend="torch", single=single,
    )
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same_draws = np.array_equal(res.base_sample_inds[:n], plain2.base_sample_inds)
    nan_same = np.array_equal(np.isnan(res.sample_log_likelihoods_dla2[:n]),
                              np.isnan(plain2.sample_log_likelihoods_dla2))
    p_k, p_p = single.p_dlas, plain1.p_dlas
    hard1 = int((((p_k > 0.9) != (p_p > 0.9)) & (np.abs(p_p - 0.9) > DECISION_MARGIN)).sum())
    p99_1 = float(np.quantile(np.abs(p_k - p_p), 0.99))
    post_k, post_p = post[:n], plain2.model_posteriors
    win = np.argmax(post_p, axis=1)
    sure = post_p[np.arange(n), win] > 0.9 + DECISION_MARGIN
    hard3 = int((sure & (np.argmax(post_k, axis=1) != win)).sum())
    p99_3 = float(np.quantile(np.abs(post_k - post_p).max(axis=1), 0.99))
    say(f"phase 9: the same {n} spectra through the plain driver path (torch, float32, "
        f"{plain_s:.1f} s): base draws equal {same_draws}, NaN pairs equal {nan_same}; p_DLA "
        f"flips outside margin {hard1}, |dp| p99 {p99_1:.3e}; 3-class flips where p > 0.91: "
        f"{hard3} ({int(sure.sum())} such spectra), |dp| p99 {p99_3:.3e}")
    if not (nan_same and same_draws):
        fail("phase 9: the plain pair stage drew other bases or masked other pairs")
    if hard1 or hard3 or not max(p99_1, p99_3) < DECISION_P99:
        fail(f"phase 9: the kernels at B={n} fail the decision gate against the plain path")
    say("phase 9 ok")
    return {"launches": launches, "batches": n_batches, "call_ms": call_ms,
            "kernel_share": kernel_s / out["seconds"],
            "spectra_per_s": out["spectra_per_sec_end_to_end"], "seconds": out["seconds"]}


def posterior_cdf_steps(sll) -> dict:
    """``multi_dla._posterior_cdf``'s operations one at a time on a (B, S)
    tensor, in its order: {op: its output}; the last is the CDF."""
    import math

    import torch

    out = {}
    neg_inf = torch.full((), -math.inf, dtype=sll.dtype, device=sll.device)
    out["where(isnan, -inf)"] = finite = torch.where(torch.isnan(sll), neg_inf, sll)
    out["amax"] = rowmax = torch.amax(finite, dim=1, keepdim=True)
    rowmax = torch.where(torch.isfinite(rowmax), rowmax, torch.zeros_like(rowmax))
    out["exp(x - rowmax)"] = w = torch.exp(finite - rowmax)
    out["sum"] = total = w.sum(dim=1, keepdim=True)
    out["where(sum == 0, 1)"] = w = torch.where(total == 0.0, torch.ones_like(w), w)
    out["cumsum"] = cdf = torch.cumsum(w, dim=1)
    out["cdf / cdf[:, -1]"] = cdf / cdf[:, -1:]
    return out


def redraw_divergence(big_calls, small_calls) -> dict:
    """Where the plain base redraw (``device_inverse_cdf_grid_reference``,
    the ``backend="torch"`` path) on a chain run's inputs at one batch
    departs from the same spectra's at a smaller batch:
    each call's captured (B, S) input is replayed on the card through
    ``posterior_cdf_steps`` and ``_grid_counts`` (one call of the big
    batch against the small batch's calls, rows stacked), and each op's
    outputs compared: {op: (entries that differ, rows that differ)},
    ``"input"`` first.  Fails if the replay does not give the redraw's own
    result bit for bit."""
    import torch

    from gp_dla_detection_tpu_torch import multi_dla

    def replay(calls):
        steps = []
        for sll, kvec, grid_size in calls:
            x = sll.cuda()
            ops = posterior_cdf_steps(x)
            cdf = ops["cdf / cdf[:, -1]"]
            grid = S if grid_size is None else grid_size
            ops["_grid_counts"] = multi_dla._grid_counts(cdf, grid)[
                :, torch.as_tensor(kvec, dtype=torch.int64, device=x.device)]
            if not (torch.equal(cdf, multi_dla._posterior_cdf(x)) and torch.equal(
                    ops["_grid_counts"],
                    multi_dla.device_inverse_cdf_grid_reference(x, kvec, grid_size))):
                fail("phase 10: the redraw's replay is not the redraw")
            steps.append({"input": sll, **{op: t.cpu() for op, t in ops.items()}})
        return {op: torch.cat([s[op] for s in steps]) for op in steps[0]}

    S = big_calls[0][0].shape[1]
    big, small = replay(big_calls), replay(small_calls)
    out = {}
    for op, x in big.items():
        y = small[op]
        moved = ~((x == y) | (torch.isnan(x) & torch.isnan(y))) if x.is_floating_point() \
            else x != y
        out[op] = (int(moved.sum()), int(moved.any(dim=1).sum()))
    return out


def redraw_check(calls, label: str, smi: str) -> dict:
    """The redraw kernel on captured chain inputs (``calls``: the (B, S)
    sample log likelihoods on the host, kvec, grid size), each call
    against its plain version on the card: the kernel's CDF within twice
    the plain float32 scan's distance from the float64 CDF and bit for
    bit ``posterior_cdf_in_kernel_order`` (the order of additions it
    keeps), its draws equal to ``grid_counts_reference`` of its own CDF
    and so to the draws of that order, and the draws that differ from
    the plain version's (the knife edge, not a fault) counted.  Returns
    the worst CDF errors and the differing draws."""
    import torch

    from gp_dla_detection_tpu_torch.ops import redraw

    worst = {"kernel": 0.0, "plain": 0.0, "vs_plain": 0.0}
    moved = rows = total = 0
    for sll, kvec, grid in calls:
        x = sll.cuda()
        kv = torch.as_tensor(kvec, dtype=torch.int64, device=x.device)
        grid = x.shape[1] if grid is None else grid
        cdf = redraw.posterior_cdf(x)
        plain_cdf = redraw.posterior_cdf_reference(x)
        exact = redraw.posterior_cdf_reference(x.double())
        err_k = float((cdf.double() - exact).abs().max())
        err_p = float((plain_cdf.double() - exact).abs().max())
        draws = redraw.inverse_cdf_grid(x, kv, grid)
        emulated = redraw.posterior_cdf_in_kernel_order(x)
        if not torch.equal(cdf, emulated):
            fail(f"{label}: the redraw kernel's CDF is not posterior_cdf_in_kernel_order's "
                 f"({int((cdf != emulated).sum())} entries differ)")
        if not torch.equal(draws, redraw.grid_counts_reference(cdf, grid)[:, kv]):
            fail(f"{label}: the redraw kernel's draws are not the grid counts of its own CDF")
        if not err_k <= 2 * err_p:
            fail(f"{label}: the redraw kernel's CDF is {err_k:.3e} from float64, more than "
                 f"twice the plain float32 scan's {err_p:.3e}")
        diff = draws != redraw.inverse_cdf_grid_reference(x, kv, grid)
        moved += int(diff.sum())
        rows += int(diff.any(dim=1).sum())
        total += diff.numel()
        worst = {"kernel": max(worst["kernel"], err_k), "plain": max(worst["plain"], err_p),
                 "vs_plain": max(worst["vs_plain"], float((cdf - plain_cdf).abs().max()))}
    say(f"{label}: redraw kernel on the chain's own inputs ({len(calls)} calls of "
        f"{calls[0][0].shape[0]} x {calls[0][0].shape[1]}, grid {grid}): CDF max |kernel - f64| "
        f"{worst['kernel']:.3e}, plain f32 cumsum's {worst['plain']:.3e} (at most twice), "
        f"|kernel - plain| {worst['vs_plain']:.3e}; CDF bit for bit posterior_cdf_in_kernel_order's; "
        f"draws equal to the grid counts of its own CDF, the draws of that order; "
        f"draws that differ from the plain version's (knife edges) {moved} of {total} in {rows} "
        f"rows ({smi})")
    return {**worst, "draws_moved": moved, "rows_moved": rows, "draws": total}


def redraw_times(x, kv, grid: int, reps: int, samples: list | None = None) -> dict:
    """The redraw kernel's and its plain sequence's ms on (x, kv, grid) on
    the card, the kernel twice and the plain sequence between: ``ms``,
    ``ms_2`` and ``plain_ms`` as ``cuda_ms`` times them, every other
    kernel of the kernels line too (the host's issue of each call
    included where it is the longer); ``queued_ms``, ``queued_ms_2`` and
    ``plain_queued_ms`` queued behind a spin kernel (the card's time
    alone).  ``samples``: as ``cuda_ms``'s, for ``ms``."""
    from gp_dla_detection_tpu_torch.ops import redraw

    kernel = lambda: redraw.inverse_cdf_grid(x, kv, grid)
    plain = lambda: redraw.inverse_cdf_grid_reference(x, kv, grid)
    return {"ms": cuda_ms(kernel, reps, samples), "plain_ms": cuda_ms(plain, reps),
            "ms_2": cuda_ms(kernel, reps), "queued_ms": queued_ms(kernel, reps),
            "plain_queued_ms": queued_ms(plain, reps), "queued_ms_2": queued_ms(kernel, reps)}


def redraw_time_line(t: dict, bound: tuple[float, str]) -> str:
    """The redraw kernel's times (``redraw_times``) beside its bound, with
    the share of the bound reached on each yardstick."""
    return (f"{t['ms']:.4f} / {t['ms_2']:.4f} ms with the host's issue (cuda_ms, as every kernel "
            f"here), the plain sequence {t['plain_ms']:.4f} ms; queued behind a spin kernel "
            f"{t['queued_ms']:.4f} / {t['queued_ms_2']:.4f} ms, the plain sequence "
            f"{t['plain_queued_ms']:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({bound[0] / t['ms']:.2f} of it reached with the host, "
            f"{bound[0] / t['queued_ms']:.2f} queued)")


def redraw_rows_alone(sll, kvec, grid, label: str) -> None:
    """The redraw kernel's rows of a (B >= 128, S) input at B = 1, 128 and
    B, and under a row permutation, bit for bit (draws and CDF)."""
    import torch

    from gp_dla_detection_tpu_torch.ops import redraw

    x = sll.cuda()
    kv = torch.as_tensor(kvec, dtype=torch.int64, device=x.device)
    whole, cdf = redraw.inverse_cdf_grid(x, kv, grid), redraw.posterior_cdf(x)
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(0)).to(x.device)
    same = all(torch.equal(redraw.inverse_cdf_grid(x[r], kv, grid), whole[r])
               and torch.equal(redraw.posterior_cdf(x[r]), cdf[r])
               for r in (slice(0, 1), slice(5, 6), slice(0, 128), slice(x.shape[0] - 128, None),
                         perm))
    if not same:
        fail(f"{label}: the redraw kernel's rows depend on the batch or the row order")


def cddf_sums_check(args, label: str, smi: str) -> dict:
    """The CDDF sums kernel on captured reducer inputs ``args`` (on the
    card): within 1e-12 relative of the plain float64 version, the same
    bits over three runs and for a row's batch of one and 128 rows."""
    import torch

    from gp_dla_detection_tpu_torch import cddf_inputs

    runs = [cddf_inputs.cddf_sums(*args) for _ in range(3)]
    acc, hist = runs[0]
    if not all(torch.equal(a, acc) and torch.equal(h, hist) for a, h in runs[1:]):
        fail(f"{label}: the CDDF sums kernel changed between three runs on the same inputs")
    ref = cddf_inputs.cddf_sums_reference(*args)
    rel = max(float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())
              for got, want in zip((acc, hist), ref))
    abs_err = max(float((got - want).abs().max()) for got, want in zip((acc, hist), ref))
    B = acc.shape[0]
    rows = lambda r: [a[r] if torch.is_tensor(a) and a.dim() == 2 and a.shape[0] == B else a
                      for a in args]
    alone = all(torch.equal(x, y[r]) for r in (slice(3, 4), slice(0, min(B, 128)))
                for x, y in zip(cddf_inputs.cddf_sums(*rows(r)), (acc, hist)))
    say(f"{label}: CDDF sums kernel on the chain's own inputs ({B} x {acc.shape[1]}): vs the plain "
        f"float64 scatter_add_ max rel {rel:.3e} (bound 1e-12), abs {abs_err:.3e}; bit-identical "
        f"over three runs; rows alone at B=1 and 128 bit-identical {alone} ({smi})")
    if not rel <= 1e-12:
        fail(f"{label}: the CDDF sums kernel is {rel:.3e} from its plain version")
    if not alone:
        fail(f"{label}: the CDDF sums kernel's rows depend on the batch")
    return {"max_rel_err": rel, "max_abs_err": abs_err}


@contextlib.contextmanager
def kept_reduction(sharded_multi, keep: list):
    """Keep the lean driver's CDDF reducer and its first batch's arguments
    (on the card) in ``keep`` as (reduce_fn, consts, args), without
    changing them."""
    make = sharded_multi.make_cddf_reducer

    def spy_make(*a, **kw):
        reduce_fn, consts = make(*a, **kw)

        def spy(c, *args):
            if not keep:
                keep.append((reduce_fn, c, [x.clone() for x in args]))
            return reduce_fn(c, *args)

        return spy, consts

    sharded_multi.make_cddf_reducer = spy_make
    try:
        yield keep
    finally:
        sharded_multi.make_cddf_reducer = make


def reducer_split(keep, sums_ms: float, n: int) -> dict:
    """The CDDF reducer's device time on the first ``n`` rows of one chain
    batch (``keep``, from ``kept_reduction``), split by op with CUDA
    events: the whole reduction; its sums kernel (``sums_ms``, timed on
    the same rows); each of ``_top_k``'s two stable float64 sorts; the
    rest, the whole less those three (the mean/exp/log and other
    elementwise passes, the row reductions, the gather and the
    concatenation); and the copies of its two outputs to pinned host
    memory, as the driver's fetch makes them."""
    import torch

    from gp_dla_detection_tpu_torch import cddf_inputs

    reduce_fn, consts, args = keep[0]
    B = args[0].shape[0]
    rows = [a[:n] if a.dim() and a.shape[0] == B else a for a in args]
    total = cuda_ms(lambda: reduce_fn(consts, *rows), 10)
    sorted_inputs = []
    real_top_k = cddf_inputs._top_k
    cddf_inputs._top_k = lambda x, k: (sorted_inputs.append((x, k)), real_top_k(x, k))[1]
    try:
        hist, ex = reduce_fn(consts, *rows)
    finally:
        cddf_inputs._top_k = real_top_k
    sorts = [cuda_ms(lambda x=x, k=k: real_top_k(x, k), 10) for x, k in sorted_inputs]
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (hist, ex)]

    def copies():
        for host, t in zip(pinned, (hist, ex)):
            host.copy_(t, non_blocking=True)

    copy_ms = cuda_ms(copies, 10)
    return {"total_ms": total, "sums_ms": sums_ms, "sort_ms": sorts,
            "rest_ms": total - sums_ms - sum(sorts), "copy_to_host_ms": copy_ms}


def longest_runs(args) -> tuple[float, int]:
    """The longest run of equal bases along ``base_order`` in each row of
    the CDDF sums' inputs ``args``: (the mean over the rows, the most).
    A run's sum is one chain of dependent adds in the kernel."""
    import numpy as np

    keys = args[2][:, args[4]].cpu().numpy()
    longest = [int(np.diff(np.flatnonzero(np.r_[True, r[1:] != r[:-1], True])).max())
               for r in keys]
    return float(np.mean(longest)), max(longest)


def host_ms(fn, reps: int = 10) -> float:
    """Milliseconds the host takes to issue ``fn()`` (its Python wrapper
    and launch, no synchronize inside the timing), mean of ``reps`` after
    a warm-up: where it reaches the CUDA-event time, the timing is the
    host's, not the card's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def scatter_add_ms(args, acc) -> float:
    """The CDDF histogram as one float64 ``scatter_add_`` (the card's
    atomics) of the eight channels' prebuilt values at their prebuilt
    flat bins (``cddf_sums_reference``'s second scatter, ``acc`` the
    kernel's): the library yardstick, which the port never calls."""
    import torch

    from gp_dla_detection_tpu_torch import cddf_inputs

    p, _, _, zloc, _, lh_a, lh_b, nu, nu2, p_min, p_switch, W, nl = args
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    ps = torch.where((p > p_min) & (p < p_switch), p, zero)
    pvar = p * torch.clamp(1.0 - p, min=0.0)
    vals = torch.stack([ps, p, p * nu, pvar, pvar * nu2, ps, acc, acc], dim=1)
    ch = torch.arange(cddf_inputs.N_CHANNELS, device=p.device)
    lh = torch.where(((ch == 5) | (ch == 7))[:, None], lh_b[None, :], lh_a[None, :])
    flat = torch.where(((zloc >= 0) & (zloc < W))[:, None, :],
                       zloc[:, None, :] * (nl + 1) + lh[None, :, :],
                       torch.full_like(zloc[:, None, :], W * (nl + 1)))
    hist = torch.zeros((p.shape[0], cddf_inputs.N_CHANNELS, W * (nl + 1) + 1),
                       dtype=torch.float64, device=p.device)
    return cuda_ms(lambda: hist.scatter_add_(2, flat, vals), 10)


def capture_cddf_sums(log: list):
    """A stand-in for ``cddf_inputs.cddf_sums`` that keeps (on the card)
    the arguments of its first call in ``log`` and calls the real one."""
    from gp_dla_detection_tpu_torch import cddf_inputs

    real = cddf_inputs.cddf_sums

    def spy(*args):
        if not log:
            log.append([a.clone() if hasattr(a, "clone") else a for a in args])
        return real(*args)

    return real, spy


def bench_runs(argv_sets):
    """``python -m gp_dla_detection_tpu_torch.bench`` with each argument
    list in ``argv_sets``, one at a time, as a user runs it (no device,
    dtype or backend flags; ``GPDLA_DRIVER_TIMING=1``): {" ".join(argv):
    (JSON records, wall s, the drivers' mean stage seconds per batch)}.
    The kernel library built in phase 2 is reused from ``_build``."""
    import torch

    out = {}
    for argv in argv_sets:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "gp_dla_detection_tpu_torch.bench", *argv],
                cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                timeout=BENCH_TIMEOUT, env=dict(os.environ, GPDLA_DRIVER_TIMING="1"),
            )
        except subprocess.TimeoutExpired:
            fail(f"phase 10: the bench {argv} did not finish in {BENCH_TIMEOUT} s")
        wall = time.perf_counter() - t0
        if proc.returncode:
            fail(f"phase 10: the bench {argv} exited {proc.returncode}: {proc.stderr[-4000:]}")
        records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        out[" ".join(argv)] = (records, wall, stage_means(proc.stdout))
    return out


def bench_phase(smi: str, seed: int) -> dict:
    """Phase 10: the port's bench (``gp_dla_detection_tpu_torch.bench``).
    Its default invocation and ``--driver`` in subprocesses, as a user runs
    them: every JSON line printed, finite, from the kernels (the launch
    counters of each mode: one single launch per kernel-mode call, one
    single and one pair launch per chain batch).  In this process: the
    kernel mode at BENCH_SWEEP's batches (spectra/s and peak memory), the
    kernel mode's device function at B = 1024 under the sync-debug mode
    "warn" (no host sync), both kernels at B = 1024 on the bench's
    workload (CUDA events, beside ``evidence_bound``), each output row for
    row bit-identical to the same rows launched at B = 128, and those
    first 128 rows within 5e-5 normalized of the plain versions on the
    same inputs (which carries the plain comparison to B = 1024), and the
    fused lean chain on the bench's first 1,024 spectra at batch 1024
    against batch 128: bit-identical, or within 5e-5 normalized and the
    decision gate with the reason printed (which kernel inputs differ
    between the batches, in how many entries, and the first operation of
    the base redraw whose output differs when it is replayed on the
    inputs the chain gave it at each batch); one single and one pair
    launch per batch."""
    import warnings

    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch import bench
    from gp_dla_detection_tpu_torch.inference import kernel_sample_window
    from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern
    from gp_dla_detection_tpu_torch.ops import evidence
    from gp_dla_detection_tpu_torch.parallel import sharded_multi

    B, S, P, k = BENCH_BATCH, 10000, 1274, 20

    def finite(rec):
        value = rec.get("value")
        return (isinstance(value, (int, float)) and bool(np.isfinite(value)) and value > 0
                and rec.get("backend") == "cuda")

    # ---- the bench as a user runs it
    runs = bench_runs([[], ["--driver"]])
    (kernel_line, chain_line), default_s, chain_stages = runs[""]
    (driver_line,), driver_s, driver_stages = runs["--driver"]
    for name, rec in (("defaults, kernel mode", kernel_line), ("defaults, chain", chain_line),
                      ("--driver", driver_line)):
        say(f"phase 10: bench ({name}): {json.dumps(rec)}")
        if not finite(rec):
            fail(f"phase 10: the bench's {name} line is not a finite rate from the kernels")
    chain_batches = 2 + 16384 // B
    expect = ((kernel_line, {"single": 6}),
              (chain_line, {"single": chain_batches, "pair": chain_batches,
                            "redraw": chain_batches}),
              (driver_line, {"single": 2 + 8192 // B, "pair": 0, "redraw": 0}))
    if any(rec["launches"] != want for rec, want in expect):
        fail(f"phase 10: the bench's launches {[r['launches'] for r, _ in expect]}, expected "
             f"{[w for _, w in expect]}")
    stages = lambda m: ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in m.items() if k != "batches")
    say(f"phase 10: the bench's drivers, mean per batch of {B} (GPDLA_DRIVER_TIMING=1, "
        f"warm-up and one-batch runs included): chain ({chain_stages['batches']} batches) "
        f"{stages(chain_stages)}; --driver ({driver_stages['batches']}) {stages(driver_stages)}")
    say(f"phase 10: the bench's processes: defaults {default_s:.1f} s, --driver {driver_s:.1f} s "
        f"(process start, workload, CUDA set-up included); peak memory kernel mode "
        f"{kernel_line['peak_memory_gb']:.2f} GB, chain {chain_line['peak_memory_gb']:.2f} GB, "
        f"full single driver {driver_line['peak_memory_gb']:.2f} GB ({smi})")

    # ---- the kernel mode's batch sweep, in this process
    sweep = {}
    for b in BENCH_SWEEP:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 1e9
        with contextlib.redirect_stdout(io.StringIO()):
            rec = bench.main(batch_size=b)
        sweep[b] = rec
        say(f"phase 10: kernel mode at B={b}: {rec['value']:.1f} spectra/s, peak "
            f"{rec['peak_memory_gb']:.2f} GB ({base:.2f} GB held before it) ({smi})")
        if not finite(rec):
            fail(f"phase 10: the kernel mode at B={b} is not a finite rate from the kernel")

    # ---- the kernel mode's device function at B = 1024: host syncs
    prob = bench._synthetic_problem(B, S, P, k)
    params = prob["params"]
    args = bench.kernel_args(prob, "cuda")
    window = kernel_sample_window(prob["offsets"], P, params)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            reduced = bench.kernel_step(args, params, sample_chunk=2500, backend="cuda",
                                        sample_window=window)["reduced"]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    say(f"phase 10: the kernel mode's device function at B={B} under the sync-debug mode: "
        f"{len(syncs)} host syncs {syncs[:3]}")
    if syncs or not torch.isfinite(reduced).all():
        fail("phase 10: the kernel mode's device function syncs with the host or is not finite")
    del args, reduced

    # ---- both kernels at B = 1024 on the bench's workload, against B = 128
    order = np.argsort(prob["offsets"], kind="stable")
    offsets, nhis = prob["offsets"][order], prob["nhis"][order]
    kin, _ = RL.kernel_inputs(prob, params, offsets, nhis, B, torch.device("cuda"), torch.float32)
    P6 = P + 2 * params.instrument.width
    draw_idx, n_draws = replicate_draw_pattern(S, 256, 4)
    gen = np.random.default_rng(seed + 6)
    cols = torch.as_tensor(np.stack([gen.permutation(S)[:n_draws][draw_idx] for _ in range(B)]),
                           device="cuda")
    z2, n2 = kin[7].gather(1, cols).contiguous(), kin[8].gather(1, cols).contiguous()
    calls = {
        "single": lambda rows: evidence.sample_log_likelihoods(
            *[t[rows] for t in kin], window=window),
        "pair": lambda rows: evidence.sample_log_likelihoods_pair(
            *[t[rows] for t in kin], z2[rows], n2[rows], window=window, base_replicates=4),
    }
    plain = {
        "single": lambda rows: evidence.sample_log_likelihoods_reference(
            *[t[rows] for t in kin], window=window),
        "pair": lambda rows: evidence.sample_log_likelihoods_pair_reference(
            *[t[rows] for t in kin], z2[rows], n2[rows], window=window),
    }
    kernels, placed = {}, []   # placed: the B = 1024 times and work, for phase 12
    for name, call in calls.items():
        samples = []
        ms = cuda_ms(lambda: call(slice(None)), 3, samples)
        full = call(slice(None))
        same = all(torch.equal(full[i:i + BATCH], call(slice(i, i + BATCH)))
                   for i in range(0, B, BATCH))
        # the plain version on the bench's own inputs and window: the first
        # BATCH rows, carried to all B rows by the bit-identity above
        err = normalized_error(full[:BATCH], plain[name](slice(0, BATCH)))
        bound = RL.evidence_bound(B, S, P, P6, k, 3, window, name == "pair", n_draws)
        kernels[name] = {"ms": ms, "bound_ms": bound[0], "bound_pipe": bound[1],
                         "rows_equal_b128": same, "max_normalized_err": err[0],
                         "max_abs_err": err[1]}
        placed.append({"name": "evidence_pair_f32_r4" if name == "pair" else "evidence_single_f32",
                       "ms": ms, "gpu": samples[0], "published": bound,
                       "work": RL.evidence_work(B, S, P, P6, k, 3, window, name == "pair", n_draws)})
        say(f"phase 10: {name} kernel at B={B} S={S} P={P} k={k} windowed"
            + (" (R=4 layout)" if name == "pair" else "")
            + f": {ms:.2f} ms; bound {bound[0]:.2f} ms by the {bound[1]} "
            f"({bound[0] / ms:.2f} of it reached); rows bit-identical to B={BATCH} launches "
            f"{same}; its first {BATCH} rows vs plain f32 on the bench's inputs normalized "
            f"{err[0]:.3e}, abs {err[1]:.3e} ({smi})")
        if not same:
            fail(f"phase 10: the {name} kernel's B={B} rows differ from B={BATCH} launches")
        if not err[0] < NORMALIZED_BOUND:
            fail(f"phase 10: the {name} kernel disagrees with its plain version on the bench's "
                 f"inputs: {err[0]:.3e} >= {NORMALIZED_BOUND}")
        del full
    # the pair at R = 1 (every base draw its own) on the same inputs: its
    # time at B = 1024 for phase 12 only
    cols1 = torch.as_tensor(gen.integers(0, S, (B, S)), device="cuda")
    z2, n2 = kin[7].gather(1, cols1).contiguous(), kin[8].gather(1, cols1).contiguous()
    samples = []
    ms_r1 = cuda_ms(lambda: evidence.sample_log_likelihoods_pair(
        *kin, z2, n2, window=window, base_replicates=1), 3, samples)
    bound_r1 = RL.evidence_bound(B, S, P, P6, k, 3, window, True, S)
    kernels["pair"]["ms_r1"] = ms_r1
    say(f"phase 10: pair kernel at B={B} S={S} P={P} k={k} windowed, R=1: {ms_r1:.2f} ms; "
        f"bound {bound_r1[0]:.2f} ms by the {bound_r1[1]} ({bound_r1[0] / ms_r1:.2f} of it "
        f"reached) ({smi})")
    placed.append({"name": "evidence_pair_f32_r1", "ms": ms_r1, "gpu": samples[0],
                   "published": bound_r1,
                   "work": RL.evidence_work(B, S, P, P6, k, 3, window, True, S)})
    del kin, z2, n2, cols, cols1

    # ---- the fused lean chain at batches 1024, 256 and 128, CDDF inputs on
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import ShardedRunConfig
    from gp_dla_detection_tpu_torch.ops import redraw

    work = bench.driver_workload(B, S, P, k)
    real = {"single": evidence.sample_log_likelihoods, "pair": evidence.sample_log_likelihoods_pair}
    real_redraw = sharded_multi.device_inverse_cdf_grid

    def chain(batch, sums_log=None, reducer=None):
        """The chain's results and launches at ``batch`` (the bench's
        workload through ``process_spectra_multi_sharded`` as ``bench
        --driver --lean --two-stage`` runs it, with the CDDF inputs), each
        evidence kernel's tensor inputs over all its launches (rows
        stacked), and the base redraw's calls (its (B, S) input on the
        host, its grid); ``sums_log``: keep the first CDDF sums call's
        arguments there; ``reducer``: keep the reducer and its first
        batch's arguments there (``kept_reduction``)."""
        seen = {name: [] for name in real}
        redraws = []

        def spy(name):
            def call(*a, **kw):
                seen[name].append([t.cpu() for t in a if torch.is_tensor(t)])
                return real[name](*a, **kw)
            return call

        def redraw_spy(sll, kvec, grid_size=None):
            redraws.append((sll.cpu(), kvec.cpu(), grid_size))
            return real_redraw(sll, kvec, grid_size)

        real_sums, sums_spy = capture_cddf_sums([] if sums_log is None else sums_log)
        evidence.sample_log_likelihoods, evidence.sample_log_likelihoods_pair = (
            spy("single"), spy("pair"))
        sharded_multi.device_inverse_cdf_grid = redraw_spy
        cddf_inputs.cddf_sums = sums_spy
        reset_counts()
        try:
            with kept_reduction(sharded_multi, [] if reducer is None else reducer):
                res = sharded_multi.process_spectra_multi_sharded(
                    work.model, work.offsets, work.nhis, work.spectra.slice(slice(0, B)),
                    work.prior_z, work.prior_num,
                    config=ShardedRunConfig(per_device_batch=batch, dtype="float32",
                                            store_sample_likelihoods=False,
                                            store_cddf_inputs=True),
                )
            launches = launch_counts()
        finally:
            evidence.sample_log_likelihoods, evidence.sample_log_likelihoods_pair = (
                real["single"], real["pair"])
            sharded_multi.device_inverse_cdf_grid = real_redraw
            cddf_inputs.cddf_sums = real_sums
        inputs = {name: [torch.cat(parts) for parts in zip(*calls)]
                  for name, calls in seen.items()}
        return result_arrays(res), launches, inputs, redraws

    sums_args, reducer = [], []
    runs = {batch: chain(batch, *((sums_args, reducer) if batch == B else ()))
            for batch in BENCH_CHAIN_BATCHES}
    big, big_launches, big_in, big_redraws = runs[B]
    for batch, (_, launches, _, _) in runs.items():
        if launches != (B // batch,) * 5:
            fail(f"phase 10: chain {COUNTED} launches {launches} at batch {batch}, expected "
                 f"{B // batch} each")
    names = ("ext_wavelengths", "flux", "mu", "M", "omega2", "noise_variance", "mask",
             "z_dlas", "nhi", "z_dlas2", "nhi2")
    pick = lambda a: np.argmax(a["multi_model_posteriors"], axis=1)
    verdicts = {}
    for batch in BENCH_CHAIN_BATCHES[1:]:
        small, _, small_in, _ = runs[batch]
        diff = sorted(n for n in small if not np.array_equal(
            big[n], small[n], equal_nan=small[n].dtype.kind == "f"))
        # the kernels' inputs that differ between the batches: the reason
        # when an array does
        moved_inputs = {
            name: {n: (int((x != y).sum()), x.numel())
                   for n, x, y in zip(names, big_in[name], small_in[name]) if not torch.equal(x, y)}
            for name in real
        }
        verdicts[batch] = ("bit-identical in every array (CDDF inputs included)" if not diff
                           else f"differs in {', '.join(diff)}; kernel inputs that differ "
                                f"{moved_inputs}")
        say(f"phase 10: fused lean chain (cuda, R=4, CDDF inputs) on the bench's first {B} spectra, "
            f"batch {B} vs batch {batch}: {verdicts[batch]}; 3-class picks equal "
            f"{np.array_equal(pick(big), pick(small))} (picks {np.bincount(pick(big), minlength=3).tolist()}); "
            f"launches {COUNTED} {big_launches} and {runs[batch][1]} ({smi})")
        if diff:
            fail(f"phase 10: the chain at batch {B} is not bit-identical to batch {batch}")
    # ---- the chain at S = ODD_S (ROADMAP C.1): a (B, S) float32 or float64
    # row starts on a 16-byte boundary only every fourth row, and the CDDF
    # sums' last chunk is not full; bit-identical at two batches
    odd = bench.driver_workload(ODD_S_SPECTRA, ODD_S, P, k)
    odd_runs = {}
    t_odd = time.perf_counter()
    for batch in (ODD_S_SPECTRA, BATCH):
        reset_counts()
        res = sharded_multi.process_spectra_multi_sharded(
            odd.model, odd.offsets, odd.nhis, odd.spectra, odd.prior_z, odd.prior_num,
            config=ShardedRunConfig(per_device_batch=batch, dtype="float32",
                                    store_sample_likelihoods=False, store_cddf_inputs=True),
        )
        odd_runs[batch] = (result_arrays(res), launch_counts())
    t_odd = time.perf_counter() - t_odd
    (odd_big, odd_big_l), (odd_small, odd_small_l) = odd_runs[ODD_S_SPECTRA], odd_runs[BATCH]
    odd_diff = sorted(n for n in odd_big if not np.array_equal(
        odd_big[n], odd_small[n], equal_nan=odd_big[n].dtype.kind == "f"))
    say(f"phase 10: fused lean chain (cuda, R=4, CDDF inputs) at S={ODD_S} on {ODD_S_SPECTRA} "
        f"spectra, batch {ODD_S_SPECTRA} vs batch {BATCH}: "
        + ("bit-identical in every array (CDDF inputs included)" if not odd_diff
           else f"differs in {', '.join(odd_diff)}")
        + f"; launches {COUNTED} {odd_big_l} and {odd_small_l}; {t_odd:.1f} s for both ({smi})")
    if odd_diff:
        fail(f"phase 10: the chain at S={ODD_S} differs between batch {ODD_S_SPECTRA} and {BATCH}")
    if odd_big_l != (1,) * 5 or odd_small_l != (ODD_S_SPECTRA // BATCH,) * 5:
        fail(f"phase 10: the chain at S={ODD_S} launched {odd_big_l} and {odd_small_l}")
    del odd, odd_runs, odd_big, odd_small

    # ---- the single driver under "cuda" (ROADMAP C.1): the bench's first
    # B spectra at batches B and BATCH, bit-identical in every array
    from gp_dla_detection_tpu_torch.inference import process_spectra

    singles = {}
    for batch in (B, BATCH):
        reset_counts()
        res = process_spectra(work.model, work.offsets, work.nhis, work.spectra.slice(slice(0, B)),
                              work.prior_z, work.prior_flags, batch_size=batch)
        singles[batch] = (result_arrays(res), launch_counts())
    (one_big, one_big_l), (one_small, one_small_l) = singles[B], singles[BATCH]
    one_moved = {n: int((~((x == one_small[n]) | (np.isnan(x) & np.isnan(one_small[n]))
                          if x.dtype.kind == "f" else x == one_small[n])).sum())
                 for n, x in one_big.items()}
    say(f"phase 10: process_spectra (cuda, float32, the kernels) on the bench's first {B} "
        f"spectra, batch {B} vs batch {BATCH}: values that differ {sum(one_moved.values())} "
        f"({', '.join(f'{n} {v}' for n, v in one_moved.items() if v) or 'none'}); launches "
        f"{COUNTED} {one_big_l} and {one_small_l} ({smi})")
    if any(one_moved.values()):
        fail(f"phase 10: process_spectra at batch {B} is not bit-identical to batch {BATCH}")
    if one_big_l[0] != 1 or one_small_l[0] != B // BATCH:
        fail(f"phase 10: process_spectra launched {one_big_l} and {one_small_l}")
    del singles, one_big, one_small

    # the plain redraw (backend="torch") replayed op by op on the inputs the
    # chain gave the kernel: where its own result depends on the batch
    redraw_steps = redraw_divergence(big_redraws, runs[BATCH][3])
    say(f"phase 10: the plain redraw (the backend=\"torch\" path) replayed op by op on the chain's "
        f"inputs, batch {B} vs {BATCH} rows per call, (entries, rows) that differ: {redraw_steps}")

    # ---- the redraw kernel on the bench's inputs (R = 4): its checks, its
    # rows at B = 1, 128 and 1024, its time beside the plain sequence's
    x, kv, grid = big_redraws[0]
    redraw_bench = redraw_check(big_redraws, "phase 10", smi)
    redraw_rows_alone(x, kv, grid, "phase 10")
    x, kv = x.cuda(), kv.cuda()
    samples = []
    redraw_b = redraw_times(x, kv, grid, 10, samples)
    redraw_b_bound = RL.redraw_bound(*x.shape, kv.numel())
    placed.append({"name": "redraw_f32", "ms": redraw_b["ms"], "gpu": samples[0],
                   "published": redraw_b_bound, "work": RL.redraw_work(*x.shape, kv.numel())})
    say(f"phase 10: redraw kernel at B={x.shape[0]} S={x.shape[1]} grid {grid}: "
        f"{redraw_time_line(redraw_b, redraw_b_bound)}; rows bit-identical at B=1, 128 "
        f"and {x.shape[0]} and permuted ({smi})")
    del x, kv

    # ---- the CDDF sums kernel on the chain's own inputs at B = 1024 and on
    # its first 128 rows: its checks and its time beside the plain sums'
    args = sums_args[0]
    sums_bench = cddf_sums_check(args, "phase 10", smi)
    runs_mean, runs_most = longest_runs(args)
    rows = lambda n: [a[:n] if torch.is_tensor(a) and a.dim() == 2 else a for a in args]
    n_bins = args[-2] * (args[-1] + 1) + 1
    sums_times, sums_bounds, sums_library, splits = {}, {}, {}, {}
    for n in (BATCH, B):
        part = rows(n)
        samples = []
        sums_times[n] = (cuda_ms(lambda: cddf_inputs.cddf_sums(*part), 10, samples),
                         cuda_ms(lambda: cddf_inputs.cddf_sums_reference(*part), 5),
                         cuda_ms(lambda: cddf_inputs.cddf_sums(*part), 10))
        sums_bounds[n] = RL.cddf_bound(n, S, n_bins)
        if n == B:
            placed.append({"name": "cddf_sums_f64", "ms": sums_times[n][0], "gpu": samples[0],
                           "published": sums_bounds[n], "work": RL.cddf_work(n, S, n_bins)})
        sums_library[n] = scatter_add_ms(part, cddf_inputs.cddf_sums(*part)[0])
        sums_host = host_ms(lambda: cddf_inputs.cddf_sums(*part))
        say(f"phase 10: CDDF sums kernel at B={n} S={S} ({cddf_inputs.N_CHANNELS} x {n_bins} bins, "
            f"{cddf_inputs.cddf_chunk_plan(S).n_chunks} chunks a row; the longest run of equal "
            f"bases a row {runs_mean:.1f} columns on average, {runs_most} at most): "
            f"{sums_times[n][0]:.4f} / {sums_times[n][2]:.4f} ms (the host issues a call in "
            f"{sums_host:.4f} ms), the plain scatter_add_ sums {sums_times[n][1]:.4f} ms, "
            f"the histogram as one scatter_add_ of prebuilt values (atomics) {sums_library[n]:.4f} "
            f"ms; bound {sums_bounds[n][0]:.4f} ms by {sums_bounds[n][1]} "
            f"({sums_bounds[n][0] / sums_times[n][0]:.2f} of it reached) ({smi})")
        splits[n] = reducer_split(reducer, sums_times[n][0], n)
        sp = splits[n]
        say(f"phase 10: the CDDF reducer on the chain's batch at B={n}, device ms by op (CUDA "
            f"events): whole {sp['total_ms']:.4f}; sums kernel {sp['sums_ms']:.4f}; the two stable "
            f"float64 sorts of _top_k {' and '.join(f'{x:.4f}' for x in sp['sort_ms'])}; the rest "
            f"(mean/exp/log and the other passes) {sp['rest_ms']:.4f}; its outputs to pinned host "
            f"memory {sp['copy_to_host_ms']:.4f} ({smi})")
    del args, sums_args, reducer, runs, big_in, big_redraws

    # ---- the null evidence kernel on the bench's spectra: against its
    # plain version and float64, each row alone, shifted and permuted, its
    # time at B = 128 and 1024 beside the plain sequence's
    from gp_dla_detection_tpu_torch.inference import _prepare_spectrum
    from gp_dla_detection_tpu_torch.ops import low_rank_mvn

    dev = torch.device("cuda")
    t32 = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(torch.float32)
    prep = _prepare_spectrum(
        t32(prob["wavelengths"]), t32(prob["flux"]), t32(prob["noise_variance"]),
        torch.as_tensor(prob["mask"], device=dev), t32(prob["z_qso"]), t32(prob["grid"]),
        t32(prob["mu"]), t32(prob["M"]), t32(prob["log_omega"]), prob["log_c_0"],
        prob["log_tau_0"], prob["log_beta"], params, null_evidence=False,
    )
    null_args = [t32(prob["flux"]), prep["mu"], prep["M"],
                 prep["omega2"] + t32(prob["noise_variance"]), prep["valid"]]
    del prep
    null_out = low_rank_mvn.null_log_likelihoods(*null_args)
    null_plain = low_rank_mvn.null_log_likelihoods_reference(*null_args)
    null_f64 = low_rank_mvn.null_log_likelihoods_reference(
        *[a.double() if a.is_floating_point() else a for a in null_args])
    null_err = normalized_error(null_out, null_plain)
    null_err64 = normalized_error(null_out, null_f64)
    plain_err64 = normalized_error(null_plain, null_f64)
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(1)).to(dev)
    moves = lambda fn, ref: sum(int((fn(*[a[r] for a in null_args]) != ref[r]).sum())
                                for r in (slice(0, 1), slice(1, 2), slice(0, BATCH),
                                          slice(1, 257), slice(256, 512), perm))
    null_moved = moves(low_rank_mvn.null_log_likelihoods, null_out)
    plain_moved = moves(low_rank_mvn.null_log_likelihoods_reference, null_plain)
    null_times, null_bounds, null_host = {}, {}, {}
    for n in (BATCH, B):
        part = [a[:n] for a in null_args]
        samples = []
        null_times[n] = (cuda_ms(lambda: low_rank_mvn.null_log_likelihoods(*part), 10, samples),
                         cuda_ms(lambda: low_rank_mvn.null_log_likelihoods_reference(*part), 5),
                         cuda_ms(lambda: low_rank_mvn.null_log_likelihoods(*part), 10))
        null_bounds[n] = RL.null_bound(n, P, k)
        if n == B:
            placed.append({"name": "null_evidence_f32", "ms": null_times[n][0], "gpu": samples[0],
                           "published": null_bounds[n], "work": RL.null_work(n, P, k)})
        null_host[n] = host_ms(lambda: low_rank_mvn.null_log_likelihoods(*part))
    say(f"phase 10: null evidence kernel on the bench's {B} spectra (P={P}, k={k}): vs plain f32 "
        f"normalized {null_err[0]:.3e}, abs {null_err[1]:.3e}; vs f64 normalized {null_err64[0]:.3e} "
        f"(plain f32 {plain_err64[0]:.3e}); rows at B=1, 128, 256 shifted by one and permuted that "
        f"differ from the B={B} launch: kernel {null_moved}, plain version {plain_moved}; "
        + "; ".join(f"B={n}: {null_times[n][0]:.4f} / {null_times[n][2]:.4f} ms (the host issues "
                    f"a call in {null_host[n]:.4f} ms), the plain sequence {null_times[n][1]:.4f} "
                    f"ms, bound {null_bounds[n][0]:.4f} ms by {null_bounds[n][1]}"
                    for n in (BATCH, B))
        + f" ({smi})")
    if not null_err[0] < NORMALIZED_BOUND or not null_err64[0] < F64_BOUND:
        fail(f"phase 10: the null evidence kernel disagrees with its plain version "
             f"({null_err[0]:.3e}) or float64 ({null_err64[0]:.3e})")
    if null_moved:
        fail(f"phase 10: the null evidence kernel's rows depend on the batch ({null_moved})")
    del null_args, null_out, null_plain, null_f64
    say("phase 10 ok")
    return {"kernel_line": kernel_line, "chain_line": chain_line, "driver_line": driver_line,
            "sweep": sweep, "kernels": kernels, "chain_launches": big_launches, "placed": placed,
            "redraw": {**redraw_bench, **redraw_b, "bound_ms": redraw_b_bound[0],
                       "bound_by": redraw_b_bound[1]},
            "sums": {**sums_bench, "times": sums_times, "bounds": sums_bounds,
                     "library": sums_library, "split": splits,
                     "longest_run_mean": runs_mean, "longest_run_max": runs_most},
            "null": {"max_abs_err": null_err[1], "max_normalized_err": null_err[0],
                     "normalized_err_vs_f64": null_err64[0],
                     "plain_normalized_err_vs_f64": plain_err64[0],
                     "plain_rows_moved": plain_moved, "times": null_times,
                     "bounds": null_bounds}}


def start_script(argv: list[str]) -> subprocess.Popen:
    """``python <argv>`` from the repo root as a user runs it, in a
    session of its own (on a timeout its workers go down with it)."""
    return subprocess.Popen(
        [sys.executable, *argv], cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
    )


def finish_script(proc: subprocess.Popen, label: str, phase: str = "11",
                  timeout: float = SURVEY_TIMEOUT,
                  prefixes: tuple = ("- ", "built ", "artifacts ")) -> str:
    """A ``start_script`` process's stdout once it exits 0, its report
    lines (those that start with one of ``prefixes``) printed; else the
    phase fails with the tail."""
    import signal

    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"phase {phase}: {label} did not finish in {timeout} s")
    for line in stdout.splitlines():
        if line.startswith(prefixes):
            say(f"phase {phase} {label}: {line}")
    if proc.returncode:
        fail(f"phase {phase}: {label} exited {proc.returncode} after "
             f"{time.perf_counter() - t0:.1f} s:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


def script_run(argv: list[str], label: str, phase: str = "11", timeout: float = SURVEY_TIMEOUT,
               prefixes: tuple = ("- ", "built ", "artifacts ")) -> str:
    """``start_script`` then ``finish_script``."""
    return finish_script(start_script(argv), label, phase, timeout, prefixes)


def survey_phase(smi: str, seed: int) -> dict:
    """Phase 11: the survey harnesses on the card, in one temporary
    workdir removed afterwards (on failure too).  (a)
    ``scripts/torch_scale_rehearsal.py`` at its defaults (SURVEY_SPECTRA
    sightlines x 10,000 samples, batch 1024, the classic flow): two real
    SIGKILLs, resumes, every array bit-identical to the uninterrupted
    run, each finished worker's launches equal to its batches; (b) the
    classic flow under ``backend="cuda"`` on the universe's first
    SURVEY_SUBSET sightlines at batches 1024 and 128, bit-identical in
    every array; (c) ``scripts/torch_survey_release.py`` on the same
    universe (killed at a third and resumed at batch 1024, the ASCII and
    analysis stages) against an uninterrupted lean worker at batch
    RELEASE_B_BATCH: every array bit-identical, ``cddf_*`` included,
    exact multiplicity >= SURVEY_ACC, the ASCII files and a finite
    ``analysis/statistics.json`` written."""
    import runpy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig

    repo = Path(__file__).resolve().parent
    harness = runpy.run_path(str(repo / "scripts" / "torch_scale_rehearsal.py"))
    t_phase = time.perf_counter()
    wd = Path(tempfile.mkdtemp(prefix="gpdla_survey_"))
    try:
        # ---- (a) the kill-and-resume rehearsal
        out = script_run(["scripts/torch_scale_rehearsal.py", "--workdir", str(wd),
                          "--n-spectra", str(SURVEY_SPECTRA), "--seed", str(seed)], "(a)")
        reh = harness["marked_json"](out, "REHEARSAL")
        if not reh["identical"] or not all(reh["killed"]):
            fail(f"phase 11 (a): identical {reh['identical']} ({reh['mismatches']}), "
                 f"killed {reh['killed']}")
        for leg, exp in reh["expected_launches"].items():
            got = reh["launches"][leg]
            if (got["single"], got["pair"], got["null"]) != (exp["single"], exp["pair"],
                                                             exp["single"]):
                fail(f"phase 11 (a): {leg} launched {got} for {exp} batches")
        say(f"phase 11 (a): {SURVEY_SPECTRA} sightlines, batch {reh['batch']}: killed at "
            f"{reh['kill_points']} of {reh['n_batches']} batches (single, pair stage), legs "
            + ", ".join(f"{k} {v:.1f} s" for k, v in reh["leg_s"].items())
            + f"; run B single {reh['spectra_per_s']['inference']:.1f}, pair "
            f"{reh['spectra_per_s']['multi']:.1f}, two-stage "
            f"{reh['spectra_per_s']['two_stage']:.1f} spectra/s; build {reh['build_s']:.1f} s "
            f"(synthesis {reh['build']['synthesize_s']:.1f}, saves {reh['build']['save_s']:.1f}, "
            f"the ragged spectra {reh['build']['spectra_save_s']:.1f}); checkpoints "
            f"{reh['checkpoint_mb']:.0f} MB, result files {reh['result_files_mb']:.0f} MB; "
            f"bit-identical; launches {reh['launches']} ({smi})")

        # ---- (b) the classic flow across batches (ROADMAP C.1)
        catalog, spectra, model, samples = harness["load_artifacts"](wd, torch.device("cuda"))
        subset = (Pipeline.default_test_mask(catalog, spectra)
                  & (np.arange(len(catalog)) < SURVEY_SUBSET))
        classic = {}
        for b in SURVEY_SUBSET_BATCHES:
            pipe = Pipeline(harness["rehearsal_params"](), PipelineConfig(
                workdir=str(wd / f"classic_b{b}"), per_device_batch=b, backend="cuda"))
            reset_counts()
            t0 = time.perf_counter()
            res = pipe.run_inference(catalog, spectra, model, samples, test_mask=subset)
            pipe.run_multi(catalog, spectra, model, samples, res, subset)
            sync()
            classic[b] = (time.perf_counter() - t0, launch_counts())
            nb = -(-SURVEY_SUBSET // b)
            if classic[b][1] != (nb, nb, 0, 0, nb):
                fail(f"phase 11 (b): batch {b}: launches {COUNTED} {classic[b][1]}, "
                     f"{nb} batches")
        del catalog, spectra, res
        b_hi, b_lo = SURVEY_SUBSET_BATCHES
        moved = harness["compare_results"](wd / f"classic_b{b_hi}", wd / f"classic_b{b_lo}",
                                           harness["RESULT_FILES"])
        say(f"phase 11 (b): the classic flow under backend='cuda' on {SURVEY_SUBSET} "
            f"sightlines: batch {b_hi} {classic[b_hi][0]:.1f} s, {b_lo} {classic[b_lo][0]:.1f} s; "
            f"arrays that differ: {moved or 'none'}")
        if moved:
            fail(f"phase 11 (b): the classic flow depends on the batch: {moved}")

        # ---- (c) the lean release, killed and resumed, against batch 256
        out = script_run(["scripts/torch_survey_release.py", "--workdir", str(wd),
                          "--batch", str(SURVEY_BATCH)], "(c)")
        rel = harness["marked_json"](out, "RELEASE")
        t0 = time.perf_counter()
        out_b = script_run(["scripts/torch_survey_release.py", "--worker", "--workdir", str(wd),
                            "--batch", str(RELEASE_B_BATCH), "--run-name", "release_b256"],
                           "(c) uninterrupted")
        wall_b = time.perf_counter() - t0
        done_b = harness["marked_json"](out_b, "WORKER COMPLETE")
        nb = -(-SURVEY_SPECTRA // RELEASE_B_BATCH)
        if any(v != nb for k, v in done_b["launches"].items()):
            fail(f"phase 11 (c): the batch-{RELEASE_B_BATCH} run launched "
                 f"{done_b['launches']} for {nb} batches")
        if not rel["killed"] or any(rel["launches"][k] != v
                                    for k, v in rel["expected_launches"].items()):
            fail(f"phase 11 (c): killed {rel['killed']}, launches {rel['launches']} for "
                 f"{rel['expected_launches']}")
        moved = harness["compare_results"](wd / "release", wd / "release_b256",
                                           ["processed_qsos_multi_dr12q.npz"])
        with np.load(wd / "release" / "processed_qsos_multi_dr12q.npz") as f:
            cddf_keys = sorted(k for k in f.files if k.startswith("cddf_"))
        stats = json.loads((wd / "release" / "analysis" / "statistics.json").read_text())
        ascii_files = sorted(p.name for p in (wd / "release").glob("*.dat"))
        say(f"phase 11 (c): the lean release on {rel['n_spectra']} sightlines: killed at "
            f"{rel['kill_point']} of {rel['n_batches']} batches, legs {rel['leg_s']['leg1']:.1f} / "
            f"{rel['leg_s']['leg2']:.1f} s (multi {rel['multi_s_leg2']} s), analysis "
            f"{rel['analysis_s']:.1f} s, {rel['spectra_per_s']:.1f} spectra/s with the kill; "
            f"batch {RELEASE_B_BATCH} uninterrupted {wall_b:.1f} s (multi {done_b['multi_s']} s "
            f"= {SURVEY_SPECTRA / done_b['multi_s']:.1f} spectra/s); exact multiplicity "
            f"{rel['exact_multiplicity_acc']:.4f}; checkpoints {rel['checkpoint_mb']:.1f} MB; "
            f"arrays that differ: {moved or 'none'} ({len(cddf_keys)} cddf_* keys); ASCII "
            f"{ascii_files}; statistics not finite at {nonfinite_json(stats)}")
        if moved:
            fail(f"phase 11 (c): the resumed release differs from batch {RELEASE_B_BATCH}: {moved}")
        if not rel["exact_multiplicity_acc"] >= SURVEY_ACC:
            fail("phase 11 (c): exact multiplicity below the floor")
        if len(ascii_files) != 4 or not cddf_keys or not stats["lean_inputs"] \
                or nonfinite_json(stats):
            fail("phase 11 (c): the ASCII files, the CDDF inputs or the statistics are missing")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    say(f"phase 11 ok ({time.perf_counter() - t_phase:.1f} s)")
    launches = np.zeros(5, np.int64)
    for got in (reh["launches"]["leg3"], reh["launches"]["runB"], rel["launches"],
                done_b["launches"]):
        launches += [got["single"], got["pair"], got["redraw"], got["cddf"], got["null"]]
    for _, counts in classic.values():
        launches += counts
    return {"launches": launches.tolist(), "rehearsal": reh, "release": rel,
            "classic_s": {b: v[0] for b, v in classic.items()}}


def load_roofline():
    """``scripts/torch_roofline.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_roofline", ROOFLINE_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def roofline_phase(smi: str, placed: list[dict]) -> dict:
    """Phase 12: the measured roofline in this process: every ceiling of
    ``torch_roofline.measure_ceilings`` held to its plain chain and to
    1.05x its published peak, then phase 10's B = 1024 time of each
    kernel (``placed``: its time, nvidia-smi sample, published-peak bound
    and work on phase 10's inputs) placed against the bound at the
    measured ceilings (``torch_roofline.kernel_row``).  A kernel faster
    than that bound fails: its op model over-counts or a ceiling reads
    low."""
    t0 = time.perf_counter()
    try:
        ceilings = RL.measure_ceilings(say=lambda m: say(f"phase 12: {m}"))
    except RuntimeError as exc:
        fail(f"phase 12: {exc}")
    rates = RL.class_rates(ceilings)
    rows = [RL.kernel_row(p["name"], p["ms"], p["work"], p["published"], rates, p["gpu"])
            for p in placed]
    for row in rows:
        say(f"phase 12: {RL.kernel_row_text(row)}")
    names = sorted(row["name"] for row in rows)
    want = sorted(["evidence_single_f32", "evidence_pair_f32_r1", "evidence_pair_f32_r4",
                   "redraw_f32", "cddf_sums_f64", "null_evidence_f32"])
    if names != want:
        fail(f"phase 12: kernels placed {names}, expected {want}")
    fast = [row["name"] for row in rows if not 0 < row["measured_share"] <= 1]
    if fast:
        fail(f"phase 12: {fast} faster than the bound at the measured ceilings")
    say(f"phase 12 ok ({time.perf_counter() - t0:.1f} s): FFMA {ceilings['ffma']['rate']:.4e}/s, "
        f"TF32 mma.sync {ceilings['mma_tf32']['rate']:.4e} FLOP/s (3xTF32 "
        f"{ceilings['mma_tf32_3x']['rate']:.4e}), read {ceilings['read_bandwidth']['rate']:.4e} "
        f"B/s ({smi})")
    return {"ceilings": ceilings, "kernels": {row["name"]: row for row in rows}}


def marked(text: str, marker: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith(marker + " {")]
    if len(lines) != 1:
        fail(f"no single {marker} line in the output")
    return json.loads(lines[0][len(marker) + 1:])


def training_phase(smi: str) -> dict:
    """Phase 13: ``scripts/torch_training_convergence.py`` as a user runs
    it, on the card in float64: ``compare`` (part B, TRAINING_B's N and
    budget, the JAX record's) with both optimizers converged, their NLLs
    within TRAINING_RTOL of each other and TRAINING_JAX_RTOL of the
    record; ``part-a`` at TRAINING_A quasars, SIGKILLed after a checkpoint
    and resumed, ended by a convergence test, its NLL within TRAINING_RTOL
    of the JAX record's.  The two run side by side on the card."""
    import shutil
    import signal
    import tempfile

    t0 = time.perf_counter()
    script = "scripts/torch_training_convergence.py"
    wd = Path(tempfile.mkdtemp(prefix="gpdla_training_"))
    procs = {}
    try:
        # both at once: each is bound by its host's issue of small launches,
        # and the card has room for both (their times are side by side's)
        procs["part B"] = start_script([script, "compare", "--n-quasars", TRAINING_B[0],
                                        "--budget", TRAINING_B[1], "--dtype", "float64"])
        procs["part A"] = start_script([script, "part-a", "--n-quasars", TRAINING_A, "--dtype",
                                        "float64", "--workdir", str(wd)])
        outs = {label: finish_script(proc, label, "13", HARNESS_TIMEOUT, HARNESS_LINES)
                for label, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(wd, ignore_errors=True)
    b = marked(outs["part B"], "PART B")
    vs_jax = b["rel_diff_vs_jax"] or {}
    say(f"phase 13 part B: N = {TRAINING_B[0]}: host {b['host']['final_nll']:.10e} "
        f"({b['host']['iterations']} iterations, {b['host']['fun_evals']} evaluations, "
        f"{b['host']['wall_s']:.1f} s), device {b['device']['final_nll']:.10e} "
        f"({b['device']['iterations']}, {b['device']['fun_evals']}, {b['device']['wall_s']:.1f} s, "
        f"{b['device']['scalar_reads_per_eval']:.2f} reads an evaluation), side by side with "
        f"part A; relative difference {b['rel_diff']:.3e}; vs the JAX record {vs_jax}; the "
        f"objective twice at one point: {b['bits_twice']} ({smi})")
    if not b["both_converged"] or not b["rel_diff"] < TRAINING_RTOL:
        fail(f"phase 13: part B converged {b['both_converged']}, relative NLL difference "
             f"{b['rel_diff']:.3e}")
    if set(vs_jax) != {"host", "device"} or not max(vs_jax.values()) < TRAINING_JAX_RTOL:
        fail(f"phase 13: part B's NLLs are {vs_jax} from the JAX record")
    a = marked(outs["part A"], "PART A")
    say(f"phase 13 part A: N = {TRAINING_A}: killed {a['killed']} after the checkpoint at "
        f"iteration {a['checkpoint_iteration_at_kill']} (the worker running "
        f"{a['kill_met_running_worker']}), resumed to '{a['termination']}' at iteration "
        f"{a['iterations']} ({a['fun_evals']} evaluations), NLL {a['final_nll']:.9e} vs the JAX "
        f"record {a['jax_recorded_nll']} (relative {a['rel_diff_vs_jax']}); resumed leg "
        f"{a['wall_s']:.1f} s, {a['s_per_eval'] * 1e3:.2f} ms an evaluation, peak "
        f"{a['peak_device_memory_gb']:.2f} GB; {a['wall_total_s']:.1f} s in all; the objective "
        f"twice: {a['bits_twice']} ({smi})")
    if (not a["killed"] or not a["kill_met_running_worker"]
            or a["checkpoint_iteration_at_kill"] is None or not a["converged"]):
        fail(f"phase 13: part A killed {a['killed']} (the worker running "
             f"{a['kill_met_running_worker']}) at {a['checkpoint_iteration_at_kill']}, "
             f"ended by '{a['termination']}'")
    if not a["rel_diff_vs_jax"] < TRAINING_RTOL:
        fail(f"phase 13: part A's NLL is {a['rel_diff_vs_jax']:.3e} from the JAX record")
    say(f"phase 13 ok ({time.perf_counter() - t0:.1f} s)")
    return {"part_b": b, "part_a": a}


def universe_phase(smi: str) -> dict:
    """Phase 14: ``scripts/torch_synthetic_universe.py`` and ``--multi``
    as a user runs them (no device, dtype or backend: the card, float32,
    the kernels): every assertion of the JAX harness, one single (and
    pair) launch per batch."""
    t0 = time.perf_counter()
    runs = {}
    for name, argv, batch in (("single", [], 256), ("multi", ["--multi"], 64)):
        out = script_run(["scripts/torch_synthetic_universe.py", *argv], name, "14",
                         HARNESS_TIMEOUT, HARNESS_LINES)
        u = marked(out, "UNIVERSE")
        n_batches = -(-u["n_spectra"] // batch)
        want = {"single": n_batches, "null": n_batches,
                "pair": n_batches if name == "multi" else 0}
        if not u["ok"] or any(u["launches"][k] != v for k, v in want.items()):
            fail(f"phase 14 {name}: checks {u['checks']}, launches {u['launches']} for "
                 f"{n_batches} batches")
        runs[name] = u
    s, m = runs["single"], runs["multi"]
    say(f"phase 14 ok ({time.perf_counter() - t0:.1f} s): single {s['true_positives']}/"
        f"{s['injected']} found, {s['false_positives']} false positives, recovered "
        f"{s['recovered_in_range']:.2f} of {s['injected_in_range']} in z = [2.0, 3.4], dN/dX "
        f"{s['recovered_dndx']:.4f} (injected {s['injected_dndx']:.4f}), {s['wall_s']:.2f} s; "
        f"multi confusion {m['confusion']}, >=1-DLA {m['acc_ge1']:.3f}, 2-DLA {m['acc_2dla']:.3f}, "
        f"pair |dz| median {m['pair_dz_median']}, {m['wall_s']:.2f} s ({smi})")
    return runs


def main() -> None:
    global RL
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_script = time.perf_counter()

    # ---- phase 1: the card
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"cannot import torch/numpy: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from gp_dla_detection_tpu_torch import _build
        from gp_dla_detection_tpu_torch.inference import compute_sample_window, process_spectra
        from gp_dla_detection_tpu_torch.models.qso_model import GPModel
        from gp_dla_detection_tpu_torch.ops import evidence, redraw
        from gp_dla_detection_tpu_torch.ops.low_rank_mvn import full_fp32_matmul
        RL = load_roofline()
    except (ImportError, OSError) as exc:
        fail(f"the port is not importable beside this script: {exc}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    device = torch.device("cuda", 0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi failed: {exc}")
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 ok: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    full_fp32_matmul()

    # ---- phase 2: build every kernel source, one nvcc each, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = {name: pool.submit(_build.load_library, name) for name in KERNEL_SOURCES}
    try:
        libs = {name: job.result() for name, job in builds.items()}
    except RuntimeError as exc:
        fail(f"kernel build failed: {exc}")
    built = libs["evidence"]
    say(
        f"phase 2 ok: built {', '.join(lib.path.name for lib in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        + ", ".join(f"{name} {lib.build_seconds:.1f} s" for name, lib in libs.items())
        + f", side by side); evidence k=20: {kernel_report(built.compiler_report, 20)}; "
        + "; ".join(f"{name}: {ptxas_usage(libs[name].compiler_report)}"
                    for name in KERNEL_SOURCES[1:])
    )

    # ---- phase 3: kernel vs plain version at production shapes
    w, params, samples, spectra, prior_z, prior_flags = build_workload(args.seed, N_SPECTRA)
    order = np.argsort(samples.offset_samples, kind="stable")
    offsets = samples.offset_samples[order]
    nhis = samples.nhi_samples[order]
    P6 = params.pixel_pad + 2 * params.instrument.width
    window = compute_sample_window(offsets, evidence.SAMPLE_TILE, P6)
    if window is None:
        fail("no sample window at production shapes")
    worst = (0.0, 0.0)
    for num_lines, n_cmp, windows in ((3, 4, (window, None)), (31, 2, (None, window))):
        kin, kparams = RL.kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float32, num_lines)
        for win in windows:
            out = evidence.sample_log_likelihoods(
                *kin, num_lines=num_lines, instrument=kparams.instrument, window=win
            )
            torch.cuda.synchronize()
            ref = evidence.sample_log_likelihoods_reference(
                *kin, num_lines=num_lines, instrument=kparams.instrument, window=win
            )
            err = normalized_error(out, ref)
            say(f"phase 3: {num_lines} lines, window={win}, B={n_cmp}, S={out.shape[1]}: "
                f"kernel vs plain f32 normalized {err[0]:.3e}, abs {err[1]:.3e}")
            if not err[0] < NORMALIZED_BOUND:
                fail(f"kernel disagrees with its plain version: {err[0]:.3e} >= {NORMALIZED_BOUND}")
            if num_lines == 3 and win == window:
                worst = err
                kin64, _ = RL.kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float64)
                ref64 = evidence.sample_log_likelihoods_reference(
                    *kin64, instrument=kparams.instrument, window=None, sample_chunk=500
                )
                err64 = normalized_error(out, ref64)
                say(f"phase 3: kernel vs plain f64 (accurate Faddeeva, full grid) "
                    f"normalized {err64[0]:.3e}, abs {err64[1]:.3e}")
                if not err64[0] < F64_BOUND:
                    fail(f"kernel disagrees with the float64 path: {err64[0]:.3e} >= {F64_BOUND}")
    # the scale demo's batch shape (twice the table workspace)
    kin, _ = RL.kernel_inputs(w, params, offsets, nhis, SCALE_BATCH, device, torch.float32)
    err256 = normalized_error(evidence.sample_log_likelihoods(*kin, window=window),
                              evidence.sample_log_likelihoods_reference(*kin, window=window))
    say(f"phase 3: 3 lines, window={window}, B={SCALE_BATCH}, S={len(offsets)}: kernel vs plain "
        f"f32 normalized {err256[0]:.3e}, abs {err256[1]:.3e}")
    if not err256[0] < NORMALIZED_BOUND:
        fail(f"kernel disagrees with its plain version at B={SCALE_BATCH}: {err256[0]:.3e}")
    worst = max(worst, err256)
    kin, kparams = RL.kernel_inputs(w, params, offsets, nhis, BATCH, device, torch.float32)
    run_kernel = lambda: evidence.sample_log_likelihoods(*kin, window=window)
    run_plain = lambda: evidence.sample_log_likelihoods_reference(*kin, window=window)
    kernel_ms = cuda_ms(run_kernel, 5)
    plain_ms = cuda_ms(run_plain, 2)
    kernel_ms_2 = cuda_ms(run_kernel, 5)
    S = len(offsets)
    single_bound = RL.evidence_bound(BATCH, S, params.pixel_pad, P6, 20, 3, window, False, 0)
    library_ms = contraction_ms(BATCH, S, params.pixel_pad, device)
    say(f"phase 3 ok: B={BATCH} S={S} P={params.pixel_pad} k=20 windowed: "
        f"kernel {kernel_ms:.2f} / {kernel_ms_2:.2f} ms (PR 3's design: {PR3_MS['single']} ms), "
        f"plain {plain_ms:.2f} ms; bound {single_bound[0]:.2f} ms by the {single_bound[1]} "
        f"({single_bound[0] / kernel_ms:.2f} of it reached; "
        + ", ".join(f"{k} {v:.2f}" for k, v in single_bound[2].items())
        + f" ms); the contraction alone as one FP32 torch.bmm (B, S, P) x (B, P, 240), "
        f"the yardstick: {library_ms:.2f} ms ({smi})")
    del kin
    # 31 lines on the full grid: the Voigt's per-line work dominates
    kin31, kp31 = RL.kernel_inputs(w, params, offsets, nhis, BATCH, device, torch.float32, 31)
    lines31 = dict(num_lines=31, instrument=kp31.instrument, window=None)
    ms31 = cuda_ms(lambda: evidence.sample_log_likelihoods(*kin31, **lines31), 3)
    bound31 = RL.evidence_bound(BATCH, S, params.pixel_pad, P6, 20, 31, None, False, 0)
    say(f"phase 3: B={BATCH} S={S} P={params.pixel_pad} k=20, 31 lines, full grid: kernel "
        f"{ms31:.2f} ms; bound {bound31[0]:.2f} ms by the {bound31[1]} "
        f"({bound31[0] / ms31:.2f} of it reached) ({smi})")

    # ---- phase 4: the main path
    # no device, dtype or backend named: the card, float32, the kernel
    model = GPModel.from_numpy(
        w["grid"], w["mu"], w["M"], w["log_omega"],
        w["log_c_0"], w["log_tau_0"], w["log_beta"],
    )
    if model.mu.device.type != "cuda" or model.mu.dtype != torch.float32:
        fail(f"GPModel.from_numpy defaults to {model.mu.dtype} on {model.mu.device}")
    n_batches = -(-len(spectra) // BATCH)
    evidence.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res32 = process_spectra(
        model, samples.offset_samples, samples.nhi_samples, spectra, prior_z, prior_flags,
        params=params, batch_size=BATCH,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = evidence.launch_count
    if launches != n_batches:
        fail(f"{launches} kernel launches for {n_batches} batches")
    if res32.sample_log_likelihoods_dla.shape != (len(spectra), len(samples.offset_samples)):
        fail(f"sample matrix has shape {res32.sample_log_likelihoods_dla.shape}")
    if res32.sample_log_likelihoods_dla.dtype != np.float32:
        fail(f"process_spectra defaults to {res32.sample_log_likelihoods_dla.dtype}")
    if not np.isfinite(res32.p_dlas).all() or not np.isfinite(res32.sample_log_likelihoods_dla).all():
        fail("non-finite evidences or p_DLA on the main path")
    rate = len(spectra) / seconds
    kernel_share = launches * kernel_ms / 1e3 / seconds
    say(f"phase 4: process_spectra (defaults: cuda, float32, the kernel): {len(spectra)} spectra x "
        f"{len(samples.offset_samples)} samples in {seconds:.3f} s = {rate:.1f} spectra/s "
        f"({launches} launches, batch {BATCH}; launches x phase-3 kernel ms = "
        f"{kernel_share:.2f} of the wall time; {smi})")

    n64 = F64_SUBSET
    res64 = process_spectra(
        model.to(dtype=torch.float64), samples.offset_samples, samples.nhi_samples,
        spectra.slice(slice(0, n64)), prior_z, prior_flags, params=params,
        batch_size=16, sample_chunk=500, dtype=torch.float64, backend="torch",
    )
    p32, p64 = res32.p_dlas[:n64], res64.p_dlas
    flips = (p32 > 0.9) != (p64 > 0.9)
    hard = int((flips & (np.abs(p64 - 0.9) > DECISION_MARGIN)).sum())
    dp = np.abs(p32 - p64)
    p99 = float(np.quantile(dp, 0.99))
    ev_err = normalized_error(
        torch.as_tensor(res32.sample_log_likelihoods_dla[:n64]),
        torch.as_tensor(res64.sample_log_likelihoods_dla),
    )
    say(f"phase 4: f32 cuda vs f64 torch on {n64} spectra: flips outside margin {hard}, "
        f"|dp| p99 {p99:.3e} max {dp.max():.3e}; p_dla>0.9 in {int((p64 > 0.9).sum())}; "
        f"sample evidences normalized {ev_err[0]:.3e}")
    if hard or not p99 < DECISION_P99:
        fail("the float32 kernel path fails the decision gate")
    if not ev_err[0] < F64_BOUND:
        fail(f"main-path evidences disagree with float64: {ev_err[0]:.3e}")
    say("phase 4 ok")

    # ---- phase 5: the pair configuration vs its plain version
    from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern

    S = len(offsets)
    draw_idx, n_draws = replicate_draw_pattern(S, 256, 4)
    rng = np.random.default_rng(args.seed + 3)

    def pair_draws(kin, n, gen=rng):
        """Per-spectrum base (z, N_HI): a seeded permutation of the
        samples in the R = 4 layout, as the lean chain lays out posterior
        draws on the z-sorted pair columns."""
        draws = np.stack([gen.permutation(S)[:n_draws][draw_idx] for _ in range(n)])
        cols = torch.as_tensor(draws, device=device)
        return kin[7].gather(1, cols).contiguous(), kin[8].gather(1, cols).contiguous()

    pair_worst = (0.0, 0.0)
    for num_lines, n_cmp, windows in ((3, 4, (window, None)), (31, 2, (None, window))):
        kin, kparams = RL.kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float32, num_lines)
        z2, n2 = pair_draws(kin, n_cmp)
        for win in windows:
            out = evidence.sample_log_likelihoods_pair(
                *kin, z2, n2, num_lines=num_lines, instrument=kparams.instrument, window=win,
                base_replicates=4,
            )
            torch.cuda.synchronize()
            out1 = evidence.sample_log_likelihoods_pair(
                *kin, z2, n2, num_lines=num_lines, instrument=kparams.instrument, window=win,
            )
            if not torch.equal(out, out1):
                fail(f"pair kernel at R=4 differs from R=1 on an R=4 layout "
                     f"({num_lines} lines, window={win})")
            ref = evidence.sample_log_likelihoods_pair_reference(
                *kin, z2, n2, num_lines=num_lines, instrument=kparams.instrument, window=win
            )
            err = normalized_error(out, ref)
            say(f"phase 5: pair, {num_lines} lines, window={win}, B={n_cmp}, S={S}: "
                f"kernel (R=4) vs plain f32 normalized {err[0]:.3e}, abs {err[1]:.3e}; "
                f"R=4 bit-identical to R=1")
            if not err[0] < NORMALIZED_BOUND:
                fail(f"pair kernel disagrees with its plain version: {err[0]:.3e} >= {NORMALIZED_BOUND}")
            pair_worst = max(pair_worst, err)
            if num_lines == 3 and win == window:
                kin64, _ = RL.kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float64)
                ref64 = evidence.sample_log_likelihoods_pair_reference(
                    *kin64, z2.double(), n2.double(), instrument=kparams.instrument,
                    window=None, sample_chunk=500,
                )
                err64 = normalized_error(out, ref64)
                say(f"phase 5: pair kernel vs plain f64 (accurate Faddeeva, full grid) "
                    f"normalized {err64[0]:.3e}, abs {err64[1]:.3e}")
                if not err64[0] < F64_BOUND:
                    fail(f"pair kernel disagrees with the float64 path: {err64[0]:.3e} >= {F64_BOUND}")
    # the scale demo's batch shape, on draws of a generator of its own
    # (phase 6 draws its priors from rng)
    kin, _ = RL.kernel_inputs(w, params, offsets, nhis, SCALE_BATCH, device, torch.float32)
    z2, n2 = pair_draws(kin, SCALE_BATCH, np.random.default_rng(args.seed + 5))
    pair_err256 = normalized_error(
        evidence.sample_log_likelihoods_pair(*kin, z2, n2, window=window, base_replicates=4),
        evidence.sample_log_likelihoods_pair_reference(*kin, z2, n2, window=window),
    )
    say(f"phase 5: pair, 3 lines, window={window}, B={SCALE_BATCH}, S={S}: kernel (R=4) vs plain "
        f"f32 normalized {pair_err256[0]:.3e}, abs {pair_err256[1]:.3e}")
    if not pair_err256[0] < NORMALIZED_BOUND:
        fail(f"pair kernel disagrees with its plain version at B={SCALE_BATCH}: {pair_err256[0]:.3e}")
    pair_worst = max(pair_worst, pair_err256)
    kin, kparams = RL.kernel_inputs(w, params, offsets, nhis, BATCH, device, torch.float32)
    z2, n2 = pair_draws(kin, BATCH)
    run_pair = lambda R: evidence.sample_log_likelihoods_pair(
        *kin, z2, n2, window=window, base_replicates=R
    )
    run_pair_plain = lambda: evidence.sample_log_likelihoods_pair_reference(*kin, z2, n2, window=window)
    if not torch.equal(run_pair(4), run_pair(1)):
        fail("pair kernel at R=4 differs from R=1 at B=128 on an R=4 layout")
    pair_ms = cuda_ms(lambda: run_pair(4), 5)
    pair_plain_ms = cuda_ms(run_pair_plain, 2)
    pair_ms_2 = cuda_ms(lambda: run_pair(4), 5)
    pair_r1_ms = cuda_ms(lambda: run_pair(1), 5)
    single_ms_same_call = cuda_ms(lambda: evidence.sample_log_likelihoods(*kin, window=window), 5)
    pair_bound = RL.evidence_bound(BATCH, S, params.pixel_pad, P6, 20, 3, window, True, n_draws)
    say(f"phase 5 ok: B={BATCH} S={S} P={params.pixel_pad} k=20 windowed pair, R=4 layout: "
        f"kernel {pair_ms:.2f} / {pair_ms_2:.2f} ms at R=4 (PR 3's design: {PR3_MS['pair R=4']} "
        f"ms), {pair_r1_ms:.2f} ms at R=1 (bit-identical), plain {pair_plain_ms:.2f} ms; single "
        f"kernel {single_ms_same_call:.2f} ms in the same call; bound {pair_bound[0]:.2f} ms by "
        f"the {pair_bound[1]} at {n_draws} distinct base draws ({pair_bound[0] / pair_ms:.2f} "
        "of it reached; " + ", ".join(f"{k} {v:.2f}" for k, v in pair_bound[2].items())
        + f" ms) ({smi})")
    del kin, z2, n2
    # (a generator of their own: phase 6 draws its priors from rng)
    z2, n2 = pair_draws(kin31, BATCH, np.random.default_rng(args.seed + 4))
    pair_ms31 = cuda_ms(lambda: evidence.sample_log_likelihoods_pair(
        *kin31, z2, n2, **lines31, base_replicates=4), 3)
    pair_bound31 = RL.evidence_bound(BATCH, S, params.pixel_pad, P6, 20, 31, None, True, n_draws)
    say(f"phase 5: B={BATCH} S={S} P={params.pixel_pad} k=20, 31 lines, full grid, R=4: pair "
        f"kernel {pair_ms31:.2f} ms; bound {pair_bound31[0]:.2f} ms by the {pair_bound31[1]} "
        f"({pair_bound31[0] / pair_ms31:.2f} of it reached) ({smi})")
    del kin31, z2, n2

    # ---- phase 6: the fused lean two-stage chain
    import gp_dla_detection_tpu_torch.parallel.sharded_multi as sharded_multi
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi

    spectra2 = dataclasses.replace(spectra, flux=inject_second_dlas(w, params, args.seed))
    prior_num = np.where(prior_flags, rng.choice([1, 1, 1, 2], len(prior_flags)), 0)

    # observe what the pair kernel receives, what the pair reduction sees
    # and what the redraw is given, without changing any of them
    seen = {"pattern_ok": [], "has_valid": [], "redraws": []}
    kernel_pair = evidence.sample_log_likelihoods_pair
    reduce_pair = sharded_multi.pack_lean_pair
    kernel_redraw = sharded_multi.device_inverse_cdf_grid

    def pair_spy(*a, **kw):
        z2_cols = a[9]
        full = z2_cols.shape[1] // 256 * 256
        tiles = z2_cols[:, :full].reshape(z2_cols.shape[0], -1, 4, 64)
        seen["pattern_ok"].append(bool(full) and bool((tiles == tiles[:, :, :1]).all()))
        return kernel_pair(*a, **kw)

    def reduce_spy(pair_lls, base_inds):
        seen["has_valid"].append(torch.isfinite(pair_lls).any(dim=1))
        return reduce_pair(pair_lls, base_inds)

    def redraw_spy(sll, kvec, grid_size=None):
        seen["redraws"].append((sll.cpu(), kvec.cpu(), grid_size))
        return kernel_redraw(sll, kvec, grid_size)

    def lean(R, spy=False, loop=None, strict=False):
        evidence.sample_log_likelihoods_pair = pair_spy if spy else kernel_pair
        sharded_multi.pack_lean_pair = reduce_spy if spy else reduce_pair
        sharded_multi.device_inverse_cdf_grid = redraw_spy if spy else kernel_redraw
        try:
            with strict_issue() if strict else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # no device, dtype or backend named: the card, float32, the
                # kernels; the pipelined loop at its defaults unless serial
                res = sharded_multi.process_spectra_multi_lean(
                    model, samples.offset_samples, samples.nhi_samples, spectra2, prior_z,
                    prior_num, params=params, batch_size=BATCH, base_replicates=R,
                    **(loop or {}),
                )
                torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            evidence.sample_log_likelihoods_pair = kernel_pair
            sharded_multi.pack_lean_pair = reduce_pair
            sharded_multi.device_inverse_cdf_grid = kernel_redraw

    loops = {1: SERIAL, 2: {"pipeline_depth": 2}, 4: {}}   # pipeline depth: the loop's keywords

    def depths(R, first, first_s, grid, rounds):
        """Runs of each loop in ``grid`` in turns (``rounds`` rounds, the
        order reversed every other round) after ``first`` (a default
        run): their wall seconds, each result held bit for bit to
        ``first``."""
        seconds = {key: [] for key in grid}
        seconds[4].append(first_s)
        for r in range(rounds):
            for key in (grid if r % 2 else grid[::-1]):
                res, sec = lean(R, loop=loops[key])
                if not same_bits(result_arrays(res), result_arrays(first)):
                    fail(f"lean chain (R={R}): the loop at depth {key} differs from the "
                         "pipelined main-path run")
                seconds[key].append(sec)
        return seconds

    rates = lambda secs: "/".join(f"{len(spectra2) / t:.1f}" for t in secs)
    # the process's first pipelined run, profiled: what a cold run pays
    cold4, cold_split = profile_split(lambda: lean(None)[0])
    # the main path, timed, with nothing observing it: the defaults, 4
    # batches in flight
    reset_counts()
    lean4, lean_s = lean(None)
    lean_launches = launch_counts()
    if lean_launches != (n_batches, n_batches, n_batches, 0, n_batches):
        fail(f"lean chain: {lean_launches} {COUNTED} launches for {n_batches} batches")
    if not same_bits(result_arrays(cold4), result_arrays(lean4)):
        fail("lean chain: the profiled first run differs from the main path's")
    secs4 = depths(None, lean4, lean_s, list(loops), 3)
    # every issue under the sync-debug mode "error": no host sync
    try:
        strict4, _ = lean(None, strict=True)
    except RuntimeError as exc:
        fail(f"lean chain: a host sync in issue: {exc}")
    if not same_bits(result_arrays(strict4), result_arrays(lean4)):
        fail("lean chain: the run under the sync-debug mode differs")
    # the same run again, observed: the inputs are the same, so is the output
    spied, _ = lean(None, spy=True)
    if len(seen["pattern_ok"]) != n_batches or not all(seen["pattern_ok"]):
        fail(f"the pair kernel's base redshifts break the R = 4 layout: {seen['pattern_ok']}")
    if not np.array_equal(spied.model_posteriors, lean4.model_posteriors):
        fail("two identical lean runs gave different posteriors")
    has_valid = torch.cat(seen["has_valid"]).cpu().numpy()[: len(spectra2)]
    ev2 = lean4.log_likelihoods_dla2
    if not np.isfinite(lean4.single.log_likelihoods_dla).all():
        fail("non-finite single-DLA evidences in the lean chain")
    if not np.allclose(lean4.model_posteriors.sum(axis=1), 1.0, rtol=0, atol=1e-9):
        fail("lean chain posteriors do not sum to 1")
    if not np.array_equal(np.isnan(ev2), ~has_valid):
        fail("lean chain pair evidence is NaN where a row has valid pairs (or finite where none)")
    picks = np.bincount(np.argmax(lean4.model_posteriors, axis=1), minlength=3)
    lean_rate = len(spectra2) / lean_s
    say(f"phase 6: process_spectra_multi_lean (defaults: cuda, float32, the kernels, R=4, "
        f"pipeline depth 4): {len(spectra2)} spectra x {S} samples in "
        f"{lean_s:.3f} s = {lean_rate:.1f} spectra/s; launches {COUNTED} "
        f"{lean_launches} for {n_batches} batches; launches x phase-5 kernel ms = "
        f"{n_batches * (single_ms_same_call + pair_ms) / 1e3 / lean_s:.2f} of the wall time; "
        f"R=4 layout held on every batch; 3-class picks {picks.tolist()}; rows without a "
        f"valid pair {int((~has_valid).sum())} ({smi})")
    say(f"phase 6: R=4 in turns after it, spectra/s: "
        + "; ".join(f"depth {key} {rates(secs)}" for key, secs in secs4.items())
        + f" (the first of depth 4 is the main path's); every run "
        f"bit-identical to the main path's; every issue passed under the sync-debug mode "
        f"\"error\" ({smi})")
    warm_split = None
    for key in (4, 1):
        _, split6 = profile_split(lambda: lean(None, loop=loops[key])[0])
        warm_split = warm_split or split6
        say(f"phase 6: R=4 at depth {key}, warm, {split_text(split6)}")
    say(f"phase 6: R=4, the process's first pipelined run (the default), {split_text(cold_split)}")
    if cold_split and warm_split:
        say(f"phase 6: host ops (every thread) that took most more time in the first pipelined "
            f"run than in the warm one: {cold_cost(cold_split, warm_split)}")

    # the redraw kernel on the inputs the chain gave it (the observed run),
    # and its time at the chain's batch beside the plain sequence's
    redraw6 = redraw_check(seen["redraws"], "phase 6", smi)
    redraw_rows_alone(torch.cat([c[0] for c in seen["redraws"]]), *seen["redraws"][0][1:],
                      "phase 6")
    x6, kv6, grid6 = seen["redraws"][0]
    x6, kv6 = x6.cuda(), kv6.cuda()
    redraw6_t = redraw_times(x6, kv6, grid6, 20)
    redraw6_bound = RL.redraw_bound(*x6.shape, kv6.numel())
    say(f"phase 6: redraw kernel at B={x6.shape[0]} S={x6.shape[1]} grid {grid6}: "
        f"{redraw_time_line(redraw6_t, redraw6_bound)}; rows bit-identical at B=1, 128 "
        f"and permuted ({smi})")
    del x6, kv6, seen["redraws"]

    reset_counts()
    lean1, lean1_s = lean(1)
    launches1 = launch_counts()
    if launches1 != (n_batches, n_batches, n_batches, 0, n_batches):
        fail(f"lean chain (R=1): {launches1} {COUNTED} launches for {n_batches} batches")
    secs1 = depths(1, lean1, lean1_s, [1, 4], 3)
    say(f"phase 6: R=1: {len(spectra2)} spectra in {lean1_s:.3f} s = "
        f"{len(spectra2) / lean1_s:.1f} spectra/s; launches {launches1}; in turns, spectra/s: "
        f"depth 1 {rates(secs1[1])}, the default {rates(secs1[4])}, all "
        f"bit-identical ({smi})")
    n64 = F64_SUBSET
    t0 = time.perf_counter()
    classic64 = process_spectra_multi(
        model.to(dtype=torch.float64), samples.offset_samples, samples.nhi_samples,
        spectra2.slice(slice(0, n64)), prior_z, prior_num, params=params,
        batch_size=16, sample_chunk=500, dtype=torch.float64, backend="torch",
    )
    classic_s = time.perf_counter() - t0
    post32, post64 = lean1.model_posteriors[:n64], classic64.model_posteriors
    win64 = np.argmax(post64, axis=1)
    sure = post64[np.arange(n64), win64] > 0.9 + DECISION_MARGIN
    flips = int((sure & (np.argmax(post32, axis=1) != win64)).sum())
    a, b = lean1.log_likelihoods_dla2[:n64], classic64.log_likelihoods_dla2
    nan_same = np.array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    worst_pair = float(np.max(np.abs(a[fin] - b[fin]) / (PAIR_ATOL + PAIR_RTOL * np.abs(b[fin]))))
    say(f"phase 6: lean f32 cuda R=1 vs classic f64 torch on {n64} spectra ({classic_s:.1f} s): "
        f"decision flips where p64 > 0.91: {flips} ({int(sure.sum())} such spectra, f64 picks "
        f"{np.bincount(win64, minlength=3).tolist()}); pair evidence |a-b| / (atol + rtol |b|) "
        f"max {worst_pair:.3f}, NaN rows equal {nan_same}")
    if flips:
        fail("the lean float32 chain flips confident 3-class decisions")
    if not nan_same or not worst_pair <= 1.0:
        fail("lean pair evidences disagree with the float64 classic driver")
    say("phase 6 ok")

    # ---- phase 7: the one-command release
    release = release_phase(
        args.seed, smi,
        (model, samples.offset_samples, samples.nhi_samples, spectra2, prior_z, prior_num, params),
    )
    rl, rb = release["launches"], release["batches"]

    # ---- phase 8: the drivers across ranks
    ranks_phase(
        smi, w,
        (model, samples.offset_samples, samples.nhi_samples, spectra2, prior_z, prior_num, params),
        release,
    )

    # ---- phase 9: the scale demo
    demo = scale_demo_phase(smi)
    dl = demo["launches"]

    # ---- phase 10: the port's bench
    bp = bench_phase(smi, args.seed)
    bk = bp["kernels"]
    bench_launches = {
        name: bp["kernel_line"]["launches"].get(name, 0) + bp["chain_line"]["launches"][name]
        for name in ("single", "pair")
    }

    # ---- phase 11: the survey harnesses
    survey = survey_phase(smi, args.seed)
    sl = survey["launches"]

    # ---- phase 12: the measured roofline
    roof = roofline_phase(smi, bp["placed"])

    def roof_keys(name: str) -> dict:
        """Phase 12's placing of the kernel's ``ms_b1024`` (phase 10's)."""
        k = roof["kernels"][name]
        return {"measured_bound_ms": k["measured_bound_ms"], "measured_share": k["measured_share"],
                "bounding_class": k["bounding_class"], "published_share_b1024": k["published_share"],
                "composite_ms": k["composite_ms"], "composite_share": k["composite_share"],
                "class_ms": k["class_ms"], "gpu_b1024": k["gpu"]}

    # ---- phase 13: GP training to convergence
    training = training_phase(smi)

    # ---- phase 14: the synthetic universe
    universe = universe_phase(smi)
    ul = {name: sum(u["launches"][name] for u in universe.values())
          for name in ("single", "pair", "redraw", "cddf", "null")}

    # ---- phase 15: results
    say(f"chip_smoke: phases 1-14 passed in {time.perf_counter() - t_script:.1f} s")
    # the line holds what this run measured and what follows from it: the
    # published peaks, the JAX record and the runs' settings stay in the
    # report lines above
    without = lambda d, keys: {k: v for k, v in d.items() if k not in keys}
    say(json.dumps({"ceilings": {name: without(c, {"published"})
                                 for name, c in roof["ceilings"].items()}, "training": {
        "part_b": {k: training["part_b"][k] for k in ("host", "device", "rel_diff",
                                                       "rel_diff_vs_jax", "bits_twice")},
        "part_a": without(training["part_a"], {"jax_recorded_nll", "n_quasars"})},
        "universe": {name: without(u, {"n_spectra", "rate_dndx", "seed"})
                     for name, u in universe.items()}, "kernels": [
        {
            "name": "evidence_single_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/evidence.cu",
            "replaces": "gp_dla_detection_tpu/ops/evidence_pallas.py:106",
            "launches": rl["process"][0] + rl["multi"][0] + dl[0] + bench_launches["single"]
                        + sl[0] + ul["single"],
            "launches_universe": ul["single"],
            **roof_keys("evidence_single_f32"),
            "launches_bench_default": bench_launches["single"],
            "launches_survey": sl[0],
            "launches_release_process": rl["process"][0],
            "launches_release_multi": rl["multi"][0],
            "launches_lean_chain": lean_launches[0],
            "launches_process_spectra": launches,
            "max_abs_err": worst[1],
            "max_normalized_err": worst[0],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": single_bound[0],
            "bound_by": "bytes" if single_bound[1] == "bytes" else "operations",
            "bound_pipe": single_bound[1],
            "bound_share": single_bound[0] / kernel_ms,
            "library_ms": library_ms,
            "library_call": "torch.bmm (B,S,P)x(B,P,240) fp32, TF32 off: the contraction alone",
            "ms_31_lines_full_grid": ms31,
            "bound_ms_31_lines_full_grid": bound31[0],
            "launches_scale_demo": dl[0],
            "launches_per_batch": {"process": rl["process"][0] / rb, "multi": rl["multi"][0] / rb,
                                   "scale_demo": dl[0] / demo["batches"]},
            "ms_b256_scale_demo": demo["call_ms"]["single"],
            "max_normalized_err_b256": err256[0],
            "spectra_per_s": rate,
            "ms_b1024": bk["single"]["ms"],
            "bound_ms_b1024": bk["single"]["bound_ms"],
            "b1024_rows_equal_b128": bk["single"]["rows_equal_b128"],
            "max_normalized_err_b1024_bench": bk["single"]["max_normalized_err"],
            "bench_kernel_mode_spectra_per_s": {b: r["value"] for b, r in bp["sweep"].items()},
            "bench_kernel_mode_peak_gb": {b: r["peak_memory_gb"] for b, r in bp["sweep"].items()},
            "card": smi,
        },
        {
            "name": "evidence_pair_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/evidence.cu",
            "replaces": "gp_dla_detection_tpu/ops/evidence_pallas.py:106",
            "launches": rl["multi"][1] + dl[1] + bench_launches["pair"] + sl[1] + ul["pair"],
            "launches_universe": ul["pair"],
            **roof_keys("evidence_pair_f32_r4"),
            "roofline_r1": {"ms_b1024": bk["pair"]["ms_r1"],
                            "bound_ms_b1024": roof["kernels"]["evidence_pair_f32_r1"]["bound_ms"],
                            **roof_keys("evidence_pair_f32_r1")},
            "launches_bench_default": bench_launches["pair"],
            "launches_survey": sl[1],
            "launches_lean_chain": lean_launches[1],
            "launches_scale_demo": dl[1],
            "max_abs_err": pair_worst[1],
            "max_normalized_err": pair_worst[0],
            "ms": pair_ms,
            "ms_r1": pair_r1_ms,
            "plain_ms": pair_plain_ms,
            "bound_ms": pair_bound[0],
            "bound_by": "bytes" if pair_bound[1] == "bytes" else "operations",
            "bound_pipe": pair_bound[1],
            "bound_share": pair_bound[0] / pair_ms,
            "library_ms": library_ms,
            "library_call": "torch.bmm (B,S,P)x(B,P,240) fp32, TF32 off: the contraction alone",
            "ms_31_lines_full_grid": pair_ms31,
            "bound_ms_31_lines_full_grid": pair_bound31[0],
            "launches_per_batch": {"multi": rl["multi"][1] / rb,
                                   "scale_demo": dl[1] / demo["batches"]},
            "ms_b256_scale_demo": demo["call_ms"]["pair"],
            "max_normalized_err_b256": pair_err256[0],
            "lean_chain_spectra_per_s": lean_rate,
            "lean_chain_r1_spectra_per_s": len(spectra2) / lean1_s,
            "lean_chain_cddf_off_spectra_per_s": release["cddf_off_spectra_per_s"],
            "lean_chain_cddf_on_spectra_per_s": release["cddf_on_spectra_per_s"],
            "release_stage_seconds": release["stage_seconds"],
            "scale_demo_spectra_per_s": demo["spectra_per_s"],
            "scale_demo_kernel_share": demo["kernel_share"],
            "ms_b1024": bk["pair"]["ms"],
            "bound_ms_b1024": bk["pair"]["bound_ms"],
            "b1024_rows_equal_b128": bk["pair"]["rows_equal_b128"],
            "max_normalized_err_b1024_bench": bk["pair"]["max_normalized_err"],
            "bench_lines": [bp["kernel_line"], bp["chain_line"], bp["driver_line"]],
            "card": smi,
        },
        {
            "name": "redraw_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/redraw.cu",
            "replaces": "gp_dla_detection_tpu/multi_dla.py:219 (device_inverse_cdf_grid, XLA: "
                        "no TPU kernel; the port's plain torch.cumsum sequence)",
            "launches": lean_launches[2] + rl["multi"][2] + bp["chain_line"]["launches"]["redraw"]
                        + sl[2] + ul["redraw"],
            "launches_universe": ul["redraw"],
            **roof_keys("redraw_f32"),
            "launches_lean_chain": lean_launches[2],
            "launches_survey": sl[2],
            "launches_release_multi": rl["multi"][2],
            "launches_bench_default": bp["chain_line"]["launches"]["redraw"],
            "launches_per_batch": {"lean_chain": lean_launches[2] / n_batches,
                                   "multi": rl["multi"][2] / rb},
            "max_abs_err": max(redraw6["vs_plain"], bp["redraw"]["vs_plain"]),
            "max_abs_err_of": "the CDF against the plain float32 cumsum's",
            "cdf_err_vs_f64": max(redraw6["kernel"], bp["redraw"]["kernel"]),
            "plain_cdf_err_vs_f64": max(redraw6["plain"], bp["redraw"]["plain"]),
            "draws_differing_from_plain": [redraw6["draws_moved"], bp["redraw"]["draws_moved"]],
            "rows_differing_from_plain": [redraw6["rows_moved"], bp["redraw"]["rows_moved"]],
            "ms": redraw6_t["ms"],
            "plain_ms": redraw6_t["plain_ms"],
            "queued_ms": redraw6_t["queued_ms"],
            "queued_ms_of": "queued behind a spin kernel: the card's time alone "
                            "(chip_smoke.queued_ms; ms is cuda_ms, as every row's)",
            "plain_queued_ms": redraw6_t["plain_queued_ms"],
            "bound_ms": redraw6_bound[0],
            "bound_by": redraw6_bound[1],
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes a CDF's grid counts and the "
                            "draws at kvec",
            "ms_b1024": bp["redraw"]["ms"],
            "plain_ms_b1024": bp["redraw"]["plain_ms"],
            "queued_ms_b1024": bp["redraw"]["queued_ms"],
            "plain_queued_ms_b1024": bp["redraw"]["plain_queued_ms"],
            "bound_ms_b1024": bp["redraw"]["bound_ms"],
            "card": smi,
        },
        {
            "name": "cddf_sums_f64",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/cddf.cu",
            "replaces": "gp_dla_detection_tpu/cddf_inputs.py:444 (the reducer's acc.at[].add and "
                        "masked products, XLA: no TPU kernel; the port's plain scatter_add_ sums)",
            "launches": rl["multi"][3] + bp["chain_launches"][3] + sl[3] + ul["cddf"],
            "launches_universe": ul["cddf"],
            **roof_keys("cddf_sums_f64"),
            "launches_release_multi": rl["multi"][3],
            "launches_survey": sl[3],
            "launches_bench_chain_b1024": bp["chain_launches"][3],
            "launches_per_batch": {"multi": rl["multi"][3] / rb},
            "max_abs_err": bp["sums"]["max_abs_err"],
            "max_rel_err": bp["sums"]["max_rel_err"],
            "ms": bp["sums"]["times"][BATCH][0],
            "plain_ms": bp["sums"]["times"][BATCH][1],
            "bound_ms": bp["sums"]["bounds"][BATCH][0],
            "bound_by": bp["sums"]["bounds"][BATCH][1],
            "library_ms": bp["sums"]["library"][BATCH],
            "library_call": "one float64 scatter_add_ of the prebuilt channel values at their "
                            "prebuilt flat bins: the same histogram with the card's atomics",
            "ms_b1024": bp["sums"]["times"][BENCH_BATCH][0],
            "plain_ms_b1024": bp["sums"]["times"][BENCH_BATCH][1],
            "bound_ms_b1024": bp["sums"]["bounds"][BENCH_BATCH][0],
            "library_ms_b1024": bp["sums"]["library"][BENCH_BATCH],
            "reducer_split_ms": bp["sums"]["split"],
            "longest_run_of_equal_bases": [bp["sums"]["longest_run_mean"],
                                           bp["sums"]["longest_run_max"]],
            "card": smi,
        },
        {
            "name": "null_evidence_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/null_evidence.cu",
            "replaces": "gp_dla_detection_tpu/ops/low_rank_mvn.py:141 (log_mvnpdf_low_rank, XLA: "
                        "no TPU kernel; the port's plain torch.sum / matmul / Cholesky sequence)",
            "launches": lean_launches[4] + rl["process"][4] + rl["multi"][4] + bp["chain_launches"][4]
                        + sl[4] + ul["null"],
            "launches_universe": ul["null"],
            **roof_keys("null_evidence_f32"),
            "launches_lean_chain": lean_launches[4],
            "launches_survey": sl[4],
            "launches_release_process": rl["process"][4],
            "launches_release_multi": rl["multi"][4],
            "launches_bench_chain_b1024": bp["chain_launches"][4],
            "launches_per_batch": {"lean_chain": lean_launches[4] / n_batches,
                                   "process": rl["process"][4] / rb, "multi": rl["multi"][4] / rb},
            "max_abs_err": bp["null"]["max_abs_err"],
            "max_normalized_err": bp["null"]["max_normalized_err"],
            "normalized_err_vs_f64": bp["null"]["normalized_err_vs_f64"],
            "plain_normalized_err_vs_f64": bp["null"]["plain_normalized_err_vs_f64"],
            "plain_rows_moved_with_the_batch": bp["null"]["plain_rows_moved"],
            "ms": bp["null"]["times"][BATCH][0],
            "plain_ms": bp["null"]["times"][BATCH][1],
            "bound_ms": bp["null"]["bounds"][BATCH][0],
            "bound_by": bp["null"]["bounds"][BATCH][1],
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes a masked low-rank Woodbury "
                            "log-density",
            "ms_b1024": bp["null"]["times"][BENCH_BATCH][0],
            "plain_ms_b1024": bp["null"]["times"][BENCH_BATCH][1],
            "bound_ms_b1024": bp["null"]["bounds"][BENCH_BATCH][0],
            "card": smi,
        },
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
