#!/usr/bin/env python3
"""Drive the PyTorch port's single-DLA inference path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:

1. find the card (a CUDA device is required; nothing runs on the CPU)
   and print its name and power limit as nvidia-smi reports them;
2. build the evidence kernel (csrc/evidence.cu) with nvcc;
3. hold the kernel against its plain PyTorch version on the card at the
   production shapes (P = 1274 px, k = 20, S = 10,000 samples, 3 lines,
   windowed and full grid, plus a 31-line case) to 5e-5 normalized
   error, and against the float64 plain path; time both versions at the
   main path's batch shape;
4. run ``inference.process_spectra(backend="cuda", dtype=float32)`` on a
   few hundred synthetic spectra with the 10,000-sample QMC set, check
   that every batch launched the kernel and every p_DLA is finite, and
   hold a subset to the float64 plain path with the catalog decision
   gate (no flips at p = 0.9 outside +-0.01, |dp| p99 < 1e-3);
5. print a JSON line describing the kernel and, last, a JSON line with
   the device.

Weights and data are random, made from ``--seed`` with numpy.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

NORMALIZED_BOUND = 5e-5       # kernel vs plain float32 (tests/test_evidence_pallas.py)
F64_BOUND = 5e-4              # float32 kernel vs the float64 plain path: fast
                              # Faddeeva (1.3e-5 rel) + float32 roundoff of x
DECISION_MARGIN = 0.01        # tests/test_f32_decisions.py
DECISION_P99 = 1e-3
N_SPECTRA = 512               # main-path run: 4 batches of 128
BATCH = 128
F64_SUBSET = 32               # spectra re-run on the float64 plain path


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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls after
    one warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_report(report: str, k: int) -> str:
    """ptxas's register/spill lines for the rank-k kernel instance."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"ILi{k}E" in line:
            keep = [l.strip() for l in lines[i + 1 : i + 4] if "ptxas" in l or "spill" in l]
            return " | ".join(keep)
    return "no ptxas report"


def torch_tensor(a):
    import torch

    return torch.as_tensor(a, dtype=torch.float64)


def build_workload(seed: int, n_spectra: int):
    """Synthetic production-shape spectra + model (utils.synthetic) and
    the real 10,000-sample QMC set (samples.generate_dla_samples)."""
    import numpy as np

    from gp_dla_detection_tpu.params import LYA_WAVELENGTH, LYMAN_LIMIT
    from gp_dla_detection_tpu.samples import generate_dla_samples
    from gp_dla_detection_tpu.utils.synthetic import synthetic_workload
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption

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
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params)
    spectra = PaddedSpectra(
        w["wavelengths"], w["flux"], w["noise_variance"], w["mask"], w["z_qso"]
    )
    prior_z = rng.uniform(2.0, 4.4, 5000)
    prior_flags = rng.uniform(size=5000) < 0.15
    return w, params, samples, spectra, prior_z, prior_flags


def kernel_inputs(w, params, offsets, nhis, n, device, dtype, num_lines=3):
    """Prepared per-spectrum inputs of the evidence kernel for the first
    ``n`` spectra (the port's own _prepare_spectrum), samples sorted."""
    import dataclasses

    import numpy as np
    import torch

    from gp_dla_detection_tpu_torch.inference import _prepare_spectrum

    params = dataclasses.replace(params, num_lines=num_lines)
    t = lambda a: torch.as_tensor(np.asarray(a)[:n] if np.ndim(a) else a, device=device).to(dtype)
    prep = _prepare_spectrum(
        t(w["wavelengths"]), t(w["flux"]), t(w["noise_variance"]),
        torch.as_tensor(w["mask"][:n], device=device), t(w["z_qso"]),
        torch.as_tensor(w["grid"], device=device).to(dtype),
        torch.as_tensor(w["mu"], device=device).to(dtype),
        torch.as_tensor(w["M"], device=device).to(dtype),
        torch.as_tensor(w["log_omega"], device=device).to(dtype),
        w["log_c_0"], w["log_tau_0"], w["log_beta"], params,
    )
    off = torch.as_tensor(offsets, device=device).to(dtype)
    z = prep["min_z_dla"][:, None] + (prep["max_z_dla"] - prep["min_z_dla"])[:, None] * off[None, :]
    nhi = torch.as_tensor(nhis, device=device).to(dtype)[None, :].expand(z.shape).contiguous()
    args = (
        prep["padded_wavelengths"], t(w["flux"]), prep["mu"], prep["M"],
        prep["omega2"], t(w["noise_variance"]), prep["valid"], z, nhi,
    )
    return args, params


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
        from gp_dla_detection_tpu_torch.ops import evidence
        from gp_dla_detection_tpu_torch.ops.low_rank_mvn import full_fp32_matmul
    except ImportError as exc:
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

    # ---- phase 2: build
    t0 = time.perf_counter()
    try:
        built = _build.load_library("evidence")
    except RuntimeError as exc:
        fail(f"kernel build failed: {exc}")
    say(
        f"phase 2 ok: built {built.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {built.build_seconds:.1f} s); k=20: {kernel_report(built.compiler_report, 20)}"
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
        kin, kparams = kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float32, num_lines)
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
                kin64, _ = kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float64)
                ref64 = evidence.sample_log_likelihoods_reference(
                    *kin64, instrument=kparams.instrument, window=None, sample_chunk=500
                )
                err64 = normalized_error(out, ref64)
                say(f"phase 3: kernel vs plain f64 (accurate Faddeeva, full grid) "
                    f"normalized {err64[0]:.3e}, abs {err64[1]:.3e}")
                if not err64[0] < F64_BOUND:
                    fail(f"kernel disagrees with the float64 path: {err64[0]:.3e} >= {F64_BOUND}")
    kin, kparams = kernel_inputs(w, params, offsets, nhis, BATCH, device, torch.float32)
    run_kernel = lambda: evidence.sample_log_likelihoods(*kin, window=window)
    run_plain = lambda: evidence.sample_log_likelihoods_reference(*kin, window=window)
    kernel_ms = cuda_ms(run_kernel, 5)
    plain_ms = cuda_ms(run_plain, 2)
    kernel_ms_2 = cuda_ms(run_kernel, 5)
    say(f"phase 3 ok: B={BATCH} S={len(offsets)} P={params.pixel_pad} k=20 windowed: "
        f"kernel {kernel_ms:.2f} / {kernel_ms_2:.2f} ms, plain {plain_ms:.2f} ms ({smi})")
    del kin

    # ---- phase 4: the main path
    model = GPModel.from_numpy(
        w["grid"], w["mu"], w["M"], w["log_omega"],
        w["log_c_0"], w["log_tau_0"], w["log_beta"], device=device, dtype=torch.float32,
    )
    n_batches = -(-len(spectra) // BATCH)
    evidence.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res32 = process_spectra(
        model, samples.offset_samples, samples.nhi_samples, spectra, prior_z, prior_flags,
        params=params, batch_size=BATCH, dtype=torch.float32, backend="cuda",
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = evidence.launch_count
    if launches != n_batches:
        fail(f"{launches} kernel launches for {n_batches} batches")
    if res32.sample_log_likelihoods_dla.shape != (len(spectra), len(samples.offset_samples)):
        fail(f"sample matrix has shape {res32.sample_log_likelihoods_dla.shape}")
    if not np.isfinite(res32.p_dlas).all() or not np.isfinite(res32.sample_log_likelihoods_dla).all():
        fail("non-finite evidences or p_DLA on the main path")
    rate = len(spectra) / seconds
    kernel_share = launches * kernel_ms / 1e3 / seconds
    say(f"phase 4: process_spectra(cuda, float32): {len(spectra)} spectra x "
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

    # ---- phase 5: results
    say(json.dumps({"kernels": [{
        "name": "evidence_single_f32",
        "route": "cuda",
        "source": "gp_dla_detection_tpu_torch/csrc/evidence.cu",
        "replaces": "gp_dla_detection_tpu/ops/evidence_pallas.py:106",
        "launches": launches,
        "max_abs_err": worst[1],
        "max_normalized_err": worst[0],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "spectra_per_s": rate,
        "card": smi,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
