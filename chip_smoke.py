#!/usr/bin/env python3
"""Drive the PyTorch port's inference paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:

1. find the card (a CUDA device is required; nothing runs on the CPU)
   and print its name and power limit as nvidia-smi reports them;
2. build the evidence kernel (csrc/evidence.cu) with nvcc;
3. hold the kernel's single-absorber configuration against its plain
   PyTorch version on the card at the production shapes (P = 1274 px,
   k = 20, S = 10,000 samples, 3 lines, windowed and full grid, plus a
   31-line case) to 5e-5 normalized error, and against the float64 plain
   path; time both versions at the main path's batch shape;
4. run ``inference.process_spectra(backend="cuda", dtype=float32)`` on a
   few hundred synthetic spectra with the 10,000-sample QMC set, check
   that every batch launched the kernel and every p_DLA is finite, and
   hold a subset to the float64 plain path with the catalog decision
   gate (no flips at p = 0.9 outside +-0.01, |dp| p99 < 1e-3);
5. hold the kernel's two-DLA pair configuration against its plain
   version in the same way: the fresh axis z-sorted (windowed and full
   grid), the base axis per-spectrum posterior-like draws in the R = 4
   layout of the 256-column tile, 3 and 31 lines; time both at B = 128;
6. run the fused lean two-stage {0,1,2}-DLA chain
   ``parallel.sharded_multi.process_spectra_multi_lean(backend="cuda",
   dtype=float32)`` at its default R = 4 on the same spectra with a
   second DLA in every fourth one: one single and one pair launch per
   batch, the R = 4 pattern on the base redshifts the pair kernel
   receives, finite evidences, posteriors that sum to 1, NaN pair
   evidence only where a row has no valid pair; then at R = 1, holding a
   subset against the classic driver on the float64 plain path (no
   decision flips where the float64 winner's posterior exceeds 0.91,
   pair evidences within rtol 5e-4 / atol 5e-3);
7. print a JSON line describing both kernel configurations and, last, a
   JSON line with the device.

Weights and data are random, made from ``--seed`` with numpy.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
PAIR_RTOL, PAIR_ATOL = 5e-4, 5e-3   # pair evidence, f32 lean vs f64 classic
                                    # (tests/test_lean_multi.py:234-238)


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

    from gp_dla_detection_tpu.params import LYA_WAVELENGTH, LYMAN_LIMIT
    from gp_dla_detection_tpu_torch.ops.voigt import extend_wavelengths, voigt_absorption

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

    # ---- phase 5: the pair configuration vs its plain version
    from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern

    S = len(offsets)
    draw_idx, n_draws = replicate_draw_pattern(S, 256, 4)
    rng = np.random.default_rng(args.seed + 3)

    def pair_draws(kin, n):
        """Per-spectrum base (z, N_HI): a seeded permutation of the
        samples in the R = 4 layout, as the lean chain lays out posterior
        draws on the z-sorted pair columns."""
        draws = np.stack([rng.permutation(S)[:n_draws][draw_idx] for _ in range(n)])
        cols = torch.as_tensor(draws, device=device)
        return kin[7].gather(1, cols).contiguous(), kin[8].gather(1, cols).contiguous()

    pair_worst = (0.0, 0.0)
    for num_lines, n_cmp, windows in ((3, 4, (window, None)), (31, 2, (None, window))):
        kin, kparams = kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float32, num_lines)
        z2, n2 = pair_draws(kin, n_cmp)
        for win in windows:
            out = evidence.sample_log_likelihoods_pair(
                *kin, z2, n2, num_lines=num_lines, instrument=kparams.instrument, window=win
            )
            torch.cuda.synchronize()
            ref = evidence.sample_log_likelihoods_pair_reference(
                *kin, z2, n2, num_lines=num_lines, instrument=kparams.instrument, window=win
            )
            err = normalized_error(out, ref)
            say(f"phase 5: pair, {num_lines} lines, window={win}, B={n_cmp}, S={S}: "
                f"kernel vs plain f32 normalized {err[0]:.3e}, abs {err[1]:.3e}")
            if not err[0] < NORMALIZED_BOUND:
                fail(f"pair kernel disagrees with its plain version: {err[0]:.3e} >= {NORMALIZED_BOUND}")
            pair_worst = max(pair_worst, err)
            if num_lines == 3 and win == window:
                kin64, _ = kernel_inputs(w, params, offsets, nhis, n_cmp, device, torch.float64)
                ref64 = evidence.sample_log_likelihoods_pair_reference(
                    *kin64, z2.double(), n2.double(), instrument=kparams.instrument,
                    window=None, sample_chunk=500,
                )
                err64 = normalized_error(out, ref64)
                say(f"phase 5: pair kernel vs plain f64 (accurate Faddeeva, full grid) "
                    f"normalized {err64[0]:.3e}, abs {err64[1]:.3e}")
                if not err64[0] < F64_BOUND:
                    fail(f"pair kernel disagrees with the float64 path: {err64[0]:.3e} >= {F64_BOUND}")
    kin, kparams = kernel_inputs(w, params, offsets, nhis, BATCH, device, torch.float32)
    z2, n2 = pair_draws(kin, BATCH)
    run_pair = lambda: evidence.sample_log_likelihoods_pair(*kin, z2, n2, window=window)
    run_pair_plain = lambda: evidence.sample_log_likelihoods_pair_reference(*kin, z2, n2, window=window)
    pair_ms = cuda_ms(run_pair, 5)
    pair_plain_ms = cuda_ms(run_pair_plain, 2)
    pair_ms_2 = cuda_ms(run_pair, 5)
    single_ms_same_call = cuda_ms(lambda: evidence.sample_log_likelihoods(*kin, window=window), 5)
    say(f"phase 5 ok: B={BATCH} S={S} P={params.pixel_pad} k=20 windowed pair: kernel "
        f"{pair_ms:.2f} / {pair_ms_2:.2f} ms, plain {pair_plain_ms:.2f} ms; single kernel "
        f"{single_ms_same_call:.2f} ms in the same call ({smi})")
    del kin, z2, n2

    # ---- phase 6: the fused lean two-stage chain
    import gp_dla_detection_tpu_torch.parallel.sharded_multi as sharded_multi
    from gp_dla_detection_tpu_torch.multi_dla import process_spectra_multi

    spectra2 = dataclasses.replace(spectra, flux=inject_second_dlas(w, params, args.seed))
    prior_num = np.where(prior_flags, rng.choice([1, 1, 1, 2], len(prior_flags)), 0)

    # observe what the pair kernel receives and what the pair reduction
    # sees, without changing either
    seen = {"pattern_ok": [], "has_valid": []}
    kernel_pair = evidence.sample_log_likelihoods_pair
    reduce_pair = sharded_multi.pack_lean_pair

    def pair_spy(*a, **kw):
        z2_cols = a[9]
        full = z2_cols.shape[1] // 256 * 256
        tiles = z2_cols[:, :full].reshape(z2_cols.shape[0], -1, 4, 64)
        seen["pattern_ok"].append(bool(full) and bool((tiles == tiles[:, :, :1]).all()))
        return kernel_pair(*a, **kw)

    def reduce_spy(pair_lls, base_inds):
        seen["has_valid"].append(torch.isfinite(pair_lls).any(dim=1))
        return reduce_pair(pair_lls, base_inds)

    def lean(R, spy):
        evidence.sample_log_likelihoods_pair = pair_spy if spy else kernel_pair
        sharded_multi.pack_lean_pair = reduce_spy if spy else reduce_pair
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sharded_multi.process_spectra_multi_lean(
                model, samples.offset_samples, samples.nhi_samples, spectra2, prior_z, prior_num,
                params=params, batch_size=BATCH, dtype=torch.float32, backend="cuda",
                base_replicates=R,
            )
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            evidence.sample_log_likelihoods_pair = kernel_pair
            sharded_multi.pack_lean_pair = reduce_pair

    # the main path, timed, with nothing observing it
    evidence.launch_count = 0
    evidence.pair_launch_count = 0
    lean4, lean_s = lean(None, spy=False)
    lean_launches = (evidence.launch_count, evidence.pair_launch_count)
    if lean_launches != (n_batches, n_batches):
        fail(f"lean chain: {lean_launches} (single, pair) launches for {n_batches} batches")
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
    say(f"phase 6: process_spectra_multi_lean(cuda, float32, R=4): {len(spectra2)} spectra x "
        f"{S} samples in {lean_s:.3f} s = {lean_rate:.1f} spectra/s; launches (single, pair) "
        f"{lean_launches} for {n_batches} batches; launches x phase-5 kernel ms = "
        f"{n_batches * (single_ms_same_call + pair_ms) / 1e3 / lean_s:.2f} of the wall time; "
        f"R=4 layout held on every batch; 3-class picks {picks.tolist()}; rows without a "
        f"valid pair {int((~has_valid).sum())} ({smi})")

    evidence.launch_count = 0
    evidence.pair_launch_count = 0
    lean1, lean1_s = lean(1, spy=False)
    say(f"phase 6: R=1: {len(spectra2)} spectra in {lean1_s:.3f} s = "
        f"{len(spectra2) / lean1_s:.1f} spectra/s; launches "
        f"{(evidence.launch_count, evidence.pair_launch_count)}")
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

    # ---- phase 7: results
    say(json.dumps({"kernels": [
        {
            "name": "evidence_single_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/evidence.cu",
            "replaces": "gp_dla_detection_tpu/ops/evidence_pallas.py:106",
            "launches": lean_launches[0],
            "launches_process_spectra": launches,
            "max_abs_err": worst[1],
            "max_normalized_err": worst[0],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "spectra_per_s": rate,
            "card": smi,
        },
        {
            "name": "evidence_pair_f32",
            "route": "cuda",
            "source": "gp_dla_detection_tpu_torch/csrc/evidence.cu",
            "replaces": "gp_dla_detection_tpu/ops/evidence_pallas.py:106",
            "launches": lean_launches[1],
            "max_abs_err": pair_worst[1],
            "max_normalized_err": pair_worst[0],
            "ms": pair_ms,
            "plain_ms": pair_plain_ms,
            "lean_chain_spectra_per_s": lean_rate,
            "card": smi,
        },
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
