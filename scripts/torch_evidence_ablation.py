#!/usr/bin/env python3
"""Where the CUDA evidence kernel's time goes: time variants of
``gp_dla_detection_tpu_torch/csrc/evidence.cu`` with one part of the work
removed, on one GPU.

    python3 scripts/torch_evidence_ablation.py [--batch 128] [--reps 3]
                                               [--source evidence.cu]
                                               [--variants full,producers_idle,...]

Each variant is the kernel's source with one edit (below), built with the
port's nvcc flags into a temporary directory and loaded in place of the
port's library; the single configuration and the pair configuration at
R = 4 are timed (CUDA events) at the main path's shapes (chip_smoke.py's
synthetic workload: B = 128, S = 10,000, P = 1274, k = 20, 3 lines,
windowed), two rounds in turn.  ``--source`` takes another version of
the kernel with the same C interface (e.g. one from git history),
``--variants`` a few of the variants.  A variant computes wrong
evidences: only its time means something.  The difference between the
full kernel and a variant is an upper bound on what the removed part
costs, since the rest may then overlap differently.  Needs a CUDA device
and nvcc.

Variants:
  full                 the kernel as it is
  producers_idle       no Voigt lines and no convolution/weights pass
                       (exp, staging and the synchronisation stay)
  consumers_idle       no table copy and no MMAs
  no_table_copy        the consumers copy no coefficient table into
                       shared memory (the prologue still builds it)
  one_mma              1xTF32 (hi*hi) instead of 3xTF32
  no_lines             no Voigt lines (optical depth 0)
  no_weights           no convolution/weights pass
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "gp_dla_detection_tpu_torch" / "csrc" / "evidence.cu"

LINES = ("      for (int l = 0; l < num_lines; ++l) {\n"
         "        const float mult = sh.mult[l * TILE + s];")
WEIGHTS = "    for (int p0 = plo; p0 < phi; p0 += U) {"
COPY = "    for (int i = ct; i < CHUNK4; i += CONSUMERS) cp_async16(dst + i, src + i);"
KLOOP = "#pragma unroll 1\n    for (int k0 = 0; k0 < CHUNK; k0 += 8) {"
MMA3 = ("          mma_tf32(acc[mt][j], a_lo[mt], b0h, b1h);   // small terms first\n"
        "          mma_tf32(acc[mt][j], a_hi[mt], b0l, b1l);\n"
        "          mma_tf32(acc[mt][j], a_hi[mt], b0h, b1h);")


def variants(src: str, wanted: list[str] | None = None) -> dict[str, str]:
    for anchor in (LINES, WEIGHTS, COPY, KLOOP, MMA3):
        if anchor not in src:
            sys.exit(f"the kernel source changed; update this script's anchor:\n{anchor}")
    no_lines = lambda s: s.replace(LINES, LINES.replace("l < num_lines", "l < 0"))
    no_weights = lambda s: s.replace(WEIGHTS, WEIGHTS.replace("p0 < phi", "p0 < plo"))
    no_copy = lambda s: s.replace(COPY, COPY.replace("i < CHUNK4", "i < 0"))
    out = {
        "full": src,
        "producers_idle": no_weights(no_lines(src)),
        "consumers_idle": no_copy(src.replace(KLOOP, KLOOP.replace("k0 < CHUNK", "k0 < 0"))),
        "no_table_copy": no_copy(src),
        "one_mma": src.replace(MMA3, MMA3.splitlines()[-1]),
        "no_lines": no_lines(src),
        "no_weights": no_weights(src),
    }
    for name in wanted or ():
        if name not in out:
            sys.exit(f"no variant {name}; the variants are {', '.join(out)}")
    return {name: out[name] for name in wanted} if wanted else out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--variants", default=None, help="comma-separated (default: all)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on a GPU")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gp_dla_detection_tpu_torch import _build
    from gp_dla_detection_tpu_torch.inference import compute_sample_window
    from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern
    from gp_dla_detection_tpu_torch.ops import evidence

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"{smi}; {args.source}", flush=True)
    supported = evidence.supported_k()   # builds the port's own library once

    with tempfile.TemporaryDirectory(prefix="evidence_ablation_") as tmp:
        def build(item):
            name, text = item
            src = Path(tmp) / f"{name}.cu"
            src.write_text(text)
            lib = Path(tmp) / f"lib{name}.so"
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode:
                sys.exit(f"nvcc failed on the {name} variant:\n{proc.stderr[-4000:]}")
            return name, lib

        with ThreadPoolExecutor(8) as ex:
            wanted = args.variants.split(",") if args.variants else None
            libs = dict(ex.map(build, variants(args.source.read_text(), wanted).items()))

        device = torch.device("cuda", 0)
        w, params, samples, *_ = cs.build_workload(0, args.batch)
        order = np.argsort(samples.offset_samples, kind="stable")
        offsets, nhis = samples.offset_samples[order], samples.nhi_samples[order]
        S = len(offsets)
        P6 = params.pixel_pad + 2 * params.instrument.width
        window = compute_sample_window(offsets, evidence.SAMPLE_TILE, P6)
        rl = cs.load_roofline()
        kin, _ = rl.kernel_inputs(w, params, offsets, nhis, args.batch, device, torch.float32)
        draw_idx, n_draws = replicate_draw_pattern(S, evidence.PATTERN_TILE, 4)
        rng = np.random.default_rng(3)
        cols = torch.as_tensor(
            np.stack([rng.permutation(S)[:n_draws][draw_idx] for _ in range(args.batch)]),
            device=device,
        )
        z2, n2 = kin[7].gather(1, cols).contiguous(), kin[8].gather(1, cols).contiguous()

        port_library = evidence._kernel_library
        evidence.supported_k = lambda: supported
        try:
            for rnd in range(2):
                for name, path in libs.items():
                    built = evidence._bind_library(
                        _build.BuiltLibrary(ctypes.CDLL(str(path)), path, 0.0, ""))
                    evidence._kernel_library = lambda built=built: built
                    single = cs.cuda_ms(lambda: evidence.sample_log_likelihoods(*kin, window=window),
                                        args.reps)
                    pair = cs.cuda_ms(lambda: evidence.sample_log_likelihoods_pair(
                        *kin, z2, n2, window=window, base_replicates=4), args.reps)
                    print(f"round {rnd}: {name}: single {single:.2f} ms, pair R=4 {pair:.2f} ms "
                          f"(B={args.batch}, S={S}, P={params.pixel_pad}, k=20, 3 lines, "
                          f"windowed; {smi})", flush=True)
        finally:
            evidence._kernel_library = port_library


if __name__ == "__main__":
    main()
