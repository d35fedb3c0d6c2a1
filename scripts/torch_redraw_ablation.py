#!/usr/bin/env python3
"""Where the base redraw kernel's time goes: time variants of
``gp_dla_detection_tpu_torch/csrc/redraw.cu`` with one part of the work
removed, on one GPU.

    python3 scripts/torch_redraw_ablation.py [--source redraw.cu] [--reps 20]
                                             [--variants full,no_cells,...]
                                             [--grids 20000,40000,58015]

The inputs are the fused lean chain's own, as chip_smoke.py times the
kernel: the first base redraw call (its (B, 10,000) float32 sample log
likelihoods, its kvec and its grid, 2,512 at R = 4) of phase 6's chain
on its synthetic spectra at B = 128, and of phase 10's on the bench's
driver workload at B = 1024.  ``--grids`` adds, per grid listed, 256
seeded random rows of 3,001 samples and a kvec of 6,003 positions on
that grid (grids above 29,007 take the division path).

Each variant is the kernel's source with one edit (below), built with the
port's nvcc flags into a temporary directory and loaded in place of the
port's library; ``inverse_cdf_grid`` is timed on both, two rounds in
turn, queued behind a spin kernel (the card's time) and as
``chip_smoke.cuda_ms`` times it (the host's issue of each call included
where it is the longer).  A variant computes wrong draws: only its time
means something.  The full kernel's CDF is held bit for bit to
``posterior_cdf_in_kernel_order`` and its draws to the grid counts of
that CDF.  ``--source`` takes another version of the kernel with the
same C interface, e.g. the three-sweep design from git history (``git
show <rev>:gp_dla_detection_tpu_torch/csrc/redraw.cu``).  Needs a CUDA
device and nvcc.

Variants (each design names its own anchors):
  full            the kernel as it is
  no_max          no row max (the max pass, or the block's max reduction)
  no_total_sweep  no sweep for the row total alone (the three-sweep
                  design; the one-pass design has none to remove)
  no_cells        no grid-cell correction steps (the rounded guess alone:
                  the divisions, or the table lookups)
  no_histogram    no histogram atomics and no prefix sum of it (the
                  cells are still computed)
  no_output       no output gather (no kvec read, no int64 stores)
  global_table    not a part removed, the alternative to the two cell
                  paths: every grid's boundaries in one table in device
                  memory, filled by a small kernel once per grid, read
                  through L1 (no shared table, no divisions in the cells)
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
SOURCE = REPO / "gp_dla_detection_tpu_torch" / "csrc" / "redraw.cu"
S, P, K, B = 10000, 1274, 20, 1024

# (anchor, its replacement) per variant, per design of the kernel
DESIGNS = {
    "three-sweep": {
        "no_max": [("  for (int i = threadIdx.x; i < S; i += kThreads) {\n    const float x = row[i];",
                    "  for (int i = threadIdx.x; i < 0; i += kThreads) {\n    const float x = row[i];")],
        "no_total_sweep": [(
            "  const float total = scan_row<false>(row, S, rowmax, uniform, 0.0f, buf, warp_total,\n"
            "                                      &carry_slot, nullptr, nullptr, s, 0.0f);",
            "  const float total = 1.0f;")],
        "no_cells": [("  for (int step = 0; step < 2; ++step) {",
                      "  for (int step = 0; step < 0; ++step) {")],
        "no_histogram": [("              if (count) atomicAdd(&hist[cur], count);\n", ""),
                         ("      if (count) atomicAdd(&hist[cur], count);",
                          "      if (count == -1) hist[0] = cur;"),   # keeps the cells
                         ("  const int chunk = (s + kThreads - 1) / kThreads;",
                          "  const int chunk = 0;")],
        "no_output": [("  for (int j = threadIdx.x; j < J; j += kThreads) {",
                       "  for (int j = threadIdx.x; j < 0; j += kThreads) {")],
    },
    "one-pass": {
        "no_max": [("  mx = block_max(mx, sh.red);", "  mx = 0.0f;\n  __syncthreads();")],
        "no_cells": [("  for (int step = 0; step < 2; ++step) {",
                      "  for (int step = 0; step < 0; ++step) {")],
        "no_histogram": [("            atomicAdd(&hist[cur], count);\n", ""),
                         ("    warp_add(hist, head_cell, head_count);\n    warp_add(hist, cur, count);",
                          "    if (count == -1) hist[0] = cur + head_cell + head_count;"),
                         ("  const int chunk = (s + nthreads - 1) / nthreads;",
                          "  const int chunk = 0;")],
        "no_output": [("  const int pairs = (J - head) / 2;", "  const int pairs = 0;")],
        "global_table": [
            ("constexpr unsigned kFull = 0xffffffffu;\n",
             "constexpr unsigned kFull = 0xffffffffu;\n"
             "__device__ float g_cells[1 << 16];   // (k + 0.5) / s of the last grid filled\n"
             "__global__ void fill_cells(int s) {\n"
             "  const int k = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (k < s) g_cells[k] = __fdiv_rn(__fadd_rn(float(k), 0.5f), float(s));\n"
             "}\n"),
            ("kTable ? table[m - 1]", "kTable ? __ldg(table + m - 1)"),
            ("kTable ? table[m] :", "kTable ? __ldg(table + m) :"),
            ("  float* table = reinterpret_cast<float*>(smem + s + 1);   // s boundaries (kTable)",
             "  const float* table = g_cells;"),
            ("    if (kTable)\n      for (int i = tid; i < s; i += nthreads)\n"
             "        table[i] = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), sf);\n", ""),
            ("  const bool table = counts && (8 * long(s) + 4 <= shared_room(dev));",
             "  const bool table = counts;"),
            (" + (table ? long(sizeof(float)) * s : 0)", ""),
            ("  const int n_tiles = (S + kTile - 1) / kTile;\n  const int threads =",
             "  static int filled = 0;   // the grid in g_cells\n"
             "  if (table && s != filled) {\n"
             "    fill_cells<<<(s + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(s);\n"
             "    filled = s;\n"
             "  }\n"
             "  const int n_tiles = (S + kTile - 1) / kTile;\n  const int threads ="),
        ],
    },
}


def variants(src: str, wanted: list[str] | None = None) -> tuple[str, dict[str, str]]:
    """The design whose anchors the source holds, and its variants
    (``wanted``: those alone; "full" needs no design)."""
    design, edits = next(((d, e) for d, e in DESIGNS.items()
                          if all(a in src for edit in e.values() for a, _ in edit)),
                         ("no design's anchors", {}))
    out = {}
    for name in wanted or ["full", *edits]:
        if name != "full" and name not in edits:
            sys.exit(f"no variant {name} for this source; update this script's DESIGNS")
        text = src
        for anchor, repl in edits.get(name, []):
            text = text.replace(anchor, repl)
        out[name] = text
    return design, out


def first_redraw_call(run):
    """(sll, kvec, grid) of the first base redraw call that ``run()``
    makes, on the card."""
    import torch

    from gp_dla_detection_tpu_torch.parallel import sharded_multi

    real = sharded_multi.device_inverse_cdf_grid
    calls = []

    def spy(sll, kvec, grid_size=None):
        calls.append((sll.clone(), kvec.clone(), grid_size))
        return real(sll, kvec, grid_size)

    sharded_multi.device_inverse_cdf_grid = spy
    try:
        run()
    finally:
        sharded_multi.device_inverse_cdf_grid = real
    torch.cuda.synchronize()
    sll, kvec, grid = calls[0]
    return sll, kvec, sll.shape[1] if grid is None else grid


def grid_inputs(grids: list[int]) -> list:
    """Per grid, 256 seeded random rows of 3,001 float32 samples and a
    kvec of 6,003 positions on it, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(-50.0, 4.0, (256, 3001)).astype(np.float32), device="cuda")
    return [("B=256 S=3001", (x, torch.as_tensor(rng.integers(0, g, 6003), device="cuda"), g))
            for g in grids]


def chain_inputs(cs) -> dict:
    """The redraw's inputs by batch: at B = 128 chip_smoke.py phase 6's
    (the first batch of the fused chain on its 512 synthetic spectra, a
    DLA in every other, a second in every fourth), at B = 1024 phase 10's
    (the chain's one batch of 1024 on the bench's driver workload)."""
    import dataclasses

    from gp_dla_detection_tpu_torch import bench
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.parallel import sharded_multi
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import ShardedRunConfig

    w, params, samples, spectra, prior_z, prior_flags = cs.build_workload(0, cs.N_SPECTRA)
    spectra2 = dataclasses.replace(spectra, flux=cs.inject_second_dlas(w, params, 0))
    model = GPModel.from_numpy(w["grid"], w["mu"], w["M"], w["log_omega"], w["log_c_0"],
                               w["log_tau_0"], w["log_beta"])
    work = bench.driver_workload(B, S, P, K)
    return {
        f"B={cs.BATCH}": first_redraw_call(lambda: sharded_multi.process_spectra_multi_lean(
            model, samples.offset_samples, samples.nhi_samples, spectra2, prior_z,
            prior_flags.astype(int), params=params, batch_size=cs.BATCH)),
        f"B={B}": first_redraw_call(lambda: sharded_multi.process_spectra_multi_sharded(
            work.model, work.offsets, work.nhis, work.spectra, work.prior_z, work.prior_num,
            config=ShardedRunConfig(per_device_batch=B, dtype="float32",
                                    store_sample_likelihoods=False))),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default=None, help="comma-separated (default: all)")
    ap.add_argument("--grids", default="", help="comma-separated grids of random rows to add")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on a GPU")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gp_dla_detection_tpu_torch import _build
    from gp_dla_detection_tpu_torch.ops import redraw

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    design, texts = variants(args.source.read_text(),
                             args.variants.split(",") if args.variants else None)
    print(f"{smi}; {args.source} ({design} design)", flush=True)
    inputs = list(chain_inputs(cs).items())   # with the port's own library
    inputs += grid_inputs([int(g) for g in args.grids.split(",") if g])

    with tempfile.TemporaryDirectory(prefix="redraw_ablation_") as tmp:
        def build(item):
            name, text = item
            src = Path(tmp) / f"{name}.cu"
            src.write_text(text)
            lib = Path(tmp) / f"lib{name}.so"
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode:
                sys.exit(f"nvcc failed on the {name} variant:\n{proc.stderr[-4000:]}")
            return name, (lib, proc.stdout + proc.stderr)

        with ThreadPoolExecutor(8) as ex:
            libs = dict(ex.map(build, texts.items()))
        print(f"full: {cs.ptxas_usage(libs['full'][1])}", flush=True)

        port_library = redraw._kernel_library
        try:
            for rnd in range(2):
                for name, (path, _) in libs.items():
                    built = redraw._bind_library(
                        _build.BuiltLibrary(ctypes.CDLL(str(path)), path, 0.0, ""))
                    redraw._kernel_library = lambda built=built: built
                    redraw._max_grid.cache_clear()
                    if name == "full" and rnd == 0:
                        for n, (sll, kvec, grid) in inputs:
                            cdf = redraw.posterior_cdf(sll)
                            emulated = redraw.posterior_cdf_in_kernel_order(sll)
                            same_draws = torch.equal(
                                redraw.inverse_cdf_grid(sll, kvec, grid),
                                redraw.grid_counts_reference(emulated, grid)[:, kvec])
                            print(f"full, {n} grid {grid}: CDF bit for bit equal to "
                                  f"posterior_cdf_in_kernel_order {torch.equal(cdf, emulated)} "
                                  f"({int((cdf != emulated).sum())} entries differ); draws "
                                  f"equal to its grid counts {same_draws}; max grid "
                                  f"{redraw.max_grid_size(sll.device)}", flush=True)
                    times = []
                    for n, (sll, kvec, grid) in inputs:
                        call = lambda: redraw.inverse_cdf_grid(sll, kvec, grid)
                        times.append(f"{n} grid {grid}: {cs.queued_ms(call, args.reps):.4f} ms "
                                     f"queued, {cs.cuda_ms(call, args.reps):.4f} ms with the "
                                     f"host's issue")
                    print(f"round {rnd}: {name}: {'; '.join(times)} ({smi})", flush=True)
        finally:
            redraw._kernel_library = port_library
            redraw._max_grid.cache_clear()


if __name__ == "__main__":
    main()
