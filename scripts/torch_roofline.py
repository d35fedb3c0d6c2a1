"""The port's kernels against the card's measured ceilings.

The counterpart of ``validation/roofline.py``.  On one NVIDIA GPU it

1. measures the ceilings of the op classes the port's kernels use, with
   the microbenchmarks of ``gp_dla_detection_tpu_torch/csrc/roofline.cu``
   (built by ``_build.load_library`` at first use): the FP32 FMA rate,
   ``expf``, ``logf``, ``__fdiv_rn`` and the evidence kernel's branchless
   division, ``mma.sync.m16n8k8`` TF32 with its operands in registers
   (3xTF32 is a third of it), the FP64 FMA rate and the device-memory
   read bandwidth over a buffer many times the 50 MB L2; beside them, as
   *library* yardsticks, one ``torch.matmul`` at 4096^2 in FP32 with
   TF32 off and in FP64.  Each microbenchmark's output is held to the
   same chain computed with torch ops on the card (a chain the compiler
   emptied gives another value), and each rate to 1.05x the published
   peak where one exists; ``nvidia-smi``'s SM clock, power draw, power
   limit and temperature are read beside each timed window;
2. times the port's five kernels at the production shapes (B = 1024, S =
   10,000, P = 1274, k = 20, 3 lines, windowed; CUDA events behind a spin
   kernel, after a warm-up): the single-absorber evidence, the pair at
   R = 1 and R = 4, the base redraw, the CDDF sums and the null evidence;
3. places each against one op model of its work (``evidence_work``,
   ``redraw_work``, ``cddf_work``, ``null_work``: FP32 operations, expf,
   logf and divisions as classes of their own, tensor-core FLOPs, FP64
   operations and bytes, each constant annotated with the code it counts,
   the unpadded grid counted): the share of the bound at the published
   peaks (the headline, as before), the share of the bound at the
   measured ceilings with the class that bounds it, and the JAX
   harness's composite (the class times summed, no overlap).

The op model, the published-peak bounds, the ceilings and the placing
of a kernel against them (``kernel_row``) live here once;
``chip_smoke.py`` loads this file by path and places its own B = 1024
times and inputs with them (step 2 is this script's).  Not ported: the JAX
harness's tunnel-epoch probe and its compile cache.

Run:  python scripts/torch_roofline.py [--out runs/roofline.json]
The card only (about a minute): without one it exits non-zero.  The
script ends with a ``ROOFLINE {json}`` line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# ---------------------------------------------------------------------------
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12     # 80 GB HBM3
FP32_OPS_PER_S = 33.5e12      # 67 TFLOP/s outside the tensor cores, an FMA
                              # counted as two: 33.5e12 FP32 instructions/s
TF32_FLOPS_PER_S = 495e12     # TF32 on the tensor cores
FP64_OPS_PER_S = 17e12        # 34 TFLOP/s FP64 outside the tensor cores
FP32_FLOPS_PER_S = 67e12      # the FP32 matmul's peak (no tensor cores)
FP64_TC_FLOPS_PER_S = 67e12   # FP64 on the tensor cores (the FP64 matmul)
# special-function unit results (MUFU: ex2, lg2, rcp): 16 a clock per SM
# (the Hopper architecture white paper), 132 SMs at the 1.98 GHz boost
# clock; expf, logf and both divisions need one each, or more FP32 work
SFU_PER_S = 16 * 132 * 1.98e9

# ---------------------------------------------------------------------------
# the op model: one count of each kernel's work per op class
# ---------------------------------------------------------------------------

CLASSES = ("fp32", "expf", "logf", "fdiv_rn", "fdiv_nobranch", "tf32_mma", "fp64", "bytes")
# the microbenchmark whose rate bounds each class on the card
CLASS_CEILING = {
    "fp32": "ffma", "expf": "expf", "logf": "logf", "fdiv_rn": "fdiv_rn",
    "fdiv_nobranch": "fdiv_nobranch", "tf32_mma": "mma_tf32", "fp64": "dfma",
    "bytes": "read_bandwidth",
}

# csrc/evidence.cu, per line at one (sample, extended pixel), the
# multiply-adds fused (__fmaf_rn, one instruction each):
VOIGT_FP32_PER_LINE = 19   # subtract_line: x 3 (mul, sub, mul: the plain
                           # version's roundings), x^2 1; g_function 14 without
                           # its division (1 + x^2 a 1 fma, 12 Horner fmas over
                           # the 13 coefficients, the closing mul 1); the wing
                           # into the sum 1 (fma by the line's factor)
VOIGT_DIV_PER_LINE = 1     # g_function's s = 1 / (1 + x^2 a): div_rn_nobranch
CORE_FP32_PER_LINE = 5     # exp_core where the core is added: 2 x^2 - 1 (fma),
                           # 1 + y^2 (...) (fma), min(x^2, 90) (its negation
                           # folded), times the exp (mul); into the sum (fma)
CORE_EXP_PER_LINE = 1      # exp_core's expf(-min(x^2, 90))
RAW_FP32 = 2               # nhi t(z) (mul) and one more (as the published-peak
                           # bounds have always counted it)
RAW_EXP = 1                # raw = expf(nhi t(z)) at every (sample, extended pixel)
PAIR_RAW_FP32 = 2          # the pair's nhi2 t(z2): an fma, the base row's read
# csrc/evidence.cu, per (sample, output pixel): the 7-tap convolution
# (taps mul, then 6 fmas: halo + 1 with halo = P6 - P), and the weights
# (16): dd 2 (mul, fma), d_safe 2, inv_d 1 division (div_rn_nobranch),
# yc 1 (fma), w 2, u 2, quad 2, the log term 1 mul + 1 logf, the two sums
# 2 (each U pixels' terms added in pairs, then into the running sum)
WEIGHTS_FP32 = 14
WEIGHTS_DIV = 1
WEIGHTS_LOG = 1
# Left out, as before: the line multipliers' two __fdiv_rn per (sample,
# line) (csrc/evidence.cu:220; 6 per sample at 3 lines against ~4e5
# element operations) and the sample's k = 20 Cholesky (~k^3/3 + 3 k^2
# per sample, ~1 % of the FP32 work).


def evidence_work(B, S, P, P6, k, num_lines, window, pair, distinct_base) -> dict:
    """One evidence call's work per op class (``CLASSES``), counted from
    the shapes on the unpadded grid: the fresh axis's Voigt at every
    (sample, extended pixel), the core on ``window`` of them a line (all
    without one), the base axis once per (distinct draw, extended pixel)
    in the pair, exp at every (sample, extended pixel), the convolution
    and the weights at every (sample, pixel), the Gram and projection on
    the tensor cores in 3xTF32 (three TF32 products per multiply-add),
    each input read and each output written once.  Also, for the JAX
    harness's op model: ``gram_flops`` (one pass of the pair-product
    Gram) and ``cholesky_flops``."""
    L, halo = num_lines, P6 - P
    core = 1.0 if window is None else min(1.0, window / P6)
    el6, el = B * S * P6, B * S * P
    w = dict.fromkeys(CLASSES, 0.0)
    w["fp32"] = el6 * (L * (VOIGT_FP32_PER_LINE + CORE_FP32_PER_LINE * core) + RAW_FP32)
    w["fdiv_nobranch"] = el6 * L * VOIGT_DIV_PER_LINE
    w["expf"] = el6 * (L * CORE_EXP_PER_LINE * core + RAW_EXP)
    w["fp32"] += el * ((halo + 1) + WEIGHTS_FP32)
    w["fdiv_nobranch"] += el * WEIGHTS_DIV
    w["logf"] = el * WEIGHTS_LOG
    if pair:
        base = B * distinct_base * P6 * L
        w["fp32"] += base * (VOIGT_FP32_PER_LINE + CORE_FP32_PER_LINE) + el6 * PAIR_RAW_FP32
        w["fdiv_nobranch"] += base * VOIGT_DIV_PER_LINE
        w["expf"] += base * CORE_EXP_PER_LINE
    n_tri = k * (k + 1) // 2
    w["tf32_mma"] = 3 * 2 * (n_tri + k) * el
    n_sample_arrays = 4 if pair else 2
    w["bytes"] = 4 * (B * P6 + 5 * B * P + B * P * k + n_sample_arrays * B * S + B + B * S)
    w["gram_flops"] = 2 * n_tri * el
    w["cholesky_flops"] = B * S * (k**3 / 3 + 3 * k * k)
    return w


def published_times(work: dict) -> dict:
    """ms of each pipe at the published peaks: the FP32 pipe takes every
    FP32 operation, expf, logf and division as one operation each (the
    count behind every published-peak bound)."""
    fp32 = sum(work[c] for c in ("fp32", "expf", "logf", "fdiv_rn", "fdiv_nobranch"))
    return {
        "bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
        "FP32 pipe": fp32 / FP32_OPS_PER_S * 1e3,
        "TF32 tensor cores (3xTF32)": work["tf32_mma"] / TF32_FLOPS_PER_S * 1e3,
        "FP64 pipe": work["fp64"] / FP64_OPS_PER_S * 1e3,
    }


def evidence_bound(B, S, P, P6, k, num_lines, window, pair, distinct_base):
    """The least time the card could take for one evidence call at the
    published peaks: (ms, bounding pipe, {pipe: ms}).  The pipes run side
    by side, so the bound is the largest."""
    times = published_times(evidence_work(B, S, P, P6, k, num_lines, window, pair,
                                          distinct_base))
    del times["FP64 pipe"]
    pipe = max(times, key=times.get)
    return times[pipe], pipe, times


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(the least ms the card could take, "bytes" or "operations")."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / ops_per_s * 1e3}
    by = max(times, key=times.get)
    return times[by], by


# csrc/redraw.cu, per (row, sample): the subtract and expf of w_i (1 expf),
# the scan's add, the division c_i = (carry + x_i) / total (1 __fdiv_rn),
# the grid cell's multiply, add and floor and two correction steps
REDRAW_FP32 = 13
REDRAW_OPS = REDRAW_FP32 + 2   # FP32 operations per (row, sample), each one
# csrc/cddf.cu, per (row, sample): the eight channels' values (five
# products, a subtract, two compares) and adds, and acc's add
CDDF_OPS = 16


def redraw_work(B: int, S: int, J: int) -> dict:
    """The redraw kernel: sll read once (float32), kvec read once, the
    (B, J) int64 draws written once."""
    w = dict.fromkeys(CLASSES, 0.0)
    w.update(fp32=REDRAW_FP32 * B * S, expf=B * S, fdiv_rn=B * S,
             bytes=4 * B * S + 8 * J + 8 * B * J)
    return w


def cddf_work(B: int, S: int, n_bins: int) -> dict:
    """The CDDF sums: p, p2s, base and zloc (8 B each per (row, sample))
    and five (S,) tables read once, acc (B, S) and hist (B, 8, n_bins)
    float64 written once."""
    w = dict.fromkeys(CLASSES, 0.0)
    w.update(fp64=CDDF_OPS * B * S,
             bytes=8 * 4 * B * S + 8 * 5 * S + 8 * B * S + 8 * B * 8 * n_bins)
    return w


def null_work(B: int, P: int, k: int) -> dict:
    """The null evidence: y, mu, d (float32) and the mask (1 B) per pixel
    and M (k float32 per pixel) read once, B float32 written once; per
    pixel k (k + 1) / 2 + k multiply-adds (FP32, one operation each) and
    ~10 more for the weights and sums, of which w = 1 / d (__fdiv_rn) and
    log d (logf)."""
    w = dict.fromkeys(CLASSES, 0.0)
    w.update(fp32=B * P * (k * (k + 1) // 2 + k + 8), fdiv_rn=B * P, logf=B * P,
             bytes=B * P * (4 * 3 + 4 * k + 1) + 4 * B)
    return w


def _ops_bound(work: dict, ops_per_s: float) -> tuple[float, str]:
    ops = sum(work[c] for c in CLASSES if c != "bytes")
    return bound(work["bytes"], ops, ops_per_s)


def redraw_bound(B: int, S: int, J: int) -> tuple[float, str]:
    return _ops_bound(redraw_work(B, S, J), FP32_OPS_PER_S)


def cddf_bound(B: int, S: int, n_bins: int) -> tuple[float, str]:
    return _ops_bound(cddf_work(B, S, n_bins), FP64_OPS_PER_S)


def null_bound(B: int, P: int, k: int) -> tuple[float, str]:
    return _ops_bound(null_work(B, P, k), FP32_OPS_PER_S)


def measured_bound(work: dict, rates: dict) -> dict:
    """The bound at the measured ceilings: each class's time at its
    ceiling (``rates``: class -> operations, FLOPs or bytes a second; a
    tensor-core FLOP of the 3xTF32 count at the TF32 ``mma.sync`` rate),
    the largest of them (the classes run side by side) with its class,
    and the JAX harness's composite, their sum (no overlap)."""
    times = {c: work[c] / rates[c] * 1e3 for c in CLASSES if work[c]}
    by = max(times, key=times.get)
    return {"ms": times[by], "class": by, "class_ms": times,
            "composite_ms": sum(times.values())}


# ---------------------------------------------------------------------------
# the kernels' inputs at production shapes
# ---------------------------------------------------------------------------

def kernel_inputs(w, params, offsets, nhis, n, device, dtype, num_lines=3):
    """Prepared per-spectrum inputs of the evidence kernel for the first
    ``n`` spectra of a synthetic workload ``w`` (the port's own
    _prepare_spectrum), samples sorted."""
    import dataclasses

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


# ---------------------------------------------------------------------------
# the microbenchmarks (csrc/roofline.cu) and their plain versions
# ---------------------------------------------------------------------------

F32_OPS = {"ffma": 0, "expf": 1, "logf": 2, "fdiv_rn": 3, "fdiv_nobranch": 4}
ACC = 8                 # independent chains per thread (csrc/roofline.cu)
CHAIN_THREADS = 132 * 2048 * 2   # two full waves of an H100's 132 SMs
MMA_LANES = 132 * 2048           # one full wave of warps
READ_BYTES = 1 << 30             # 1 GiB: > 20x the 50 MB L2
READ_BLOCKS = 132 * 8
# the steps each chain runs for its check: the FMA and MMA chains move by
# well over CHECK_RTOL a step at 256; the expf, logf and division maps
# contract by 0.7-0.8 a step (chain_operands), so at 32 they are still in
# their transient and a chain 16 steps short is off by ~1e-2
CHECK_ITERS = {"ffma": 256, "expf": 32, "logf": 32, "fdiv_rn": 32, "fdiv_nobranch": 32,
               "dfma": 256, "mma_tf32": 256, "read_bandwidth": 0}
# steps of one timed launch (~5-30 ms each on an H100)
TIMED_ITERS = {"ffma": 65536, "expf": 8192, "logf": 8192, "fdiv_rn": 8192,
               "fdiv_nobranch": 8192, "dfma": 32768, "mma_tf32": 32768}
WINDOW_S = 0.4                   # each timed window lasts at least this long
PEAK_SLACK = 1.05                # a rate above 1.05x its published peak fails
CHECK_RTOL = {"ffma": 1e-4, "expf": 1e-5, "logf": 1e-5, "fdiv_rn": 1e-5,
              "fdiv_nobranch": 1e-5, "dfma": 1e-12, "mma_tf32": 1e-4, "read_bandwidth": 1e-5}
# (float32 chains against float64 torch ops: the roundings of each step,
# damped by the map's contraction, ~1e-6 at most; the MMAs' FP32
# accumulators reach ~2e3)


def chain_operands(op: str, n: int, seed: int = 0):
    """(a0 (ACC, n), u (n,), v (n,)) float64 for a chain whose iterates
    stay O(1).  The FMA chains contract by u in [0.999, 0.9999] a step.
    Each lane of the others has the fixed point x* of its map where the
    map's slope there, |f'(x*)|, lies in [0.7, 0.8]: slow enough that the
    check's CHECK_ITERS steps end in the transient (16 steps fewer leave
    the chain ~1e-2 away), fast enough that float32 rounding stays damped.
      expf  a -> exp(-a) + v:  x* in [0.223, 0.357], |f'| = exp(-x*),
            v = x* - exp(-x*);
      logf  a -> log(a + v):   z = x* + v in [1.25, 1.43], f' = 1 / z,
            v = z - log z;
      the divisions  a -> u / (a + v): the Moebius map of [[0, u], [1, v]]
            contracts by the ratio of its eigenvalues, (s - v) / (s + v)
            with s = sqrt(v^2 + 4u): u = r v^2 with r in [8, 20] gives
            0.70-0.80."""
    rng = np.random.default_rng(seed)
    a0 = rng.uniform(0.5, 1.0, (ACC, n))
    if op in ("ffma", "dfma"):
        return a0, rng.uniform(0.999, 0.9999, n), rng.uniform(0.0, 1e-3, n)
    if op == "expf":
        x = rng.uniform(0.223, 0.357, n)
        return a0, np.ones(n), x - np.exp(-x)
    if op == "logf":
        z = rng.uniform(1.25, 1.43, n)
        return a0, np.ones(n), z - np.log(z)
    v = rng.uniform(0.25, 0.5, n)                                   # the divisions
    return a0, rng.uniform(8.0, 20.0, n) * v * v, v


def chain_reference(op: str, a, u, v, iters: int):
    """The plain version of a chain: ``iters`` steps of ``op`` with torch
    ops, in the dtype of ``a`` (float64 for every check)."""
    import torch

    for _ in range(iters):
        if op in ("ffma", "dfma"):
            a = a * u + v
        elif op == "expf":
            a = torch.exp(-a) + v
        elif op == "logf":
            a = torch.log(a + v)
        else:
            a = u / (a + v)
    return a


def mma_operands(n_lanes: int, seed: int = 0):
    """(a (n_lanes, 4), b (n_lanes, 2), c (n_lanes, ACC, 4)) float64, each
    a multiple of 2^-10 in [0.5, 1): exact in TF32, so the kernel's
    rounding to TF32 leaves them as they are."""
    rng = np.random.default_rng(seed)
    tf32 = lambda shape: rng.integers(512, 1024, shape) / 1024.0
    return tf32((n_lanes, 4)), tf32((n_lanes, 2)), tf32((n_lanes, ACC, 4))


def mma_fragments(a, b, c):
    """The per-warp matrices of m16n8k8 fragments: A (W, 16, 8), B (W, 8,
    8), C (W, ACC, 16, 8) from per-lane a (W*32, 4), b (W*32, 2), c
    (W*32, ACC, 4): A rows g, g + 8 and columns t, t + 4 (a0..a3: (g, t),
    (g + 8, t), (g, t + 4), (g + 8, t + 4)); B rows t, t + 4 and column g;
    C rows g, g + 8 and columns 2t, 2t + 1 (g = lane / 4, t = lane % 4)."""
    import torch

    W = a.shape[0] // 32
    lane = torch.arange(32, device=a.device)
    g, t = lane // 4, lane % 4
    A = a.new_zeros((W, 16, 8))
    B = b.new_zeros((W, 8, 8))
    C = c.new_zeros((W, c.shape[1], 16, 8))
    a, b, c = a.reshape(W, 32, 4), b.reshape(W, 32, 2), c.reshape(W, 32, -1, 4)
    for r, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        A[:, g + dr, t + dc] = a[:, :, r]
    B[:, t, g] = b[:, :, 0]
    B[:, t + 4, g] = b[:, :, 1]
    for r, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
        C[:, :, g + dr, 2 * t + dc] = c[:, :, :, r].transpose(1, 2)
    return A, B, C


def mma_lanes(D):
    """Per-lane accumulators (W*32, ACC, 4) of per-warp tiles D (W, ACC, 16, 8)."""
    import torch

    W = D.shape[0]
    lane = torch.arange(32, device=D.device)
    g, t = lane // 4, lane % 4
    parts = [D[:, :, g + dr, 2 * t + dc] for dr, dc in ((0, 0), (0, 1), (8, 0), (8, 1))]
    return torch.stack(parts, dim=-1).transpose(1, 2).reshape(W * 32, D.shape[1], 4)


def mma_reference(a, b, c, iters: int):
    """The plain version of the MMA chain: each warp's tiles D_j = C_j +
    A B added ``iters`` times, as per-lane accumulators."""
    A, B, D = mma_fragments(a, b, c)
    AB = (A @ B)[:, None]
    for _ in range(iters):
        D = D + AB
    return mma_lanes(D)


def _library():
    from gp_dla_detection_tpu_torch import _build

    built = _build.load_library("roofline")
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gpdla_roofline_chain_f32.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.gpdla_roofline_chain_f64.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.gpdla_roofline_mma_tf32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.gpdla_roofline_read.argtypes = [ptr, ctypes.c_longlong, ptr, i32, ptr]
    for fn in (lib.gpdla_roofline_chain_f32, lib.gpdla_roofline_chain_f64,
               lib.gpdla_roofline_mma_tf32, lib.gpdla_roofline_read, lib.gpdla_roofline_acc):
        fn.restype = ctypes.c_int
    lib.gpdla_roofline_acc.argtypes = []
    lib.gpdla_roofline_error_string.argtypes = [i32]
    lib.gpdla_roofline_error_string.restype = ctypes.c_char_p
    if lib.gpdla_roofline_acc() != ACC:
        raise RuntimeError(f"csrc/roofline.cu carries {lib.gpdla_roofline_acc()} chains, not {ACC}")
    return built


def _launch(lib, fn, *args) -> None:
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err:
        raise RuntimeError(f"roofline launch failed: {lib.gpdla_roofline_error_string(err).decode()}")


class Microbench:
    """One microbenchmark on the card: its device operands (kept alive
    here while the kernel reads them), ``run(iters)`` (one launch; returns
    the output tensor), ``work(iters)`` (operations, FLOPs or bytes of one
    launch) and ``check()`` (the relative error of the output at its
    CHECK_ITERS against its plain version)."""

    def __init__(self, name: str, built):
        import torch

        self.name, self.lib = name, built.lib
        dev = torch.device("cuda")
        ptrs = lambda ts: [t.data_ptr() for t in ts]
        self.takes_iters = name != "read_bandwidth"
        if name in F32_OPS or name == "dfma":
            dtype = torch.float64 if name == "dfma" else torch.float32
            self.operands = [torch.as_tensor(x, device=dev).to(dtype).contiguous()
                             for x in chain_operands(name, CHAIN_THREADS)]
            self.out = torch.empty_like(self.operands[0])
            head = () if name == "dfma" else (F32_OPS[name],)
            self.fn = (self.lib.gpdla_roofline_chain_f64 if name == "dfma"
                       else self.lib.gpdla_roofline_chain_f32)
            self.args = (*head, *ptrs(self.operands), self.out.data_ptr(), CHAIN_THREADS)
            self.per_launch = float(ACC) * CHAIN_THREADS        # a step of every chain
            ref = [x.double() for x in self.operands]           # as the kernel reads them
            self.reference = lambda it: chain_reference(name, *ref, it)
        elif name == "mma_tf32":
            exact = [torch.as_tensor(x, device=dev) for x in mma_operands(MMA_LANES)]
            self.operands = [x.float().contiguous() for x in exact]
            self.out = torch.empty_like(self.operands[2])
            self.fn = self.lib.gpdla_roofline_mma_tf32
            self.args = (*ptrs(self.operands), self.out.data_ptr(), MMA_LANES)
            # a step: each warp's ACC m16n8k8 products, 2 * 16 * 8 * 8 FLOPs each
            self.per_launch = float(MMA_LANES // 32) * ACC * 2 * 16 * 8 * 8
            self.reference = lambda it: mma_reference(*exact, it)
        elif name == "read_bandwidth":
            gen = torch.Generator(device=dev).manual_seed(0)
            self.operands = [torch.rand(READ_BYTES // 4, device=dev, generator=gen)]
            self.out = torch.empty(READ_BLOCKS, dtype=torch.float64, device=dev)
            self.fn = self.lib.gpdla_roofline_read
            x = self.operands[0]
            self.args = (x.data_ptr(), x.numel() // 4, self.out.data_ptr(), READ_BLOCKS)
            self.per_launch = float(READ_BYTES)
            self.reference = lambda it: x.sum(dtype=torch.float64)
        else:
            raise ValueError(name)

    def run(self, iters: int):
        _launch(self.lib, self.fn, *self.args, *((iters,) if self.takes_iters else ()))
        return self.out

    def work(self, iters: int) -> float:
        return self.per_launch * (iters if self.takes_iters else 1)

    def check(self) -> float:
        """Relative error of the kernel's output at its CHECK_ITERS against
        its plain version (float64 torch ops on the card)."""
        iters = CHECK_ITERS[self.name]
        got = self.run(iters).double()
        want = self.reference(iters)
        if self.name == "read_bandwidth":
            got = got.sum()
        return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def gpu_sample() -> dict:
    """nvidia-smi's SM clock, power draw, power limit and temperature."""
    keys = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")
    out = subprocess.run(
        ["nvidia-smi", "--id=0", f"--query-gpu={','.join(keys)}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return dict(zip(("sm_clock", "power_draw", "power_limit", "temperature"),
                    (x.strip() for x in out.split(","))))


def timed_window(fn, reps: int | None = None) -> tuple[float, dict, int]:
    """(mean ms of ``fn()`` on the card, the nvidia-smi sample read while
    the window ran, the launches timed).  After a warm-up call, the calls
    are queued behind a spin kernel (the card's own time, not the host's
    issue) and timed with CUDA events; ``reps`` defaults to enough calls
    to fill WINDOW_S, so that the sample lands inside the window."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    if reps is None:
        reps = max(3, min(500, math.ceil(WINDOW_S / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * 0.05))   # ~50 ms of spin: the host gets ahead
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sample = gpu_sample()                # the card is still working the window
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, sample, reps


def library_matmul(dtype_name: str) -> dict:
    """One torch.matmul of two 4096^2 matrices, FP32 with TF32 off or
    FP64: the library yardstick (the port never calls it)."""
    import torch

    m = 4096
    dtype = {"fp32": torch.float32, "fp64": torch.float64}[dtype_name]
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.rand((m, m), device="cuda", generator=gen, dtype=dtype)
    b = torch.rand((m, m), device="cuda", generator=gen, dtype=dtype)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms, sample, reps = timed_window(lambda: torch.matmul(a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    peak = FP32_FLOPS_PER_S if dtype_name == "fp32" else FP64_TC_FLOPS_PER_S
    rate = 2.0 * m**3 / (ms / 1e3)
    return {"rate": rate, "unit": "FLOP/s", "published": peak, "share_of_published": rate / peak,
            "ms": ms, "launches": reps, "gpu": sample, "library": True}


MICROBENCHES = ("ffma", "expf", "logf", "fdiv_rn", "fdiv_nobranch", "mma_tf32", "dfma",
                "read_bandwidth")
UNITS = {"ffma": "FMA/s", "expf": "calls/s", "logf": "calls/s", "fdiv_rn": "calls/s",
         "fdiv_nobranch": "calls/s", "mma_tf32": "FLOP/s", "dfma": "FMA/s",
         "read_bandwidth": "bytes/s"}
PUBLISHED_PEAK = {"ffma": FP32_OPS_PER_S, "expf": SFU_PER_S, "logf": SFU_PER_S,
                  "fdiv_rn": SFU_PER_S, "fdiv_nobranch": SFU_PER_S,
                  "mma_tf32": TF32_FLOPS_PER_S, "dfma": FP64_OPS_PER_S,
                  "read_bandwidth": HBM_BYTES_PER_S}


def measure_ceilings(say=print) -> dict:
    """Every ceiling of MICROBENCHES and the two library matmuls on the
    card; raises when a microbenchmark's output differs from its plain
    version or a rate is above PEAK_SLACK x its published peak."""
    import torch

    built = _library()
    out = {}
    for name in MICROBENCHES:
        mb = Microbench(name, built)
        err = mb.check()
        if not err <= CHECK_RTOL[name]:
            raise RuntimeError(f"the {name} microbenchmark differs from its plain version "
                               f"by {err:.3e} (relative; at most {CHECK_RTOL[name]:.0e})")
        iters = TIMED_ITERS.get(name, 0)
        ms, sample, reps = timed_window(lambda: mb.run(iters))
        rate = mb.work(iters) / (ms / 1e3)
        peak = PUBLISHED_PEAK[name]
        out[name] = {"rate": rate, "unit": UNITS[name], "published": peak,
                     "share_of_published": rate / peak, "check_rel_err": err, "ms": ms,
                     "launches": reps, "gpu": sample, "library": False}
        say(f"ceiling {name}: {rate:.4e} {UNITS[name]} ({rate / peak:.3f} of the published "
            f"{peak:.4e}); vs its plain version {err:.2e} relative; {ms:.3f} ms a launch x "
            f"{reps}; {sample}")
        if rate > PEAK_SLACK * peak:
            raise RuntimeError(f"the {name} rate {rate:.4e} is above {PEAK_SLACK} x the "
                               f"published peak {peak:.4e}: the microbenchmark is wrong")
        del mb
        torch.cuda.empty_cache()
    for dt in ("fp32", "fp64"):
        rec = library_matmul(dt)
        name = f"library_matmul_{dt}"
        out[name] = rec
        say(f"ceiling {name} (library, torch.matmul 4096^2{', TF32 off' if dt == 'fp32' else ''}): "
            f"{rec['rate']:.4e} FLOP/s ({rec['share_of_published']:.3f} of the published "
            f"{rec['published']:.4e}); {rec['ms']:.3f} ms; {rec['gpu']}")
        if rec["rate"] > PEAK_SLACK * rec["published"]:
            raise RuntimeError(f"{name}: {rec['rate']:.4e} FLOP/s is above the published peak")
    out["mma_tf32_3x"] = {"rate": out["mma_tf32"]["rate"] / 3, "unit": "FLOP/s (3xTF32)",
                          "of": "a third of mma_tf32"}
    return out


def class_rates(ceilings: dict) -> dict:
    """Each op class's measured rate (CLASS_CEILING)."""
    return {c: ceilings[CLASS_CEILING[c]]["rate"] for c in CLASSES}


# ---------------------------------------------------------------------------
# the port's kernels at the production shapes
# ---------------------------------------------------------------------------

B_PROD, S_PROD, P_PROD, K_PROD = 1024, 10000, 1274, 20


def _captured_chain_inputs(B: int, S: int, P: int, k: int):
    """The base redraw's input (sll (B, S), kvec, grid) and the CDDF
    sums' arguments of one batch of the fused lean chain with CDDF inputs
    (the bench's workload, one batch of B on the card), kept as the chain
    gives them."""
    from gp_dla_detection_tpu_torch import bench, cddf_inputs
    from gp_dla_detection_tpu_torch.parallel import sharded_multi
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import ShardedRunConfig

    work = bench.driver_workload(B, S, P, k)
    kept = {}
    real_redraw, real_sums = sharded_multi.device_inverse_cdf_grid, cddf_inputs.cddf_sums

    def redraw_spy(sll, kvec, grid_size=None):
        kept.setdefault("redraw", (sll.clone(), kvec.clone(), grid_size))
        return real_redraw(sll, kvec, grid_size)

    def sums_spy(*args):
        kept.setdefault("sums", [a.clone() if hasattr(a, "clone") else a for a in args])
        return real_sums(*args)

    sharded_multi.device_inverse_cdf_grid, cddf_inputs.cddf_sums = redraw_spy, sums_spy
    try:
        sharded_multi.process_spectra_multi_sharded(
            work.model, work.offsets, work.nhis, work.spectra.slice(slice(0, B)),
            work.prior_z, work.prior_num,
            config=ShardedRunConfig(per_device_batch=B, dtype="float32",
                                    store_sample_likelihoods=False, store_cddf_inputs=True),
        )
    finally:
        sharded_multi.device_inverse_cdf_grid, cddf_inputs.cddf_sums = real_redraw, real_sums
    return kept["redraw"], kept["sums"]


def kernel_row(name: str, ms: float, work: dict, published: tuple, rates: dict,
               sample: dict) -> dict:
    """One kernel's time ``ms`` on the card placed against its bound at
    the published peaks (``published``: (ms, pipe)) and at the measured
    ceilings (``rates``: ``class_rates``), with the nvidia-smi sample of
    its window."""
    mb = measured_bound(work, rates)
    return {"name": name, "ms": ms, "gpu": sample,
            "bound_ms": published[0], "bound_by": published[1],
            "published_share": published[0] / ms,
            "measured_bound_ms": mb["ms"], "bounding_class": mb["class"],
            "measured_share": mb["ms"] / ms, "class_ms": mb["class_ms"],
            "composite_ms": mb["composite_ms"], "composite_share": mb["composite_ms"] / ms,
            "work": {c: work[c] for c in CLASSES if work[c]}}


def kernel_row_text(row: dict) -> str:
    return (f"kernel {row['name']}: {row['ms']:.4f} ms; published-peak bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({row['published_share']:.3f} of "
            f"it); at the measured ceilings {row['measured_bound_ms']:.4f} ms by "
            f"{row['bounding_class']} ({row['measured_share']:.3f}); composite "
            f"{row['composite_ms']:.4f} ms ({row['composite_share']:.3f}); classes "
            + ", ".join(f"{c} {t:.4f}" for c, t in row["class_ms"].items())
            + f" ms; {row['gpu']}")


def measure_kernels(ceilings: dict, say=print, seed: int = 0) -> list[dict]:
    """The five kernels at the production shapes, each timed on the card
    and placed against its published-peak bound and its bound at the
    measured ceilings."""
    import torch

    from gp_dla_detection_tpu_torch import bench, cddf_inputs
    from gp_dla_detection_tpu_torch.inference import _prepare_spectrum, kernel_sample_window
    from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern
    from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn, redraw

    B, S, P, k = B_PROD, S_PROD, P_PROD, K_PROD
    rates = class_rates(ceilings)
    dev = torch.device("cuda")
    prob = bench._synthetic_problem(B, S, P, k)
    params = prob["params"]
    P6 = P + 2 * params.instrument.width
    window = kernel_sample_window(prob["offsets"], P, params)
    order = np.argsort(prob["offsets"], kind="stable")
    kin, _ = kernel_inputs(prob, params, prob["offsets"][order], prob["nhis"][order], B, dev,
                           torch.float32)
    draw_idx, n_draws = replicate_draw_pattern(S, evidence.SAMPLE_TILE, 4)
    rng = np.random.default_rng(seed + 3)
    cols4 = torch.as_tensor(np.stack([rng.permutation(S)[:n_draws][draw_idx] for _ in range(B)]),
                            device=dev)
    cols1 = torch.as_tensor(rng.integers(0, S, (B, S)), device=dev)
    base = {R: (kin[7].gather(1, c).contiguous(), kin[8].gather(1, c).contiguous())
            for R, c in ((4, cols4), (1, cols1))}
    rows = []

    def place(name, fn, work, published, reps=None):
        ms, sample, n = timed_window(fn, reps)
        rows.append({**kernel_row(name, ms, work, published, rates, sample),
                     "launches_timed": n})
        say(kernel_row_text(rows[-1]))

    single_w = evidence_work(B, S, P, P6, k, 3, window, False, 0)
    place("evidence_single_f32",
          lambda: evidence.sample_log_likelihoods(*kin, window=window),
          single_w, evidence_bound(B, S, P, P6, k, 3, window, False, 0), reps=2)
    for R, distinct in ((1, S), (4, n_draws)):
        z2, n2 = base[R]
        place(f"evidence_pair_f32_r{R}",
              lambda: evidence.sample_log_likelihoods_pair(*kin, z2, n2, window=window,
                                                           base_replicates=R),
              evidence_work(B, S, P, P6, k, 3, window, True, distinct),
              evidence_bound(B, S, P, P6, k, 3, window, True, distinct), reps=2)
    del kin, base, cols1, cols4
    torch.cuda.empty_cache()

    (sll, kvec, grid), sums_args = _captured_chain_inputs(B, S, P, k)
    place("redraw_f32", lambda: redraw.inverse_cdf_grid(sll, kvec, grid),
          redraw_work(*sll.shape, kvec.numel()), redraw_bound(*sll.shape, kvec.numel()))
    n_bins = sums_args[-2] * (sums_args[-1] + 1) + 1
    place("cddf_sums_f64", lambda: cddf_inputs.cddf_sums(*sums_args),
          cddf_work(sums_args[0].shape[0], S, n_bins), cddf_bound(sums_args[0].shape[0], S, n_bins))
    del sll, kvec, sums_args

    t32 = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(torch.float32)
    prep = _prepare_spectrum(
        t32(prob["wavelengths"]), t32(prob["flux"]), t32(prob["noise_variance"]),
        torch.as_tensor(prob["mask"], device=dev), t32(prob["z_qso"]), t32(prob["grid"]),
        t32(prob["mu"]), t32(prob["M"]), t32(prob["log_omega"]), prob["log_c_0"],
        prob["log_tau_0"], prob["log_beta"], params, null_evidence=False,
    )
    null_args = [t32(prob["flux"]), prep["mu"], prep["M"],
                 prep["omega2"] + t32(prob["noise_variance"]), prep["valid"]]
    place("null_evidence_f32", lambda: low_rank_mvn.null_log_likelihoods(*null_args),
          null_work(B, P, k), null_bound(B, P, k))
    return rows


def measure(say=print, seed: int = 0) -> dict:
    """The ceilings, then the kernels against them: the report."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the roofline is measured on the card only")
    ceilings = measure_ceilings(say)
    kernels = measure_kernels(ceilings, say, seed)
    return {"card": torch.cuda.get_device_name(0), "ceilings": ceilings, "kernels": kernels,
            "shapes": {"B": B_PROD, "S": S_PROD, "P": P_PROD, "k": K_PROD, "lines": 3,
                       "windowed": True}}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the report's JSON here as well")
    a = p.parse_args(argv)
    report = measure()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(report, indent=1))
    print(f"ROOFLINE {json.dumps(report)}", flush=True)


if __name__ == "__main__":
    main()
