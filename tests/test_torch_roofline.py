"""scripts/torch_roofline.py (and csrc/roofline.cu) on the CPU: its op
model against validation/roofline.py's, the published-peak bounds moved
out of chip_smoke.py at their former values, the microbenchmarks' plain
chains against their closed forms, and the script's refusal to measure
without a card.
"""

import re

import numpy as np
import pytest
import torch
from scipy.special import lambertw

from torch_harness_support import REPO, jax_harness, port_script, start_without_jax

torch.set_num_threads(1)

RL = port_script("torch_roofline")

# chip_smoke.py's bounds before they moved here (evidence_bound,
# redraw_bound, cddf_bound, null_bound) at the shapes of its phases 3 and
# 5 (B = 128; windowed at 120 px, and 31 lines on the full grid; the pair
# at 2,512 distinct base draws) and 10 (B = 1024); the evidence rows at the
# kernels' fused multiply-adds (with two roundings each they were 7.048,
# 68.366, 8.816, 85.270, 56.382 and 70.530 ms, all FP32 pipe)
FORMER_BOUNDS = [
    ("evidence", (128, 10000, 1274, 1280, 20, 3, 120, False, 0), 4.546249696969697,
     "TF32 tensor cores (3xTF32)"),
    ("evidence", (128, 10000, 1274, 1280, 20, 31, None, False, 0), 40.68573611940299,
     "FP32 pipe"),
    ("evidence", (128, 10000, 1274, 1280, 20, 3, 120, True, 2512), 5.339388484776119,
     "FP32 pipe"),
    ("evidence", (128, 10000, 1274, 1280, 20, 31, None, True, 2512), 50.68570807402985,
     "FP32 pipe"),
    ("evidence", (1024, 10000, 1274, 1280, 20, 3, 120, False, 0), 36.36999757575757,
     "TF32 tensor cores (3xTF32)"),
    ("evidence", (1024, 10000, 1274, 1280, 20, 3, 120, True, 2512), 42.715107878208954,
     "FP32 pipe"),
    ("redraw", (128, 10000, 2512), 0.0023022041791044773, "bytes"),
    ("redraw", (1024, 10000, 2512), 0.018375641791044776, "bytes"),
    ("cddf", (128, 10000, 2985), 0.022702423880597015, "bytes"),
    ("cddf", (1024, 10000, 2985), 0.18078357014925375, "bytes"),
    ("null", (128, 1274, 20), 0.004527226268656716, "bytes"),
    ("null", (1024, 1274, 20), 0.03621781014925373, "bytes"),
]
FORMER_PIPES_B128 = {"bytes": 0.009648678208955225, "FP32 pipe": 4.283300298507463,
                     "TF32 tensor cores (3xTF32)": 4.546249696969697}


@pytest.fixture(scope="module")
def jax_op_model():
    return jax_harness("roofline")["op_model"]


@pytest.mark.parametrize("two_dla,R", [(False, 1), (True, 1), (True, 4)])
def test_op_model_counts_equal_jax(jax_op_model, two_dla, R):
    """Given JAX's padded grid and window, the port's expf count is JAX's
    transcendentals and one pass of the Gram plus the Cholesky its MXU
    FLOPs."""
    S, k = 10000, 20
    ref = jax_op_model(S=S, k=k, num_lines=3, R=R, two_dla=two_dla)
    P6p, W = ref["P6_padded"], ref["window_px"]
    work = RL["evidence_work"](1, S, P6p, P6p, k, 3, W, two_dla, S // R)
    np.testing.assert_allclose(work["expf"], ref["transcendentals"], rtol=1e-12)
    np.testing.assert_allclose(work["gram_flops"] + work["cholesky_flops"], ref["mxu_flops"],
                               rtol=1e-12)


@pytest.mark.parametrize("kind,args,ms,by", FORMER_BOUNDS)
def test_published_bounds_keep_their_values(kind, args, ms, by):
    got = RL[f"{kind}_bound"](*args)
    assert got[0] == pytest.approx(ms, rel=1e-12) and got[1] == by


def test_published_pipes_and_classes_sum_to_the_former_count():
    _, _, pipes = RL["evidence_bound"](128, 10000, 1274, 1280, 20, 3, 120, False, 0)
    assert pipes.keys() == FORMER_PIPES_B128.keys()
    for pipe, ms in FORMER_PIPES_B128.items():
        assert pipes[pipe] == pytest.approx(ms, rel=1e-12)
    # each FP32-pipe class is one operation of the single count: per line
    # the wing 19 + its division, the core 5 + its exp; the raw 2 + its
    # exp; the convolution 7 and the weights 14 + a division and a log
    work = RL["evidence_work"](1, 1, 1274, 1280, 20, 3, None, False, 0)
    fp32_pipe = sum(work[c] for c in ("fp32", "expf", "logf", "fdiv_rn", "fdiv_nobranch"))
    assert fp32_pipe == 1280 * (3 * (20 + 6) + 3) + 1274 * (7 + 16)


def test_chip_smoke_keeps_no_copy_of_the_bounds():
    text = (REPO / "chip_smoke.py").read_text()
    for name in ("evidence_bound", "redraw_bound", "cddf_bound", "null_bound", "voigt_ops",
                 "kernel_inputs"):
        assert f"def {name}(" not in text
    assert "HBM_BYTES_PER_S =" not in text and "FP32_OPS_PER_S =" not in text


def test_measured_bound_takes_the_largest_class_and_sums_the_composite():
    work = dict.fromkeys(RL["CLASSES"], 0.0)
    work.update(fp32=3e12, expf=1e11, bytes=1e9)
    rates = dict.fromkeys(RL["CLASSES"], 1e12)
    got = RL["measured_bound"](work, rates)
    assert got["class"] == "fp32" and got["ms"] == pytest.approx(3000.0)
    assert got["composite_ms"] == pytest.approx(3000.0 + 100.0 + 1.0)
    assert set(got["class_ms"]) == {"fp32", "expf", "bytes"}


def test_kernel_row_places_a_time_against_both_bounds():
    work = dict.fromkeys(RL["CLASSES"], 0.0)
    work.update(fp32=2e12, bytes=4e9)
    rates = dict.fromkeys(RL["CLASSES"], 1e12)
    row = RL["kernel_row"]("k", 4000.0, work, (1000.0, "FP32 pipe"), rates, {"sm_clock": "x"})
    assert row["published_share"] == pytest.approx(0.25)
    assert row["measured_bound_ms"] == pytest.approx(2000.0) and row["bounding_class"] == "fp32"
    assert row["measured_share"] == pytest.approx(0.5)
    assert row["composite_share"] == pytest.approx(0.501)
    assert row["work"] == {"fp32": 2e12, "bytes": 4e9} and row["gpu"] == {"sm_clock": "x"}
    assert "0.500" in RL["kernel_row_text"](row)


def _check_operands(op, n=4096):
    """The operands of ``op``'s check as the card's check reads them:
    float32 on the card (float64 for the DFMA chain and exact for the
    MMA), in float64."""
    if op == "mma_tf32":
        return [torch.as_tensor(x) for x in RL["mma_operands"](64)]
    ops = [torch.as_tensor(x) for x in RL["chain_operands"](op, n)]
    return ops if op == "dfma" else [x.float().double() for x in ops]


def _reference(op, operands, iters):
    if op == "mma_tf32":
        return RL["mma_reference"](*operands, iters)
    return RL["chain_reference"](op, *operands, iters)


@pytest.mark.parametrize("op", ["ffma", "expf", "logf", "fdiv_rn", "fdiv_nobranch", "dfma",
                                "mma_tf32"])
def test_check_tells_a_chain_from_one_16_steps_short(op):
    """At its CHECK_ITERS each chain is still moving: the plain version 16
    steps short is off by over 100x the check's tolerance, so a
    microbenchmark that ran fewer steps than its work counts fails."""
    operands = _check_operands(op)
    n = RL["CHECK_ITERS"][op]
    want, short = _reference(op, operands, n), _reference(op, operands, n - 16)
    err = float(((short - want).abs() / want.abs()).max())
    assert err > 100 * RL["CHECK_RTOL"][op]


@pytest.mark.parametrize("op", ["ffma", "expf", "logf", "fdiv_rn"])
def test_float32_chain_stays_within_its_check_tolerance(op):
    """The same chain in float32 torch ops lands within a fifth of the
    check's tolerance of float64 at CHECK_ITERS: the tolerance leaves
    room for a float32 chain's roundings."""
    operands = _check_operands(op)
    n = RL["CHECK_ITERS"][op]
    want = _reference(op, operands, n)
    got = _reference(op, [x.float() for x in operands], n).double()
    assert float(((got - want).abs() / want.abs()).max()) < RL["CHECK_RTOL"][op] / 5


def _chain(op, n=64, iters=300):
    a0, u, v = (torch.as_tensor(x) for x in RL["chain_operands"](op, n, seed=1))
    return a0, u, v, RL["chain_reference"](op, a0, u, v, iters)


@pytest.mark.parametrize("op", ["ffma", "dfma"])
def test_fma_chain_matches_its_closed_form(op):
    iters = 300
    a0, u, v, got = _chain(op, iters=iters)
    un = u**iters
    want = un * a0 + v * (1 - un) / (1 - u)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("op", ["fdiv_rn", "fdiv_nobranch"])
def test_division_chain_matches_its_closed_form(op):
    """a -> u / (a + v) is the Moebius map of [[0, u], [1, v]]: after n
    steps a_n = p / q with (p, q) = M^n (a0, 1)."""
    iters = 40
    a0, u, v, got = _chain(op, iters=iters)
    for i in range(0, a0.shape[1], 7):
        M = np.array([[0.0, u[i].item()], [1.0, v[i].item()]])
        p, q = np.linalg.matrix_power(M, iters) @ np.stack([a0[:, i].numpy(), np.ones(a0.shape[0])])
        np.testing.assert_allclose(got[:, i].numpy(), p / q, rtol=1e-12)


def test_exp_chain_reaches_its_fixed_point():
    """x = exp(-x) + v: x = v + W(exp(-v)) (Lambert's W)."""
    _, _, v, got = _chain("expf", iters=400)
    want = v.numpy() + lambertw(np.exp(-v.numpy())).real
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), rtol=1e-12)


def test_log_chain_reaches_its_fixed_point():
    """x = log(x + v): z = x + v solves z e^-z = e^-v on the branch z > 1
    (the attracting one): -z = W_-1(-e^-v)."""
    _, _, v, got = _chain("logf", iters=400)
    want = -lambertw(-np.exp(-v.numpy()), -1).real - v.numpy()
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), rtol=1e-12)


def test_mma_chain_matches_its_closed_form_per_lane():
    """D = C + iters A B, lane by lane: d[j][r] at row g (+8), column 2t
    (+1) is C's entry plus iters times sum_k A[row, k] B[k, col], with
    A's and B's entries where each lane holds its fragments."""
    n_lanes, iters = 64, 7
    a, b, c = (torch.as_tensor(x) for x in RL["mma_operands"](n_lanes, seed=2))
    got = RL["mma_reference"](a, b, c, iters)
    assert got.shape == c.shape
    for w in range(n_lanes // 32):
        lanes = slice(32 * w, 32 * w + 32)
        aw, bw = a[lanes].numpy(), b[lanes].numpy()
        A, B = np.zeros((16, 8)), np.zeros((8, 8))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = aw[lane]
            B[t, g], B[t + 4, g] = bw[lane]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for r, (row, col) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                            (g + 8, 2 * t + 1))):
                want = c[32 * w + lane, :, r] + iters * (A[row] @ B[:, col])
                np.testing.assert_allclose(got[32 * w + lane, :, r].numpy(), want, rtol=1e-14)
    # every operand is exact in TF32 (10 mantissa bits)
    for x in (a, b, c):
        assert torch.equal(x * 1024, torch.round(x * 1024))


def test_division_microbenchmark_is_the_evidence_kernels():
    """csrc/roofline.cu times the evidence kernel's own division."""
    body = lambda text: re.search(
        r"__device__ __forceinline__ float div_rn_nobranch\(float x, float y\) \{.*?\n\}",
        text, re.S).group(0)
    csrc = REPO / "gp_dla_detection_tpu_torch" / "csrc"
    assert body((csrc / "roofline.cu").read_text()) == body((csrc / "evidence.cu").read_text())


def test_without_a_card_the_script_exits_nonzero(tmp_path):
    proc = start_without_jax(["scripts/torch_roofline.py", "--out", str(tmp_path / "r.json")],
                             tmp_path / "block")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "ROOFLINE" not in out and not (tmp_path / "r.json").exists()
    assert "no CUDA device" in err
