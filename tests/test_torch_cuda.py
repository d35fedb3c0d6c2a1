"""The CUDA evidence kernel on the card, against its plain versions:
the single-absorber and the two-DLA pair configurations.

These tests need an NVIDIA GPU with nvcc (sm_90a); without a card they
skip.  The file imports no jax, so on a machine without jax run it
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.params import InstrumentParams
from gp_dla_detection_tpu_torch.ops import evidence

pytestmark = pytest.mark.cuda

BOUND = 5e-5  # normalized; the two versions differ only in summation order


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def kernel_inputs(device, B=2, P=384, S=160, k=5, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = InstrumentParams().width
    P6 = P + 2 * w
    lam = np.stack([10 ** (np.log10(3600.0 + 40 * b) + 1e-4 * np.arange(P6)) for b in range(B)])
    zc = lam[:, w + P // 2] / 1215.6701 - 1
    arrays = (
        lam,
        rng.normal(1, 0.3, (B, P)),
        1.0 + 0.1 * np.sin(np.arange(P) / 40)[None, :].repeat(B, 0),
        rng.normal(size=(B, P, k)) * 0.08,
        rng.uniform(0.01, 0.05, (B, P)),
        rng.uniform(0.05, 0.2, (B, P)),
        rng.uniform(size=(B, P)) > 0.05,
        np.sort(rng.uniform(zc[:, None] - 0.02, zc[:, None] + 0.02, (B, S)), axis=1),
        10 ** rng.uniform(20, 22, (B, S)),
    )
    return [
        torch.as_tensor(a, device=device) if a.dtype == bool
        else torch.as_tensor(a, device=device).to(dtype)
        for a in arrays
    ]


def normalized_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize(
    "S,k,num_lines,window",
    [(160, 5, 3, None), (130, 5, 3, 256), (64, 20, 3, None), (200, 20, 31, 256)],
)
def test_kernel_matches_plain_version(device, S, k, num_lines, window):
    args = kernel_inputs(device, S=S, k=k)
    before = evidence.launch_count
    out = evidence.sample_log_likelihoods(*args, num_lines=num_lines, window=window)
    torch.cuda.synchronize()
    assert evidence.launch_count == before + 1
    ref = evidence.sample_log_likelihoods_reference(*args, num_lines=num_lines, window=window)
    assert out.shape == (2, S) and out.dtype == torch.float32
    assert normalized_err(out, ref) < BOUND


def test_kernel_masked_nonfinite_inputs(device):
    args = kernel_inputs(device, S=64)
    mask = args[6].clone()
    mask[:, -8:] = False
    clean = evidence.sample_log_likelihoods(*args[:6], mask, *args[7:])
    args[1][:, -8:] = float("nan")
    args[4][:, -4:] = float("inf")
    dirty = evidence.sample_log_likelihoods(*args[:6], mask, *args[7:])
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)


def test_kernel_refuses_what_it_cannot_take(device):
    before = evidence.launch_count
    with pytest.raises(ValueError, match="float32-only"):
        evidence.sample_log_likelihoods(*kernel_inputs(device, S=32, dtype=torch.float64))
    args = kernel_inputs(device, S=32, k=7)
    with pytest.raises(ValueError, match="compiled for k"):
        evidence.sample_log_likelihoods(*args)
    args = kernel_inputs(device, S=32)
    args[7] = args[7].cpu()
    with pytest.raises(ValueError, match="must be on"):
        evidence.sample_log_likelihoods(*args)
    assert evidence.launch_count == before


def pair_inputs(device, seed=3, **kw):
    """kernel_inputs plus a second absorber per sample: z in no order
    (posterior-like draws of the first axis), its own column densities."""
    args = kernel_inputs(device, seed=seed, **kw)
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, S = args[7].shape
    draws = torch.stack([torch.randperm(S, generator=g) for _ in range(B)]).to(device)
    z2 = args[7].gather(1, draws).contiguous()
    nhi2 = (10 ** (20 + 1.5 * torch.rand((B, S), generator=g, dtype=torch.float64))).to(device, args[8].dtype)
    return args, z2, nhi2


@pytest.mark.parametrize(
    "S,k,num_lines,window",
    [(160, 5, 3, None), (130, 5, 3, 256), (64, 20, 3, None), (200, 20, 31, 256)],
)
def test_pair_kernel_matches_plain_version(device, S, k, num_lines, window):
    args, z2, nhi2 = pair_inputs(device, S=S, k=k)
    before = (evidence.launch_count, evidence.pair_launch_count)
    out = evidence.sample_log_likelihoods_pair(*args, z2, nhi2, num_lines=num_lines, window=window)
    torch.cuda.synchronize()
    assert (evidence.launch_count, evidence.pair_launch_count) == (before[0], before[1] + 1)
    ref = evidence.sample_log_likelihoods_pair_reference(
        *args, z2, nhi2, num_lines=num_lines, window=window
    )
    assert out.shape == (2, S) and out.dtype == torch.float32
    assert normalized_err(out, ref) < BOUND


def test_pair_kernel_is_the_single_kernel_with_an_empty_second_absorber(device):
    # N_HI2 = 0 adds exactly 0 to every optical depth
    args, z2, nhi2 = pair_inputs(device, S=96, k=20)
    single = evidence.sample_log_likelihoods(*args, window=256)
    pair = evidence.sample_log_likelihoods_pair(*args, z2, torch.zeros_like(nhi2), window=256)
    assert torch.equal(single, pair)


def test_pair_kernel_refuses_what_it_cannot_take(device):
    before = evidence.pair_launch_count
    args, z2, nhi2 = pair_inputs(device, S=32)
    with pytest.raises(ValueError, match="float32-only"):
        evidence.sample_log_likelihoods_pair(*args, z2.double(), nhi2)
    with pytest.raises(ValueError, match="must be on"):
        evidence.sample_log_likelihoods_pair(*args, z2.cpu(), nhi2)
    with pytest.raises(ValueError, match="per-sample inputs"):
        evidence.sample_log_likelihoods_pair(*args, z2[:, :16], nhi2)
    assert evidence.pair_launch_count == before
