"""The port's defaults, the pair kernel's base layout check, and the
precision of the kernel's 3xTF32 contraction, on the CPU.

- With no device, dtype or backend named, the model loaders, the drivers
  and the CLI resolve to the CUDA device, float32 and the kernel (seen
  with ``torch.cuda.is_available`` patched to True and each entry point
  stopped right after it resolved, so that nothing runs on a card);
  without a card the same calls raise and run nothing on the CPU.
- ``ops.evidence.check_base_layout`` accepts the lean chain's R layouts
  (``lean_base_columns``) at R = 1, 2, 4 and 8 and rejects one swapped
  lane.
- The kernel's contraction split into TF32 hi/lo parts (cvt.rna on the
  int32 view) and summed as lo*hi + hi*lo + hi*hi stays within the
  5e-5 normalized kernel bound of the JAX package's Pallas kernel
  (``pallas_interpret``), as tests/test_evidence_pallas.py holds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gp_dla_detection_tpu.inference import batch_log_likelihoods as jax_batch_log_likelihoods
from gp_dla_detection_tpu.params import NullModelParams as JaxNullModelParams
from gp_dla_detection_tpu.params import Parameters as JaxParameters
from gp_dla_detection_tpu_torch import inference, multi_dla, pipeline, runtime
from gp_dla_detection_tpu_torch.models import qso_model, training
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.ops import evidence, low_rank_mvn
from gp_dla_detection_tpu_torch.parallel import sharded_inference, sharded_multi
from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters

torch.set_num_threads(1)


class Resolved(Exception):
    """Raised by the spies once an entry point has resolved its run."""


DRIVERS = {
    "process_spectra": (inference, inference.process_spectra),
    "process_spectra_multi": (sharded_multi, sharded_multi.process_spectra_multi),
    "process_spectra_multi_lean": (sharded_multi, sharded_multi.process_spectra_multi_lean),
    "process_spectra_sharded": (sharded_inference, sharded_inference.process_spectra_sharded),
    "process_spectra_multi_sharded": (sharded_multi, sharded_multi.process_spectra_multi_sharded),
}


def cpu_model():
    grid = Parameters(null_model=NullModelParams(k=3)).null_model.rest_wavelengths()
    return GPModel.from_numpy(
        grid, np.ones_like(grid), np.zeros((grid.size, 3)), np.zeros_like(grid),
        0.0, 0.0, 0.0, device="cpu", dtype=torch.float64,
    )


@pytest.fixture
def with_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.fixture
def without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_default_to_the_card(name, with_card, monkeypatch):
    module, driver = DRIVERS[name]
    seen = []

    def spy(*args):
        seen.append(runtime.resolve_run(*args))
        raise Resolved

    monkeypatch.setattr(module, "resolve_run", spy)
    with pytest.raises(Resolved):
        driver(cpu_model(), None, None, None, None, None)
    assert seen == [(torch.device("cuda"), torch.float32, "cuda")]


def test_loaders_training_and_cli_default_to_the_card(with_card, monkeypatch, tmp_path):
    seen = []

    def spy(device=None):
        seen.append(runtime.default_device(device))
        raise Resolved

    grid = Parameters().null_model.rest_wavelengths()
    for module in (qso_model, training):
        monkeypatch.setattr(module, "default_device", spy)
    with pytest.raises(Resolved):
        GPModel.from_numpy(grid, grid, np.zeros((grid.size, 2)), grid, 0.0, 0.0, 0.0)
    with pytest.raises(Resolved):
        training.learn_gp_model(None)
    assert seen == [torch.device("cuda")] * 2

    def stub(params, config, *a, **kw):
        seen.append(config)
        raise Resolved

    monkeypatch.setattr(pipeline, "Pipeline", stub)
    with pytest.raises(Resolved):
        pipeline.main(["--workdir", str(tmp_path / "run")])
    config = seen[-1]
    assert (config.device, config.dtype, config.backend) == ("cuda", "float32", "cuda")
    assert (sharded_inference.ShardedRunConfig().device, sharded_inference.ShardedRunConfig().backend) \
        == (None, None)
    # naming the CPU is what takes the plain path
    assert pipeline.PipelineConfig(device="cpu").backend == "torch"
    assert runtime.resolve_run("cpu") == (torch.device("cpu"), torch.float32, "torch")
    assert runtime.resolve_run("cuda", torch.float64, "torch")[2] == "torch"


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_default_without_a_card_raises(name, without_card):
    _, driver = DRIVERS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver(cpu_model(), np.zeros(4), np.ones(4), None, np.zeros(4), np.zeros(4, bool))


def test_loaders_and_cli_without_a_card_raise(without_card, tmp_path):
    grid = Parameters().null_model.rest_wavelengths()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPModel.from_numpy(grid, grid, np.zeros((grid.size, 2)), grid, 0.0, 0.0, 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.learn_gp_model(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["--workdir", str(tmp_path / "run")])
    # the kernel's refusals hold when the CPU is named
    with pytest.raises(ValueError, match="backend='cuda'"):
        runtime.resolve_run("cpu", None, "cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        runtime.resolve_run("cuda", torch.float64, "cuda")


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_base_layout_check(R):
    rng = np.random.default_rng(R)
    S, B = 600, 3
    offsets = rng.uniform(size=S)
    cols, grid_size, _ = sharded_multi.lean_base_columns(offsets, 0, R, sorted_axis=True)
    table = torch.as_tensor(rng.uniform(2.0, 3.0, (B, grid_size)))
    z2 = table[:, torch.as_tensor(cols)]
    n2 = 10 ** (20 + z2)
    evidence.check_base_layout(z2, n2, R)
    if R == 1:
        return
    bad = z2.clone()
    bad[2, 300], bad[2, 301] = z2[2, 301], z2[2, 300]
    with pytest.raises(ValueError, match=f"base_replicates={R}"):
        evidence.check_base_layout(bad, n2, R)
    with pytest.raises(ValueError, match="base_replicates must be"):
        evidence.check_base_layout(z2, n2, 3)


def tf32_rna(x):
    """cvt.rna.tf32.f32: round the float32 significand to 10 bits, to
    nearest with ties away from zero, on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b as the kernel's tensor cores form it: each operand split
    into TF32 hi + lo, lo*hi + hi*lo + hi*hi summed in float32 (the
    products of TF32 values are exact in float32)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def woodbury_3xtf32(M, P, w, u, quad0, logdet_d, n_eff):
    """low_rank_mvn.woodbury_log_p with both contractions in 3xTF32."""
    k = M.shape[-1]
    b = matmul_3xtf32(u, M)
    B_tri = matmul_3xtf32(w, P)
    sym = torch.as_tensor(low_rank_mvn._symmetrize_indices(k))
    B = B_tri[..., sym].reshape(*B_tri.shape[:-1], k, k) + torch.eye(k, dtype=M.dtype)
    bBb, logdet_B = low_rank_mvn.batched_spd_quad_logdet(B, b)
    return -0.5 * (quad0 - bBb + logdet_d + logdet_B + n_eff * low_rank_mvn.LOG_2PI)


def test_3xtf32_contraction_within_the_kernel_bound(monkeypatch):
    # tests/test_evidence_pallas.py's problem, at k = 20
    rng = np.random.default_rng(0)
    B, P, S, k = 2, 384, 160, 20
    jparams = JaxParameters(null_model=JaxNullModelParams(k=k))
    grid = jparams.null_model.rest_wavelengths()
    model = dict(
        rest_wavelengths=grid, mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, k)) * 0.08, log_omega=np.log(0.2 + 0 * grid),
        log_c_0=np.log(0.1), log_tau_0=np.log(0.0023), log_beta=np.log(3.65),
    )
    z = rng.uniform(2.6, 3.2, B)
    lam = np.stack([10 ** (np.log10(911.9 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z])
    mask = rng.uniform(size=(B, P)) > 0.05
    flux, noise = rng.normal(1, 0.3, (B, P)), rng.uniform(0.05, 0.2, (B, P))
    offsets, nhis = rng.uniform(size=S), 10 ** rng.uniform(20, 22, S)

    f32 = lambda a: jnp.asarray(a, np.float32)
    ref = jax_batch_log_likelihoods(
        f32(lam), f32(flux), f32(noise), jnp.asarray(mask), f32(z), f32(grid),
        f32(model["mu"]), f32(model["M"]), f32(model["log_omega"]), model["log_c_0"],
        model["log_tau_0"], model["log_beta"], f32(offsets), f32(nhis),
        params=jparams, sample_chunk=32, backend="pallas_interpret",
    )["sample_log_likelihoods_dla"]
    ref = np.asarray(ref, np.float64)

    t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    args = (
        t32(lam), t32(flux), t32(noise), torch.as_tensor(mask), t32(z), t32(grid),
        t32(model["mu"]), t32(model["M"]), t32(model["log_omega"]), model["log_c_0"],
        model["log_tau_0"], model["log_beta"], t32(offsets), t32(nhis),
    )
    port_params = Parameters(null_model=NullModelParams(k=k))

    def evidences():
        out = inference.batch_log_likelihoods(*args, params=port_params, sample_chunk=32)
        return out["sample_log_likelihoods_dla"].double().numpy()

    plain = evidences()
    monkeypatch.setattr(low_rank_mvn, "woodbury_log_p", woodbury_3xtf32)
    split = evidences()
    scale = np.maximum(np.abs(ref), 1.0)
    err = np.max(np.abs(split - ref) / scale)
    assert err < 5e-5, err
    # the split did change the arithmetic, by far less than the bound
    assert 0 < np.max(np.abs(split - plain) / scale) < 5e-6
