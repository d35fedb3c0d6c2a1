"""The CUDA evidence kernel on the card, against its plain versions:
the single-absorber and the two-DLA pair configurations.  Also the
drivers on a one-rank NCCL mesh (its collectives on the card) against the
same runs with no process group, the on-device L-BFGS on the card, the
golden fixture through the float64 plain path on the card, and the
float32 plain path's independence of where a column's block sits.

These tests need an NVIDIA GPU with nvcc (sm_90a); without a card they
skip.  The file imports no jax, so on a machine without jax run it
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import contextlib
import socket

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu_torch.multi_dla import replicate_draw_pattern
from gp_dla_detection_tpu_torch.ops import evidence
from gp_dla_detection_tpu_torch.params import InstrumentParams

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
    [(160, 5, 3, None), (130, 5, 3, 256), (64, 20, 3, None), (200, 20, 31, 256),
     (300, 20, 31, None), (300, 20, 3, 256)],
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


def test_golden_fixture_on_the_card_float64(device):
    """tests/fixtures/golden_evidences.npz (tests/test_golden.py's problem,
    rebuilt from its seed) through the port's float64 plain path on the
    card, at the fixture's 1e-9 relative, as tests/test_torch_inference.py
    holds it on the CPU."""
    from pathlib import Path

    from gp_dla_detection_tpu_torch.inference import batch_log_likelihoods
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters

    rng = np.random.default_rng(20160446)
    params = Parameters(null_model=NullModelParams(k=6))
    grid = params.null_model.rest_wavelengths()
    model = (grid, 1.0 + 0.2 * np.sin(grid / 35.0), rng.normal(size=(grid.size, 6)) * 0.07,
             np.log(0.15 + 0.05 * np.cos(grid / 55.0)))
    B, P, S = 3, 700, 64
    z = np.array([2.71, 3.05, 3.42])
    lam = np.stack([10 ** (np.log10(911.8 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z])
    mask = rng.uniform(size=(B, P)) > 0.04
    spectrum = (lam, rng.normal(1.0, 0.25, (B, P)), rng.uniform(0.05, 0.2, (B, P)), mask, z)
    samples = (rng.uniform(size=S), 10 ** rng.uniform(20.0, 22.3, S))
    t = lambda a: torch.as_tensor(a, device=device) if a.dtype == bool else \
        torch.as_tensor(a, dtype=torch.float64, device=device)
    out = batch_log_likelihoods(
        *map(t, spectrum), *map(t, model), np.log(0.1), np.log(0.0023), np.log(3.65),
        *map(t, samples), params=params, sample_chunk=16, backend="torch",
    )
    assert out["sample_log_likelihoods_dla"].device.type == "cuda"
    with np.load(Path(__file__).parent / "fixtures" / "golden_evidences.npz") as f:
        for key, rtol in (("log_likelihood_no_dla", 1e-9), ("sample_log_likelihoods_dla", 1e-9),
                          ("min_z_dla", 1e-12), ("max_z_dla", 1e-12)):
            np.testing.assert_allclose(out[key].cpu().numpy(), f[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("stage", ["single", "pair"])
def test_plain_path_blocks_of_the_axis_are_bit_equal_to_the_whole(device, stage):
    """The fused lean chain on a sample axis (``backend="torch"``) splits
    the one-device column layout into contiguous blocks, one per sample
    rank, and gathers the rows; it is bit-identical to one process only
    if a float32 plain-path evidence does not move with its block.  At
    the chain's production shapes (P = 1274, k = 20, S = 10,000 in chunks
    of 2,500), the two halves of the axis give the whole axis's values bit
    for bit, for the single-DLA and the pair evidences."""
    import torch_distributed_worker as worker

    halves, whole = worker.plain_path_halves(device, stage, 4, 1274, 20, 10_000, 2_500)
    assert np.isfinite(whole).any()
    np.testing.assert_array_equal(halves, whole)


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
    [(160, 5, 3, None), (130, 5, 3, 256), (64, 20, 3, None), (200, 20, 31, 256),
     (300, 20, 31, None), (300, 20, 3, 256)],
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


def test_ragged_last_tile_repeats_the_last_sample(device):
    # S = 130: the second 128-sample block holds two samples and 126
    # copies of the last one, exactly as if they had been passed
    args = kernel_inputs(device, S=130, k=20)
    padded = list(args)
    for i in (7, 8):
        padded[i] = torch.cat([args[i], args[i][:, -1:].expand(-1, 126)], dim=1).contiguous()
    for window in (None, 256):
        ragged = evidence.sample_log_likelihoods(*args, window=window)
        full = evidence.sample_log_likelihoods(*padded, window=window)
        assert torch.equal(ragged, full[:, :130])


def replicated_pair_inputs(device, R, S=600, k=20):
    """pair_inputs with the second absorber in the R layout of the lean
    chain: draw slot replicate_draw_pattern(S, 256, R) per column."""
    args, z2, nhi2 = pair_inputs(device, S=S, k=k)
    draw_idx, n_draws = replicate_draw_pattern(S, evidence.PATTERN_TILE, R)
    cols = torch.as_tensor(draw_idx, device=device)
    return args, z2[:, :n_draws][:, cols].contiguous(), nhi2[:, :n_draws][:, cols].contiguous()


@pytest.mark.parametrize("window", [None, 256])
def test_pair_kernel_is_bit_identical_across_base_replicates(device, window):
    # an R = 8 layout is also an R = 4 and an R = 2 one: the per-lane
    # arithmetic is the same whatever R, only its reuse differs
    args, z2, nhi2 = replicated_pair_inputs(device, 8)
    outs = {
        R: evidence.sample_log_likelihoods_pair(
            *args, z2, nhi2, window=window, base_replicates=R
        )
        for R in (1, 2, 4, 8)
    }
    ref = evidence.sample_log_likelihoods_pair_reference(*args, z2, nhi2, window=window)
    assert normalized_err(outs[1], ref) < BOUND
    for R in (2, 4, 8):
        assert torch.equal(outs[R], outs[1]), R


def test_pair_kernel_refuses_a_broken_base_layout(device):
    args, z2, nhi2 = replicated_pair_inputs(device, 4)
    before = evidence.pair_launch_count
    bad = z2.clone()
    bad[1, 300], bad[1, 301] = z2[1, 301], z2[1, 300]
    with pytest.raises(ValueError, match="base_replicates=4"):
        evidence.sample_log_likelihoods_pair(*args, bad, nhi2, base_replicates=4)
    with pytest.raises(ValueError, match="base_replicates must be"):
        evidence.sample_log_likelihoods_pair(*args, z2, nhi2, base_replicates=3)
    assert evidence.pair_launch_count == before


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group on card 0 and its mesh."""
    from gp_dla_detection_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        shutdown,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        yield make_mesh()
    finally:
        shutdown()


def test_one_rank_nccl_mesh_equals_no_process_group(device):
    import torch_distributed_worker as worker
    from gp_dla_detection_tpu_torch.ops import evidence as ev
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig, process_spectra_sharded
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_sharded

    params, model, spectra, offsets, nhis, prior_z, prior_f = worker.port_problem()
    model = model.to(device=device, dtype=torch.float32)

    def runs(mesh):
        # the defaults: the card, float32, the kernels
        out, launches = {}, []
        for lean in (False, True):
            before = ev.launch_count
            res = process_spectra_sharded(
                model, offsets, nhis, spectra, prior_z, prior_f, params=params, mesh=mesh,
                config=ShardedRunConfig(per_device_batch=4, store_sample_likelihoods=not lean),
            )
            launches.append(ev.launch_count - before)
            out[f"single_{lean}"] = worker.single_fields(res)
        before = (ev.launch_count, ev.pair_launch_count)
        chain = process_spectra_multi_sharded(
            model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params, mesh=mesh,
            config=ShardedRunConfig(per_device_batch=4, store_sample_likelihoods=False,
                                    store_cddf_inputs=True),
        )
        launches.append((ev.launch_count - before[0], ev.pair_launch_count - before[1]))
        out["chain"] = worker.multi_fields(chain)
        return out, launches

    ref, ref_launches = runs(None)
    with one_rank_nccl() as mesh:
        assert (mesh.backend, mesh.device) == ("nccl", torch.device("cuda", 0))
        got, launches = runs(mesh)
    # 11 spectra in batches of 4: three launches of each kernel per run
    assert launches == ref_launches == [3, 3, (3, 3)]
    for run, fields in ref.items():
        assert sorted(got[run]) == sorted(fields)
        for k, v in fields.items():
            np.testing.assert_array_equal(got[run][k], v, err_msg=f"{run}.{k}")


def test_device_lbfgs_on_the_card(device):
    import torch_distributed_worker as worker
    from gp_dla_detection_tpu_torch.models.training import TrainingData, learn_gp_model
    from gp_dla_detection_tpu_torch.ops import lbfgs_device

    fields, null_kw = worker.training_problem()
    params = worker.training_params(null_kw, iterations=30, evals=60)
    data = TrainingData(**fields)
    before = lbfgs_device.host_syncs
    _, card = learn_gp_model(data, params, optimizer="device", device=device)
    syncs = lbfgs_device.host_syncs - before
    _, cpu = learn_gp_model(data, params, optimizer="device", device="cpu")
    # float64 on both: the same path to the reductions' rounding
    assert (card.iterations, card.fun_evals, card.message) == (
        cpu.iterations, cpu.fun_evals, cpu.message
    )
    np.testing.assert_allclose(card.x, cpu.x, rtol=1e-8, atol=1e-10)
    # scalar reads only: one per line-search trial and one per iteration
    assert syncs == 1 + (card.fun_evals - 1) + card.iterations
