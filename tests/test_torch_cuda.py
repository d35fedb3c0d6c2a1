"""The CUDA evidence kernel on the card, against its plain versions:
the single-absorber and the two-DLA pair configurations.  Also the
drivers on a one-rank NCCL mesh (its collectives on the card) against the
same runs with no process group, the on-device L-BFGS on the card, the
golden fixture through the float64 plain path on the card, the float32
plain path's independence of where a column's block sits, and the fused
chain's fixed-order kernels (the redraw, the CDDF sums, the null
evidence) against their plain versions, row by row independent of the
batch, and the chain with them the same bits at every batch size; the
single driver's full mode reducing and reordering its rows on the card.

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

BOUND = 5e-5  # normalized; the kernel sums its pixels in another order and fuses
# its multiply-adds (one rounding where the plain version rounds twice)


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


F32_ACCURACY_RATIO = 1.25  # chip_smoke.py phase 9's


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("stage", ["single", "pair"])
def test_kernel_is_as_close_to_float64_as_the_plain_float32_version(device, stage, seed):
    """At the main path's widths (k = 20, 3 lines, windowed, P = 1274,
    S = 512, N_HI and N_HI2 up to 1e23), the kernel's worst row is within
    F32_ACCURACY_RATIO of the plain float32 version's worst row, both
    measured against the float64 plain path (chip_smoke.py phase 9's
    check).  Both float32 versions round x and the line multiplier alike,
    and that rounding is most of their distance from float64, so the
    ratio stays near 1 (0.90-1.09 on these inputs); with its pixel sums
    added one after another the kernel read up to 1.51."""
    rng = np.random.default_rng(100 + seed)
    args, z2, _ = pair_inputs(device, seed=seed, B=4, P=1274, S=512, k=20)
    shape = args[8].shape
    args[8] = torch.as_tensor(10 ** rng.uniform(20, 23, shape), device=device).float()
    nhi2 = torch.as_tensor(10 ** rng.uniform(20, 23, shape), device=device).float()
    a64 = [a if a.dtype == torch.bool else a.double() for a in args]
    if stage == "single":
        out = evidence.sample_log_likelihoods(*args, window=256)
        plain = evidence.sample_log_likelihoods_reference(*args, window=256)
        ref64 = evidence.sample_log_likelihoods_reference(*a64)
    else:
        out = evidence.sample_log_likelihoods_pair(*args, z2, nhi2, window=256)
        plain = evidence.sample_log_likelihoods_pair_reference(*args, z2, nhi2, window=256)
        ref64 = evidence.sample_log_likelihoods_pair_reference(*a64, z2.double(), nhi2.double())
    assert normalized_err(out, ref64) <= F32_ACCURACY_RATIO * normalized_err(plain, ref64)


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


# ---------------------------------------------------------------------------
# the base redraw's kernel (ops/redraw.py) and the CDDF sums' kernel
# (cddf_inputs.cddf_sums): fixed orders of addition
# ---------------------------------------------------------------------------


def redraw_rows(rng, B, S):
    """Posterior-like float32 rows: broad, peaked, a NaN row, an all -inf
    row, scattered NaN and -inf entries."""
    sll = rng.normal(-50.0, 4.0, (B, S))
    sll[1 % B] = rng.normal(-50.0, 0.3, S)
    sll[2 % B, rng.integers(S)] += 200.0
    sll[3 % B] = np.nan
    sll[4 % B] = -np.inf
    sll[5 % B, rng.integers(0, S, S // 10 + 1)] = np.nan
    sll[6 % B, rng.integers(0, S, S // 10 + 1)] = -np.inf
    return sll.astype(np.float32)


@pytest.mark.parametrize("S,grid", [(1, 1), (7, 7), (300, 300), (300, 75), (300, 600),
                                    (4096, 4096), (10000, 2500), (10000, 10000)])
def test_redraw_kernel_counts_are_grid_counts_of_its_cdf(device, S, grid):
    from gp_dla_detection_tpu_torch.ops import redraw

    rng = np.random.default_rng(S + grid)
    sll = torch.as_tensor(redraw_rows(rng, 9, S), device=device)
    kvec = torch.as_tensor(rng.integers(0, grid, S), device=device)
    before = (redraw.launch_count, redraw.cdf_launch_count)
    got = redraw.inverse_cdf_grid(sll, kvec, grid)
    cdf = redraw.posterior_cdf(sll)
    torch.cuda.synchronize()
    assert (redraw.launch_count, redraw.cdf_launch_count) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.int64 and got.shape == (9, S)
    want = redraw.grid_counts_reference(cdf, grid)[:, kvec]
    assert torch.equal(got, want)
    # the CDF: within twice the plain float32 scan's distance from float64
    plain = redraw.posterior_cdf_reference(sll)
    exact = redraw.posterior_cdf_reference(sll.double())
    err = lambda c: float((c.double() - exact).abs().max())
    assert err(cdf) <= 2 * err(plain) + 1e-7, (err(cdf), err(plain))
    assert torch.equal(cdf[:, -1], torch.ones_like(cdf[:, -1]))


@pytest.mark.parametrize("S", [1, 4095, 4096, 4097, 10000, 10001, 12288, 12289, 100003])
def test_redraw_kernel_is_its_order_emulated_bit_for_bit(device, S):
    """The kernel's CDF equals ``posterior_cdf_in_kernel_order`` on the
    card bit for bit, and its draws the grid counts of that CDF: rows the
    block holds (S <= 12,288) and rows it streams twice."""
    from gp_dla_detection_tpu_torch.ops import redraw

    rng = np.random.default_rng(S)
    sll = torch.as_tensor(redraw_rows(rng, 9, S), device=device)
    grid = max(1, S // 4)
    kvec = torch.as_tensor(rng.integers(0, grid, S), device=device)
    emulated = redraw.posterior_cdf_in_kernel_order(sll)
    assert torch.equal(redraw.posterior_cdf(sll), emulated)
    assert torch.equal(redraw.inverse_cdf_grid(sll, kvec, grid),
                       redraw.grid_counts_reference(emulated, grid)[:, kvec])


def test_redraw_kernel_rounds_denormal_quotients(device):
    """Peaked rows whose CDF runs through the denormal range (c < 2**-126,
    where the division takes its slow path): tiny weights before one,
    two or three maxima (a total of exactly 1, 2 or 3, so that halving
    puts many quotients on a tie of the denormal grid) and a slow ramp;
    the kernel's CDF and draws bit for bit the emulated order's, whose
    division is the card's correctly rounded one."""
    from gp_dla_detection_tpu_torch.ops import redraw

    rng = np.random.default_rng(13)
    S, grid = 4000, 1000
    rows = np.empty((4, S))
    for r, n_max in enumerate((1, 2, 3)):
        rows[r] = rng.uniform(-103.0, -100.0, S)
        rows[r, S - n_max:] = 0.0
    rows[3] = np.linspace(-110.0, 0.0, S)
    sll = torch.as_tensor(rows.astype(np.float32), device=device)
    cdf = redraw.posterior_cdf(sll)
    emulated = redraw.posterior_cdf_in_kernel_order(sll)
    assert int(((cdf > 0) & (cdf < 2.0 ** -126)).sum()) > 10000
    assert torch.equal(cdf, emulated)
    kvec = torch.as_tensor(rng.integers(0, grid, S), device=device)
    assert torch.equal(redraw.inverse_cdf_grid(sll, kvec, grid),
                       redraw.grid_counts_reference(emulated, grid)[:, kvec])


def test_redraw_kernel_at_the_largest_grids(device):
    """Grids on either side of the largest whose boundary table fits in
    shared memory beside the histogram (about half the largest grid),
    and the largest grid: the draws are the grid counts of the kernel's
    own CDF, and odd J and rows off a 16-byte boundary write every
    draw."""
    from gp_dla_detection_tpu_torch.ops import redraw

    top = redraw.max_grid_size(device)
    rng = np.random.default_rng(11)
    S = 3001
    sll = torch.as_tensor(redraw_rows(rng, 7, S), device=device)
    cdf = redraw.posterior_cdf(sll)
    for grid in (top // 2 - 1, top // 2 + 1, top):
        kvec = torch.as_tensor(rng.integers(0, grid, 2 * S + 1), device=device)
        got = redraw.inverse_cdf_grid(sll, kvec, grid)
        assert torch.equal(got, redraw.grid_counts_reference(cdf, grid)[:, kvec]), grid
        assert torch.equal(redraw.inverse_cdf_grid(sll[1:4], kvec, grid), got[1:4])


def test_redraw_kernel_rows_do_not_depend_on_the_batch(device):
    from gp_dla_detection_tpu_torch.ops import redraw

    rng = np.random.default_rng(2)
    S, grid = 10000, 2500
    sll = torch.as_tensor(redraw_rows(rng, 64, S), device=device)
    kvec = torch.as_tensor(rng.integers(0, grid, S), device=device)
    whole = redraw.inverse_cdf_grid(sll, kvec, grid)
    cdf = redraw.posterior_cdf(sll)
    for rows in (slice(0, 1), slice(0, 7), slice(13, 64)):
        assert torch.equal(redraw.inverse_cdf_grid(sll[rows], kvec, grid), whole[rows])
        assert torch.equal(redraw.posterior_cdf(sll[rows]), cdf[rows])
    perm = torch.as_tensor(rng.permutation(64), device=device)
    assert torch.equal(redraw.inverse_cdf_grid(sll[perm], kvec, grid), whole[perm])
    assert torch.equal(redraw.posterior_cdf(sll[perm]), cdf[perm])


def test_redraw_kernel_refuses_what_it_cannot_take(device):
    from gp_dla_detection_tpu_torch.ops import redraw

    sll = torch.zeros((2, 50), device=device)
    kvec = torch.arange(50, device=device)
    with pytest.raises(ValueError, match="float32-only"):
        redraw.inverse_cdf_grid(sll.double(), kvec)
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        redraw.inverse_cdf_grid(sll[None], kvec)
    with pytest.raises(ValueError, match="1-D"):
        redraw.inverse_cdf_grid(sll, kvec[None])
    with pytest.raises(ValueError, match="holds at most"):
        redraw.inverse_cdf_grid(sll, kvec, redraw.max_grid_size(device) + 1)
    with pytest.raises(ValueError, match=r"2\*\*23"):
        redraw.inverse_cdf_grid(torch.zeros((1, redraw.MAX_SAMPLES), device=device), kvec)
    assert redraw.inverse_cdf_grid(sll[:0], kvec).shape == (0, 50)


def cddf_sums_inputs(device, B=6, S=3000, structured=True, seed=0):
    """The sums' inputs as the reducer makes them: the bases of a redraw
    at R = 4 and z rows from a redshift range, monotone in the offset
    (``structured``), or random ones of both."""
    from gp_dla_detection_tpu_torch.cddf_inputs import CDDFReductionSpec
    from gp_dla_detection_tpu_torch.ops import redraw

    spec = CDDFReductionSpec()
    rng = np.random.default_rng(seed)
    draw_idx, grid = replicate_draw_pattern(S, 256, 4)
    cols = rng.permutation(grid)[draw_idx]
    sll = torch.as_tensor(redraw_rows(rng, B, S), device=device)
    if structured:
        base = redraw.inverse_cdf_grid(sll, torch.as_tensor(cols, device=device), grid)
    else:
        base = torch.as_tensor(rng.integers(0, S, (B, S)), device=device)
    p = torch.as_tensor(rng.dirichlet(np.full(S, 0.05), B) * rng.uniform(0, 1, (B, 1)),
                        device=device)
    p2s = torch.as_tensor(np.where(rng.uniform(size=(B, S)) < 0.3,
                                   rng.uniform(1e-4, 0.25, (B, S)), 0.0), device=device)
    offsets = rng.uniform(size=S)
    if structured:
        min_z = rng.uniform(2.0, 3.0, (B, 1))
        zf = min_z + rng.uniform(0.8, 2.4, (B, 1)) * offsets[None, :]
        zloc = np.floor(zf * spec.z_bins_per_unit) - np.floor(min_z * spec.z_bins_per_unit)
    else:
        zloc = rng.integers(-2, spec.n_z_window + 2, (B, S))
    zloc = torch.as_tensor(zloc, device=device).to(torch.int64)
    lnhi = rng.uniform(19.8, 23.2, S)
    tab = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(dt)
    nu = 10.0 ** (lnhi - spec.nu_log_offset)
    args = (p, p2s, base, zloc, tab(np.argsort(cols, kind="stable"), torch.int64),
            tab(spec.lnhi_bin_index(lnhi, "a"), torch.int64),
            tab(spec.lnhi_bin_index(lnhi, "b"), torch.int64),
            tab(nu, torch.float64), tab(nu**2, torch.float64),
            spec.p_sample_min, spec.p_switch, spec.n_z_window, spec.n_lnhi)
    return args


@pytest.mark.parametrize("structured", [True, False])
def test_cddf_sums_kernel_matches_plain_and_repeats(device, structured):
    from gp_dla_detection_tpu_torch import cddf_inputs

    args = cddf_sums_inputs(device, structured=structured)
    before = cddf_inputs.launch_count
    runs = [cddf_inputs.cddf_sums(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert cddf_inputs.launch_count == before + 3
    acc, hist = runs[0]
    for a, h in runs[1:]:
        assert torch.equal(a, acc) and torch.equal(h, hist)
    ref_acc, ref_hist = cddf_inputs.cddf_sums_reference(*args)
    assert hist.shape == ref_hist.shape
    for got, ref in ((acc, ref_acc), (hist, ref_hist)):
        rel = ((got - ref).abs() / ref.abs().clamp(min=1e-300)).max()
        assert float(rel) <= 1e-12
    # rows alone: a batch of one and the rows permuted give the same bits
    B = acc.shape[0]
    perm = torch.as_tensor(np.random.default_rng(1).permutation(B), device=device)
    row_args = lambda rows: [a[rows] if torch.is_tensor(a) and a.shape[0] == B and a.dim() == 2
                             else a for a in args]
    a1, h1 = cddf_inputs.cddf_sums(*row_args(slice(2, 3)))
    assert torch.equal(a1, acc[2:3]) and torch.equal(h1, hist[2:3])
    ap, hp = cddf_inputs.cddf_sums(*row_args(perm))
    assert torch.equal(ap, acc[perm]) and torch.equal(hp, hist[perm])


def run_inputs(device, B=5, S=3001, seed=4):
    """The sums' inputs with long runs of equal bases along the order (a
    peaked posterior redrawn: a few bases take most grid cells), at an S
    that is not a multiple of 4."""
    from gp_dla_detection_tpu_torch.cddf_inputs import CDDFReductionSpec

    spec = CDDFReductionSpec()
    rng = np.random.default_rng(seed)
    grid = 751
    cols = rng.integers(0, grid, S)
    # base of grid cell g: ascending in g, with runs of up to 120 cells
    n_cells = min(24, S)
    cells = np.sort([rng.choice(S, n_cells, replace=False) for _ in range(B)], axis=1)
    g = np.take_along_axis(cells, np.sort(rng.integers(0, n_cells, (B, grid)), axis=1), axis=1)
    base = torch.as_tensor(np.take_along_axis(g, np.broadcast_to(cols, (B, S)), axis=1),
                           device=device)
    p = torch.as_tensor(rng.dirichlet(np.full(S, 0.05), B) * rng.uniform(0, 1, (B, 1)),
                        device=device)
    p2s = torch.as_tensor(np.where(rng.uniform(size=(B, S)) < 0.5,
                                   rng.uniform(1e-4, 0.25, (B, S)), 0.0), device=device)
    zloc = torch.as_tensor(rng.integers(-2, spec.n_z_window + 2, (B, S)), device=device)
    lnhi = rng.uniform(19.8, 23.2, S)
    tab = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(dt)
    nu = 10.0 ** (lnhi - spec.nu_log_offset)
    return (p, p2s, base, zloc, tab(np.argsort(cols, kind="stable"), torch.int64),
            tab(spec.lnhi_bin_index(lnhi, "a"), torch.int64),
            tab(spec.lnhi_bin_index(lnhi, "b"), torch.int64),
            tab(nu, torch.float64), tab(nu**2, torch.float64),
            spec.p_sample_min, spec.p_switch, spec.n_z_window, spec.n_lnhi)


def test_cddf_sums_kernel_chunks_runs_across_their_edges(device):
    """Runs of equal bases across the chunk edges, S = 3001: the kernel in
    the order of ``cddf_sums_chunked`` (acc and hist bit for bit), within
    1e-12 of the plain sums, and each row alone and permuted the same."""
    from gp_dla_detection_tpu_torch import cddf_inputs

    args = run_inputs(device)
    S = args[0].shape[1]
    plan = cddf_inputs.cddf_chunk_plan(S, args[2], args[4])
    assert plan.n_chunks == 8 and S % 4
    # the data covers what it is for: chunk edges inside runs, moved
    assert (plan.run_bounds[:, 1:-1] != plan.sample_bounds[None, 1:-1]).any()
    acc, hist = cddf_inputs.cddf_sums(*args)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want_acc, want_hist = cddf_inputs.cddf_sums_chunked(*cpu)
    assert torch.equal(acc.cpu(), want_acc)
    assert torch.equal(hist.cpu(), want_hist)
    ref_acc, ref_hist = cddf_inputs.cddf_sums_reference(*args)
    for got, ref in ((acc, ref_acc), (hist, ref_hist)):
        assert float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max()) <= 1e-12
    B = acc.shape[0]
    perm = torch.as_tensor(np.random.default_rng(2).permutation(B), device=device)
    for rows in (slice(1, 2), slice(2, 5), perm):
        part = [a[rows] if torch.is_tensor(a) and a.dim() == 2 else a for a in args]
        a1, h1 = cddf_inputs.cddf_sums(*part)
        assert torch.equal(a1, acc[rows]) and torch.equal(h1, hist[rows])


@pytest.mark.parametrize("S", [1, 257, 2051])
def test_cddf_sums_kernel_small_and_ragged_rows(device, S):
    """One chunk (S = 1), a second chunk of one sample (S = 257) and eight
    chunks of 257 with a last of 252 (S = 2051): the kernel against its
    plain version and its own order."""
    from gp_dla_detection_tpu_torch import cddf_inputs

    args = run_inputs(device, B=3, S=S, seed=S)
    acc, hist = cddf_inputs.cddf_sums(*args)
    want_acc, want_hist = cddf_inputs.cddf_sums_chunked(
        *[a.cpu() if torch.is_tensor(a) else a for a in args])
    assert torch.equal(acc.cpu(), want_acc) and torch.equal(hist.cpu(), want_hist)


def test_cddf_sums_kernel_refuses_what_it_cannot_take(device):
    from gp_dla_detection_tpu_torch import cddf_inputs

    args = list(cddf_sums_inputs(device, B=2, S=300))
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="float64"):
        cddf_inputs.cddf_sums(*bad)
    bad = list(args)
    bad[4] = args[4][:-1]
    with pytest.raises(ValueError, match="int64"):
        cddf_inputs.cddf_sums(*bad)
    bad = list(args)
    bad[-2] = 4096
    with pytest.raises(ValueError, match="shared memory"):
        cddf_inputs.cddf_sums(*bad)


def chain_batches_agree(device, batches, samples=None):
    """The fused lean chain with the CDDF inputs on the card (the kernels,
    R = 4) at each of ``batches``: the same bits as at batch 11, the
    kernels launched once per batch.  ``samples``: (offsets, nhis) in
    place of the problem's own."""
    import torch_distributed_worker as worker
    from gp_dla_detection_tpu_torch import cddf_inputs
    from gp_dla_detection_tpu_torch.ops import redraw
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi_lean

    params, model, spectra, offsets, nhis, prior_z, _ = worker.port_problem()
    if samples is not None:
        offsets, nhis = samples
    model = model.to(device=device, dtype=torch.float32)

    def run(batch):
        before = (redraw.launch_count, cddf_inputs.launch_count)
        res = process_spectra_multi_lean(
            model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params,
            batch_size=batch, store_cddf_inputs=True,
        )
        n = -(-len(spectra) // batch)
        assert (redraw.launch_count, cddf_inputs.launch_count) == (before[0] + n, before[1] + n)
        fields = worker.multi_fields(res)
        fields.update(cddf_hist=res.cddf_inputs.hist, cddf_ex=res.cddf_inputs.ex)
        return fields

    ref = run(11)
    for batch in batches:
        got = run(batch)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"batch {batch}: {k}")


def test_fused_chain_does_not_depend_on_the_batch(device):
    """The fused lean chain with the CDDF inputs on the card (the kernels,
    R = 4) gives the same bits at every batch size and in every run."""
    chain_batches_agree(device, (1, 2, 4, 11))


def test_fused_chain_does_not_depend_on_the_batch_at_an_odd_S(device):
    """The same at S = 317: no float32 or float64 row of the (B, S)
    tensors but the first starts on a 16-byte boundary, and the CDDF sums
    split the samples into two chunks, the second not full."""
    import torch_distributed_worker as worker

    offsets, nhis = worker.samples_320()
    chain_batches_agree(device, (1, 3, 11), (offsets[:317], nhis[:317]))


def test_fused_chain_issue_waits_for_nothing_with_its_spans_on(device, monkeypatch):
    """The chain's ``issue`` (the kernels, R = 4, the CDDF inputs) under
    ``torch.cuda.set_sync_debug_mode("error")`` with the span recorder
    and ``torch.profiler`` on: no span waits for the card, and every
    stage's span is there once a batch."""
    import torch_distributed_worker as worker
    from gp_dla_detection_tpu_torch.parallel import batches, sharded_multi
    from gp_dla_detection_tpu_torch.utils import observability

    params, model, spectra, offsets, nhis, prior_z, _ = worker.port_problem()
    model = model.to(device=device, dtype=torch.float32)

    def run():
        return sharded_multi.process_spectra_multi_lean(
            model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params,
            batch_size=4, store_cddf_inputs=True,
        )

    run()   # the kernels built and loaded outside the strict issue
    real = batches.run_pipelined_split

    def strict_split(items, upload, issue, complete, **kw):
        def strict(item, uploaded):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return issue(item, uploaded)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        real(items, upload, strict, complete, **kw)

    monkeypatch.setattr(batches, "run_pipelined_split", strict_split)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with observability.recording() as rec, torch.profiler.profile(activities=acts):
        run()
    n = -(-len(spectra) // 4)
    names = [s.name for s in rec.drain()]
    for stage in ("single", "redraw", "pair", "cddf", "fetch"):
        assert names.count(f"gpdla.stage.{stage}") == n, stage


F64_BOUND = 5e-4          # float32 chain vs the float64 plain path (chip_smoke.py)
DECISION_MARGIN = 0.01    # no 3-class flip where float64's winner holds 0.9 + this
PAIR_RTOL, PAIR_ATOL = 5e-4, 5e-3


def lines31_problem(device, n, samples):
    """``n`` sightlines of the benchmark's 31-line cell (``gpbench``'s
    generator on the card, the configuration's widths, ``samples`` QMC
    samples): (run, gpbench.program)."""
    return cell_problem(device, "multi31_b1024", n, samples)


def cell_problem(device, name, n, samples):
    """``n`` sightlines of the benchmark's cell ``name``, as
    :func:`lines31_problem`."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from gpbench import harness, program

    cell = harness.sized_cell(harness.load_cell(name), pool_size=n, samples=samples)
    r = harness.Run(cell, 2147483777, 0.0, False, device, None)
    harness.make_inputs(r)
    r.params = program.parameters(cell.cfg)
    return r, program


def lines31_chain(r, program, batch, dtype="float32", backend=None, replicates=None,
                  num_lines=31):
    """The fused lean chain with CDDF inputs on the whole pool:
    (fields, counters' increments)."""
    import dataclasses

    import torch_distributed_worker as worker
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig

    counters = ("launch_count", "pair_launch_count", "full_grid_launch_count",
                "full_grid_pair_launch_count")
    before = [getattr(evidence, c) for c in counters]
    res = program.process_multi(
        program.gp_model(r.model, r.device, getattr(torch, dtype)), r.samples[0], r.samples[1],
        program.spectra(r.pool, np.arange(len(r.pool["z_qso"]))), r.catalogue[0],
        r.catalogue[1], params=dataclasses.replace(r.params, num_lines=num_lines),
        config=ShardedRunConfig(per_device_batch=batch, dtype=dtype, backend=backend,
                                store_sample_likelihoods=False, store_cddf_inputs=True,
                                base_replicates=replicates, device=str(r.device)),
    )
    fields = worker.multi_fields(res)
    fields.update(cddf_hist=res.cddf_inputs.hist, cddf_ex=res.cddf_inputs.ex)
    return fields, {c: getattr(evidence, c) - b for c, b in zip(counters, before)}


def test_chain_at_31_lines_does_not_depend_on_the_batch_and_runs_the_full_grid(device):
    """The chain at 31 lines (both kernels on the full grid, R = 4, CDDF
    inputs) at B = 128 and 256: the same bits, one full-grid launch of
    each kernel a batch, the evidence stages' spans at ``lines`` 31 and
    ``window`` 0; at 3 lines no full-grid launch, the spans at the
    driver's window."""
    import dataclasses

    from gp_dla_detection_tpu_torch.inference import kernel_sample_window
    from gp_dla_detection_tpu_torch.utils import observability

    r, program = lines31_problem(device, 512, 10_000)

    def stage_ids(rec):
        return {(s.name, s.ids["lines"], s.ids["window"]) for s in rec.drain()
                if s.name in ("gpdla.stage.single", "gpdla.stage.pair")}

    runs = {}
    for batch in (128, 256):
        with observability.recording() as rec:
            runs[batch], counts = lines31_chain(r, program, batch)
        n = 512 // batch
        assert counts == {"launch_count": n, "pair_launch_count": n,
                          "full_grid_launch_count": n, "full_grid_pair_launch_count": n}
        assert stage_ids(rec) == {("gpdla.stage.single", 31, 0), ("gpdla.stage.pair", 31, 0)}
    for k in ("log_likelihoods_no_dla", "log_likelihoods_dla", "p_dlas", "log_likelihoods_dla2",
              "model_posteriors"):
        assert np.isfinite(runs[128][k]).all(), k
    for k, v in runs[128].items():
        np.testing.assert_array_equal(runs[256][k], v, err_msg=k)
    with observability.recording() as rec:
        _, counts = lines31_chain(r, program, 256, num_lines=3)
    assert counts == {"launch_count": 2, "pair_launch_count": 2, "full_grid_launch_count": 0,
                      "full_grid_pair_launch_count": 0}
    window = kernel_sample_window(r.samples[0], r.pool["wavelengths"].shape[1],
                                  dataclasses.replace(r.params, num_lines=3))
    assert window > 0
    assert stage_ids(rec) == {("gpdla.stage.single", 3, window), ("gpdla.stage.pair", 3, window)}


def test_chain_at_31_lines_is_within_the_float32_gates_of_the_float64_plain_path(device):
    """The chain at 31 lines on the card (float32, the kernels, R = 1)
    against the float64 plain path on the card: the evidences within
    F64_BOUND normalized, no confident 3-class decision flipped, the pair
    evidences within the pair gate (chip_smoke.py phase 6)."""
    r, program = lines31_problem(device, 8, 2000)
    f32, _ = lines31_chain(r, program, 8, replicates=1)
    f64, counts = lines31_chain(r, program, 8, dtype="float64", backend="torch")
    assert counts["launch_count"] == 0
    for k in ("log_likelihoods_no_dla", "log_likelihoods_dla"):
        err = np.abs(f32[k] - f64[k]) / np.maximum(np.abs(f64[k]), 1.0)
        assert err.max() < F64_BOUND, (k, err.max())
    post32, post64 = f32["model_posteriors"], f64["model_posteriors"]
    win64 = np.argmax(post64, axis=1)
    sure = post64[np.arange(len(win64)), win64] > 0.9 + DECISION_MARGIN
    assert not (sure & (np.argmax(post32, axis=1) != win64)).any()
    a, b = f32["log_likelihoods_dla2"], f64["log_likelihoods_dla2"]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    assert (np.abs(a[fin] - b[fin]) <= PAIR_ATOL + PAIR_RTOL * np.abs(b[fin])).all()


def test_full_mode_reduces_and_reorders_on_the_card(device, monkeypatch):
    """The single driver's full mode at B = 128 on 512 sightlines of the
    benchmark's 3-line cell (10,000 samples, the windowed kernel): the
    rows it returns are the host reorder of the kernel's rows bit for
    bit; the evidence is the lean mode's bit for bit and within float32
    rounding of the host's reduction of the rows
    (``finalize_posteriors``); one evidence reduction and one kernel
    launch a batch in each mode."""
    from gp_dla_detection_tpu_torch.inference import finalize_posteriors, kernel_sample_window
    from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig, sharded_inference, streaming

    r, program = cell_problem(device, "single_b1024", 512, 10_000)
    offsets = np.asarray(r.samples[0])
    assert kernel_sample_window(offsets, r.pool["wavelengths"].shape[1], r.params)
    kernel_rows = []
    real = sharded_inference.batch_log_likelihoods

    def recorded(*args, **kw):
        out = real(*args, **kw)
        kernel_rows.append(out["sample_log_likelihoods_dla"].cpu())
        return out

    monkeypatch.setattr(sharded_inference, "batch_log_likelihoods", recorded)
    model = program.gp_model(r.model, r.device, torch.float32)

    def run(lean):
        kernel_rows.clear()
        before = (streaming.evidence_reduce_count, evidence.launch_count)
        res = program.process_single(
            model, r.samples[0], r.samples[1], program.spectra(r.pool, np.arange(512)),
            r.catalogue[0], r.catalogue[1] >= 1, params=r.params,
            config=ShardedRunConfig(per_device_batch=128, store_sample_likelihoods=not lean,
                                    device=str(r.device)),
        )
        assert (streaming.evidence_reduce_count - before[0],
                evidence.launch_count - before[1]) == (4, 4)
        return res

    full = run(lean=False)
    order = np.argsort(offsets, kind="stable")
    host = np.concatenate([sharded_inference.in_sample_order(x.numpy(), order)
                           for x in kernel_rows])
    assert host.dtype == np.float32 and np.isfinite(host).all()
    np.testing.assert_array_equal(full.sample_log_likelihoods_dla, host)
    lean = run(lean=True)
    for k in ("log_likelihoods_dla", "p_dlas", "log_likelihoods_no_dla"):
        np.testing.assert_array_equal(getattr(full, k), getattr(lean, k), err_msg=k)
    on_host = finalize_posteriors(full.log_priors_no_dla, full.log_priors_dla,
                                  full.log_likelihoods_no_dla, host)["log_likelihoods_dla"]
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(full.log_likelihoods_dla, on_host, rtol=4 * eps, atol=4 * eps)


def null_inputs(device, B=64, P=1274, k=20, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(B, P)) > 0.1
    mask[min(3, B - 1)] = False   # a spectrum with no valid pixel
    arrays = (rng.normal(1.0, 0.3, (B, P)),
              1.0 + 0.1 * np.sin(np.arange(P) / 30.0)[None, :].repeat(B, 0),
              rng.normal(size=(B, P, k)) * 0.08, rng.uniform(0.01, 0.2, (B, P)))
    return [torch.as_tensor(a, device=device).float() for a in arrays] + [
        torch.as_tensor(mask, device=device)]


def test_null_evidence_kernel_matches_plain_and_the_batch(device):
    from gp_dla_detection_tpu_torch.ops import low_rank_mvn

    args = null_inputs(device)
    before = low_rank_mvn.launch_count
    out = low_rank_mvn.null_log_likelihoods(*args)
    torch.cuda.synchronize()
    assert low_rank_mvn.launch_count == before + 1
    plain = low_rank_mvn.null_log_likelihoods_reference(*args)
    exact = low_rank_mvn.null_log_likelihoods_reference(*[a.double() if a.is_floating_point()
                                                          else a for a in args])
    assert normalized_err(out, plain) < BOUND
    err = lambda x: float((x.double() - exact).abs().max())
    assert err(out) <= 2 * err(plain) + 1e-4, (err(out), err(plain))
    # a row's bits depend on that row alone: alone, shifted by one, permuted
    perm = torch.as_tensor(np.random.default_rng(3).permutation(64), device=device)
    for rows in (slice(0, 1), slice(1, 2), slice(1, 57), perm):
        assert torch.equal(low_rank_mvn.null_log_likelihoods(*[a[rows] for a in args]), out[rows])


@pytest.mark.parametrize("P,k", [(1273, 21), (1273, 20), (37, 3), (1, 1)])
def test_null_evidence_kernel_at_odd_strides(device, P, k):
    """P k not a multiple of 4 (each spectrum's M starts off a 16-byte
    boundary but every fourth), slices of 160 pixels with a short last one
    (P = 1273), fewer slices than warps (P = 37) and one pixel: against
    the plain version and float64; each row alone, shifted and permuted
    the same."""
    from gp_dla_detection_tpu_torch.ops import low_rank_mvn

    args = null_inputs(device, B=13, P=P, k=k, seed=P + k)
    out = low_rank_mvn.null_log_likelihoods(*args)
    plain = low_rank_mvn.null_log_likelihoods_reference(*args)
    exact = low_rank_mvn.null_log_likelihoods_reference(*[a.double() if a.is_floating_point()
                                                          else a for a in args])
    assert normalized_err(out, plain) < BOUND
    err = lambda x: float((x.double() - exact).abs().max())
    assert err(out) <= 2 * err(plain) + 1e-4, (err(out), err(plain))
    perm = torch.as_tensor(np.random.default_rng(5).permutation(13), device=device)
    for rows in (slice(0, 1), slice(1, 2), slice(3, 4), slice(1, 12), perm):
        assert torch.equal(low_rank_mvn.null_log_likelihoods(*[a[rows] for a in args]), out[rows])


def test_null_evidence_kernel_reads_strided_inputs(device):
    """mu and M as the model's interpolation gives them, columns of one
    (B, P, k + 2) tensor, and y a column of a wider one: the same bits as
    from contiguous copies; M whose columns lie apart, or whose pixel
    stride is beyond the kernel's, is copied first: the same bits."""
    from gp_dla_detection_tpu_torch.ops import low_rank_mvn

    y, mu, M, d, mask = null_inputs(device, B=9, P=1273, k=20, seed=11)
    want = low_rank_mvn.null_log_likelihoods(y, mu, M, d, mask)
    packed = torch.cat([mu[..., None], torch.zeros_like(mu)[..., None], M], dim=-1)
    mu_s, M_s = packed[..., 0], packed[..., 2:]
    assert M_s.stride() == (1273 * 22, 22, 1) and mu_s.stride() == (1273 * 22, 22)
    y_s = torch.stack([y, y], dim=-1)[..., 1]
    for rows in (slice(None), slice(1, 2), slice(3, 8)):
        got = low_rank_mvn.null_log_likelihoods(y_s[rows], mu_s[rows], M_s[rows], d[rows],
                                                mask[rows])
        assert torch.equal(got, want[rows])
    apart = M.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(low_rank_mvn.null_log_likelihoods(y, mu, apart, d, mask), want)
    wide = torch.cat([M, torch.zeros_like(M)], dim=-1)[..., :20]
    assert torch.equal(low_rank_mvn.null_log_likelihoods(y, mu, wide, d, mask), want)


def test_null_evidence_kernel_refuses_what_it_cannot_take(device):
    from gp_dla_detection_tpu_torch.ops import low_rank_mvn

    y, mu, M, d, mask = null_inputs(device, B=2, P=100)
    with pytest.raises(ValueError, match="float32-only"):
        low_rank_mvn.null_log_likelihoods(y.double(), mu, M, d, mask)
    with pytest.raises(ValueError, match="1 <= k"):
        low_rank_mvn.null_log_likelihoods(y, mu, torch.zeros((2, 100, 22), device=device), d, mask)
    with pytest.raises(ValueError, match="tensors on"):
        low_rank_mvn.null_log_likelihoods(y, mu, M, d[:, :50], mask)
