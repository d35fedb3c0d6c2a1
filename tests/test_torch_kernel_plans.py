"""The host-side plans of the port's fixed-order kernels, on the CPU.

``cddf_inputs.cddf_chunk_plan`` splits a row of the CDDF sums into chunks
(``csrc/cddf.cu``), ``ops.low_rank_mvn.null_slice_plan`` the null
evidence's pixels into slices (``csrc/null_evidence.cu``).  Both depend
on the row alone, never on the batch.  The kernels' orders of additions,
emulated in float64 with torch, give the plain versions' sums: the CDDF
sums through ``cddf_sums_chunked``, the null evidence through the sliced
Gram of z = (M, y - mu) that the kernel forms.

The base redraw (``csrc/redraw.cu``): its scan in the kernel's order
(``ops.redraw.posterior_cdf_in_kernel_order``, float32) near float64 and
its draws against JAX's ``device_inverse_cdf_grid``; its division-free
grid cell (``grid_cell_by_table``) equal to the plain version's at and
around every cell boundary.  The kernel against the emulation, bit for
bit, is in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import multi_dla as jmd
from gp_dla_detection_tpu_torch import cddf_inputs
from gp_dla_detection_tpu_torch.ops import low_rank_mvn, redraw

AGREE_F32 = 0.999        # tests/test_torch_redraw.py: float32 knife edges
H100_MAX_GRID = 58_015   # gpdla_redraw_max_grid on an H100 (232,448 B of shared memory a block)


def sums_inputs(B, S, sorted_bases=True, seed=0):
    """The CDDF sums' inputs on the CPU: bases that ascend along the order
    in runs (a redraw's) or random ones."""
    spec = cddf_inputs.CDDFReductionSpec()
    rng = np.random.default_rng(seed)
    grid = max(1, S // 4)
    cols = rng.integers(0, grid, S)
    if sorted_bases:
        g = np.sort(rng.integers(0, S, (B, grid)), axis=1)
        base = np.take_along_axis(g, np.broadcast_to(cols, (B, S)), axis=1)
    else:
        base = rng.integers(0, S, (B, S))
    lnhi = rng.uniform(19.8, 23.2, S)
    nu = 10.0 ** (lnhi - spec.nu_log_offset)
    t = torch.as_tensor
    return (t(rng.dirichlet(np.full(S, 0.05), B) * rng.uniform(0, 1, (B, 1))),
            t(np.where(rng.uniform(size=(B, S)) < 0.4, rng.uniform(1e-4, 0.25, (B, S)), 0.0)),
            t(base), t(rng.integers(-2, spec.n_z_window + 2, (B, S))),
            t(np.argsort(cols, kind="stable")), t(spec.lnhi_bin_index(lnhi, "a")),
            t(spec.lnhi_bin_index(lnhi, "b")), t(nu), t(nu**2),
            spec.p_sample_min, spec.p_switch, spec.n_z_window, spec.n_lnhi)


@pytest.mark.parametrize("S", [1, 255, 256, 257, 2048, 3001, 10000, 10001, 100003])
def test_cddf_chunk_plan_covers_the_row_in_at_most_a_cluster(S):
    plan = cddf_inputs.cddf_chunk_plan(S)
    C, L = plan.n_chunks, plan.chunk_len
    assert 1 <= C <= cddf_inputs.CHUNKS_MAX and L >= cddf_inputs.CHUNK_MIN
    assert (C - 1) * L < S <= C * L
    assert plan.sample_bounds[0] == 0 and plan.sample_bounds[-1] == S
    assert np.all(np.diff(plan.sample_bounds) > 0)
    # the bases of a batch of any size leave the split of the samples alone
    for B in (1, 7):
        with_bases = cddf_inputs.cddf_chunk_plan(S, torch.zeros((B, S), dtype=torch.int64),
                                                 torch.arange(S))
        assert (with_bases.n_chunks, with_bases.chunk_len) == (C, L)
        assert np.array_equal(with_bases.sample_bounds, plan.sample_bounds)
        assert with_bases.run_bounds.shape == (B, C + 1)


@pytest.mark.parametrize("sorted_bases", [True, False])
def test_cddf_run_bounds_depend_on_the_row_alone(sorted_bases):
    """A row's chunk edges along the order are the first run starts at or
    after the sample edges, and the same in any batch."""
    args = sums_inputs(6, 3001, sorted_bases)
    base, order = args[2], args[4]
    plan = cddf_inputs.cddf_chunk_plan(3001, base, order)
    keys = base[:, order].numpy()
    for b in range(6):
        starts = np.flatnonzero(np.r_[True, keys[b, 1:] != keys[b, :-1]])
        for c, lo in enumerate(plan.sample_bounds[:-1]):
            later = starts[starts >= lo]
            assert plan.run_bounds[b, c] == (later[0] if len(later) else 3001)
        alone = cddf_inputs.cddf_chunk_plan(3001, base[b:b + 1], order)
        assert np.array_equal(alone.run_bounds[0], plan.run_bounds[b])
    perm = np.random.default_rng(1).permutation(6)
    permuted = cddf_inputs.cddf_chunk_plan(3001, base[perm], order)
    assert np.array_equal(permuted.run_bounds, plan.run_bounds[perm])
    if sorted_bases:
        # redrawn bases: some chunk edge falls inside a run and moves
        assert (plan.run_bounds[:, 1:-1] != plan.sample_bounds[None, 1:-1]).any()


@pytest.mark.parametrize("S,sorted_bases", [(3001, True), (3001, False), (257, True),
                                            (10001, True)])
def test_cddf_sums_in_the_kernel_order_equal_the_plain_sums(S, sorted_bases):
    """The chunked order of ``csrc/cddf.cu`` in float64 against the plain
    ``scatter_add_`` sums: within 1e-13 relative (they differ only in
    the grouping of the additions), acc bit for bit (both add a base's
    columns in order on the CPU), and a row's sums the same in any
    batch."""
    args = sums_inputs(4, S, sorted_bases, seed=S)
    acc, hist = cddf_inputs.cddf_sums_chunked(*args)
    ref_acc, ref_hist = cddf_inputs.cddf_sums_reference(*args)
    assert hist.shape == ref_hist.shape
    for got, ref in ((acc, ref_acc), (hist, ref_hist)):
        assert float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max()) <= 1e-13
    rows = [a[1:3] if torch.is_tensor(a) and a.dim() == 2 else a for a in args]
    a2, h2 = cddf_inputs.cddf_sums_chunked(*rows)
    assert torch.equal(a2, acc[1:3]) and torch.equal(h2, hist[1:3])


@pytest.mark.parametrize("P", [1, 31, 32, 100, 257, 1273, 1274, 10000])
def test_null_slice_plan_covers_the_pixels_in_at_most_a_block(P):
    n, length = low_rank_mvn.null_slice_plan(P)
    assert 1 <= n <= low_rank_mvn.SLICES_MAX and length % low_rank_mvn.SLICE_ALIGN == 0
    assert (n - 1) * length < P <= n * length
    assert low_rank_mvn.null_slice_plan(P) == (n, length)


def sliced_null_evidence(y, mu, M, d, mask):
    """The null evidence as ``csrc/null_evidence.cu`` sums it, in the
    input dtype: per slice of ``null_slice_plan`` the Gram of z = (M,
    y - mu) weighted by w = mask / d, and the sums of mask log d and of
    mask, each over the slice's pixels in order; the slices added in
    order; B = I + G[:k, :k], b = G[:k, k], quad0 = G[k, k]."""
    P, k = M.shape[-2:]
    zero = torch.zeros((), dtype=y.dtype)
    v = mask.to(torch.bool)
    d_safe = torch.where(v, d, torch.ones((), dtype=y.dtype))
    w = torch.where(v, 1.0 / d_safe, zero)
    z = torch.cat([M, torch.where(v, y - mu, zero)[..., None]], dim=-1)
    ld = torch.where(v, torch.log(d_safe), zero)
    n_slices, length = low_rank_mvn.null_slice_plan(P)
    G = logdet_d = n_eff = 0
    for s in range(n_slices):
        sl = slice(s * length, min(P, (s + 1) * length))
        zs = z[:, sl]
        G = G + torch.einsum("bpi,bpj->bij", zs * w[:, sl, None], zs)
        logdet_d = logdet_d + ld[:, sl].sum(dim=1)
        n_eff = n_eff + v[:, sl].sum(dim=1).to(y.dtype)
    B = G[:, :k, :k] + torch.eye(k, dtype=y.dtype)
    quad, logdet_b = low_rank_mvn.batched_spd_quad_logdet(B, G[:, :k, k])
    return -0.5 * (G[:, k, k] - quad + logdet_d + logdet_b + n_eff * low_rank_mvn.LOG_2PI)


@pytest.mark.parametrize("P,k", [(1274, 20), (1273, 21), (37, 3)])
def test_null_evidence_in_the_kernel_order_equals_the_plain_version(P, k):
    """The kernel's sliced Gram of (M, y - mu) in float64 gives the plain
    version's evidence to 1e-12 relative, a spectrum with no valid pixel
    included, and a spectrum's value the same in any batch."""
    rng = np.random.default_rng(P)
    B = 5
    mask = rng.uniform(size=(B, P)) > 0.1
    mask[2] = False
    args = [torch.as_tensor(a) for a in (
        rng.normal(1.0, 0.3, (B, P)), 1.0 + 0.1 * np.sin(np.arange(P) / 30.0)[None, :].repeat(B, 0),
        rng.normal(size=(B, P, k)) * 0.08, rng.uniform(0.01, 0.2, (B, P)), mask)]
    got = sliced_null_evidence(*args)
    want = low_rank_mvn.null_log_likelihoods_reference(*args)
    assert torch.isfinite(got).all()
    assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) < 1e-12
    assert torch.equal(sliced_null_evidence(*[a[3:4] for a in args]), got[3:4])


def posterior_rows(B, S, seed=0):
    """float32 (B, S) rows: broad and peaked posteriors, a spike, a NaN
    row, an all -inf row, scattered NaN and -inf entries."""
    rng = np.random.default_rng(seed)
    sll = rng.normal(-50.0, 4.0, (B, S))
    sll[1 % B] = rng.normal(-50.0, 0.3, S)
    sll[2 % B, rng.integers(S)] += 200.0
    sll[3 % B] = np.nan
    sll[4 % B] = -np.inf
    sll[5 % B, rng.integers(0, S, S // 10 + 1)] = np.nan
    sll[6 % B, rng.integers(0, S, S // 10 + 1)] = -np.inf
    return sll.astype(np.float32)


def float32_running_sum_cdf(sll):
    """The plain float32 scan: a running float32 sum (numpy's cumsum in
    float32; torch's CPU cumsum accumulates in float64)."""
    x = np.where(np.isnan(sll), -np.inf, sll)
    m = x.max(axis=1, keepdims=True)
    w = np.exp(x - np.where(np.isfinite(m), m, 0)).astype(np.float32)
    w[(m == -np.inf)[:, 0]] = 1.0
    c = np.cumsum(w, axis=1, dtype=np.float32)
    return c / c[:, -1:]


@pytest.mark.parametrize("S", [1, 4095, 4096, 4097, 10000, 10001, 100003])
def test_redraw_cdf_in_the_kernel_order_is_near_float64(S):
    """The kernel's tiled scan in float32: within twice the plain float32
    scan's distance of the float64 CDF, the last entry exactly 1, the
    draws the grid counts of it, and a row's bits the same in any
    batch."""
    sll = posterior_rows(8, S, seed=S)
    x = torch.as_tensor(sll)
    cdf = redraw.posterior_cdf_in_kernel_order(x)
    exact = redraw.posterior_cdf_reference(x.double())
    err = float((cdf.double() - exact).abs().max())
    plain = float(np.abs(float32_running_sum_cdf(sll) - exact.numpy()).max())
    assert cdf.dtype == torch.float32 and torch.isfinite(cdf).all()
    assert err <= 2 * plain, (err, plain)
    assert torch.equal(cdf[:, -1], torch.ones(8))
    for rows in (slice(0, 1), slice(5, 6), slice(2, 7)):
        assert torch.equal(redraw.posterior_cdf_in_kernel_order(x[rows]), cdf[rows])
    perm = torch.as_tensor(np.random.default_rng(1).permutation(8))
    assert torch.equal(redraw.posterior_cdf_in_kernel_order(x[perm]), cdf[perm])
    grid = max(1, S // 4)
    kvec = torch.as_tensor(np.random.default_rng(2).integers(0, grid, S))
    draws = redraw.grid_counts_reference(cdf, grid)[:, kvec]
    assert int(draws.min()) >= 0 and int(draws.max()) <= S - 1


@pytest.mark.parametrize("R", [1, 4])
def test_redraw_draws_in_the_kernel_order_match_jax(R):
    """The draws of the kernel's float32 CDF against JAX's float32
    ``device_inverse_cdf_grid`` at the agreement of float32 knife edges;
    the uniform rows draw every grid quantile."""
    S = 1024
    sll = posterior_rows(64, S, seed=R)
    if R == 1:
        kvec, grid = jmd.base_sample_perm(S, 9), S
    else:
        draw_idx, grid = jmd.replicate_draw_pattern(S, 256, R)
        kvec = jmd.base_sample_perm(grid, 9)[draw_idx]
    cdf = redraw.posterior_cdf_in_kernel_order(torch.as_tensor(sll))
    ours = redraw.grid_counts_reference(cdf, grid)[:, torch.as_tensor(kvec)].numpy()
    theirs = np.asarray(jmd.device_inverse_cdf_grid(jnp.asarray(sll), kvec, grid))
    assert (ours == theirs).mean() > AGREE_F32
    assert len(np.unique(ours[3])) == grid and len(np.unique(ours[4])) == grid


@pytest.mark.parametrize("s", [1, 7, 2512, 10000, H100_MAX_GRID])
def test_grid_cell_by_table_equals_the_reference_at_every_boundary(s):
    """Every float32 cell boundary (k + 0.5)/s, one ulp below and one
    above it, and 0, 1 and values past either end: the table's cell is
    the plain version's."""
    u = (torch.arange(s, dtype=torch.float32) + 0.5) / torch.full((), s, dtype=torch.float32)
    c = torch.cat([u, torch.nextafter(u, torch.zeros(())), torch.nextafter(u, torch.ones(()) * 2),
                   torch.tensor([0.0, 1.0, 1.5, -0.0, 1e-30, 0.999999940395])])
    # the boundaries as the kernel divides them: each the correctly rounded
    # float32 quotient (float64's quotient rounded once more to float32 is)
    assert torch.equal(u, ((torch.arange(s, dtype=torch.float64) + 0.5) / s).float())
    got = redraw.grid_cell_by_table(c[None], s)
    want = redraw.grid_cells_reference(c[None], s)
    assert torch.equal(got, want)
    assert int(want.min()) == 0 and int(want.max()) == s
