"""The fused lean chain's base redraw, CDDF sums and null evidence
against the JAX package, on the CPU: the plain versions beside the CUDA
kernels of ``ops/redraw.py`` (``csrc/redraw.cu``),
``cddf_inputs.cddf_sums`` (``csrc/cddf.cu``) and
``ops/low_rank_mvn.null_log_likelihoods`` (``csrc/null_evidence.cu``),
whose kernel-only tests are in ``tests/test_torch_cuda.py``.

- the plain redraw (``device_inverse_cdf_grid`` on CPU tensors) against
  JAX's ``device_inverse_cdf_grid`` at R = 1 and R = 4 (grid_size < S) on
  rows with NaN rows, all -inf rows and scattered NaN and -inf entries:
  equal in float64, at the agreement rate of test_torch_lean_multi.py in
  float32;
- both packages' plain redraws independent of the batch: rows at 1, 7
  and 64 rows and under a row permutation, bit for bit;
- the plain CDDF reduction (``make_cddf_reducer``, the sums through
  ``cddf_sums_reference``) against JAX's reducer on the same inputs, with
  the bases of a redraw at R = 4: equal in float64 to 1e-12 (the two
  add in other orders), the exact entries and counters equal;
- the null evidence's wrapper on CPU tensors against JAX's
  ``log_mvnpdf_low_rank`` (float64, 1e-12), batch-invariant on the CPU;
- the wrappers on CPU tensors are their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import cddf_inputs as jci
from gp_dla_detection_tpu import multi_dla as jmd
from gp_dla_detection_tpu.ops.low_rank_mvn import log_mvnpdf_low_rank as jax_log_mvnpdf
from gp_dla_detection_tpu_torch import cddf_inputs as pci
from gp_dla_detection_tpu_torch import multi_dla as pmd
from gp_dla_detection_tpu_torch.ops import low_rank_mvn, redraw

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

S = 1024
AGREE_F32 = 0.999   # tests/test_torch_lean_multi.py: float32 knife edges


def posterior_rows(B, seed=0):
    """float64 (B, S) rows: broad and peaked posteriors, a NaN row, an
    all -inf row, scattered NaN and -inf entries."""
    rng = np.random.default_rng(seed)
    sll = rng.normal(-50.0, 4.0, (B, S))
    sll[1] = rng.normal(-50.0, 0.3, S)
    sll[2, 77] += 120.0
    sll[3] = np.nan
    sll[4] = -np.inf
    sll[5, rng.integers(0, S, 100)] = np.nan
    sll[6, rng.integers(0, S, 100)] = -np.inf
    return sll


def grid_columns(R, seed=9):
    """(kvec, grid_size) of the chain's redraw at base replication R."""
    if R == 1:
        return jmd.base_sample_perm(S, seed), S
    draw_idx, grid = jmd.replicate_draw_pattern(S, 256, R)
    return jmd.base_sample_perm(grid, seed)[draw_idx], grid


@pytest.mark.parametrize("R", [1, 4])
def test_plain_redraw_matches_jax(R):
    sll = posterior_rows(64)
    kvec, grid = grid_columns(R)
    assert grid == S // R
    ours = pmd.device_inverse_cdf_grid(torch.as_tensor(sll), kvec, grid).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jmd.device_inverse_cdf_grid(sll, kvec, grid)))
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        ours, pmd.device_inverse_cdf_grid_reference(torch.as_tensor(sll), kvec, grid).numpy()
    )
    # uniform fallback rows draw every grid quantile
    assert len(np.unique(ours[3])) == grid and len(np.unique(ours[4])) == grid

    sll32 = sll.astype(np.float32)
    ours32 = pmd.device_inverse_cdf_grid(torch.as_tensor(sll32), kvec, grid).numpy()
    agree = (ours32 == np.asarray(jmd.device_inverse_cdf_grid(sll32, kvec, grid))).mean()
    assert agree > AGREE_F32, agree


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R", [1, 4])
def test_plain_redraws_do_not_depend_on_the_batch(dtype, R):
    sll = posterior_rows(64, seed=3).astype(dtype)
    kvec, grid = grid_columns(R)
    perm = np.random.default_rng(5).permutation(64)
    runs = {
        "port": lambda x: pmd.device_inverse_cdf_grid(torch.as_tensor(x), kvec, grid).numpy(),
        "jax": lambda x: np.asarray(jmd.device_inverse_cdf_grid(x, kvec, grid)),
    }
    cdfs = {
        "port": lambda x: pmd._posterior_cdf(torch.as_tensor(x)).numpy(),
        "jax": lambda x: np.asarray(jmd._posterior_cdf(x)),
    }
    for name, run in runs.items():
        whole, cdf = run(sll), cdfs[name](sll)
        for rows in (slice(0, 1), slice(9, 10), slice(0, 7), slice(30, 37), slice(0, 64)):
            np.testing.assert_array_equal(run(sll[rows]), whole[rows], err_msg=name)
            np.testing.assert_array_equal(cdfs[name](sll[rows]), cdf[rows], err_msg=name)
        np.testing.assert_array_equal(run(sll[perm]), whole[perm], err_msg=name)
        np.testing.assert_array_equal(cdfs[name](sll[perm]), cdf[perm], err_msg=name)


def test_redraw_wrappers_on_the_cpu_are_the_plain_versions():
    x = torch.as_tensor(posterior_rows(8, seed=4).astype(np.float32))
    kvec, grid = grid_columns(4)
    before = (redraw.launch_count, redraw.cdf_launch_count)
    assert torch.equal(redraw.posterior_cdf(x), redraw.posterior_cdf_reference(x))
    assert torch.equal(redraw.inverse_cdf_grid(x, kvec, grid),
                       redraw.inverse_cdf_grid_reference(x, kvec, grid))
    assert torch.equal(redraw.inverse_cdf_grid(x, kvec), redraw.inverse_cdf_grid_reference(x, kvec))
    assert (redraw.launch_count, redraw.cdf_launch_count) == before


def reducer_inputs(B=12, seed=1):
    """One batch's reducer inputs (float64, numpy), the bases a redraw of
    the single stage's samples at R = 4, and the sample tables."""
    rng = np.random.default_rng(seed)
    sll = rng.normal(-50.0, 2.0, (B, S))
    sll[0, 300] += 40.0
    row_max = sll.max(axis=1)
    ev1 = row_max + np.log(np.mean(np.exp(sll - row_max[:, None]), axis=1))
    kvec, grid = grid_columns(4)
    base = np.asarray(jmd.device_inverse_cdf_grid(sll, kvec, grid)).astype(np.int64)
    ll2 = rng.normal(-49.0, 2.0, (B, S))
    ll2[:, ::11] = np.nan
    head = dict(
        sll=sll, ev1=ev1, ll_null=rng.normal(-49, 1, B),
        min_z=rng.uniform(2.0, 2.2, B), max_z=rng.uniform(2.8, 3.0, B),
        lp_no=np.log(rng.uniform(0.5, 0.9, B)), lp_dla=np.log(rng.uniform(0.1, 0.5, B)),
        lp0m=np.log(rng.uniform(0.4, 0.8, B)), lp1m=np.log(rng.uniform(0.1, 0.4, B)),
        lp2m=np.log(rng.uniform(0.05, 0.2, B)),
    )
    tail = dict(ll2_pair=ll2, ev2=rng.normal(-48, 1, B), base_cols=base)
    offsets = rng.uniform(size=S)
    lnhis = rng.uniform(19.9, 23.1, S)
    return head, tail, offsets, lnhis, kvec


def test_plain_cddf_reduction_matches_jax():
    head, tail, offsets, lnhis, kvec = reducer_inputs()
    spec = pci.CDDFReductionSpec()
    jspec = jci.CDDFReductionSpec()
    j_fn, j_consts = jci.make_cddf_reducer(jspec, offsets, lnhis, np.float64)
    j_hist, j_ex = j_fn(j_consts, *[jnp.asarray(v) for v in (*head.values(), *tail.values())])
    p_fn, p_consts = pci.make_cddf_reducer(
        spec, offsets, lnhis, base_order=np.argsort(kvec, kind="stable"), kernels=True
    )
    before = pci.launch_count
    hist, ex = p_fn(p_consts, *[torch.as_tensor(v) for v in (*head.values(), *tail.values())])
    assert pci.launch_count == before   # CPU tensors: the plain sums
    j_hist, j_ex, hist, ex = map(np.asarray, (j_hist, j_ex, hist, ex))
    assert hist.shape == j_hist.shape
    np.testing.assert_allclose(hist, j_hist, rtol=1e-12, atol=1e-300)
    assert hist[:, pci.CH_SMALL2_A].sum() > 0   # the redraw's bases do real work
    K = spec.top_k
    live = j_ex[:, : K] > 0
    np.testing.assert_allclose(ex[:, :K], j_ex[:, :K], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ex[:, K : 2 * K][live], j_ex[:, K : 2 * K][live])
    np.testing.assert_allclose(ex[:, 2 * K : 3 * K], j_ex[:, 2 * K : 3 * K], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ex[:, 5 * K :], j_ex[:, 5 * K :])


def test_cddf_sums_wrapper_on_the_cpu_is_the_plain_version():
    """Random (not redraw-shaped) bases, every window and dump case."""
    rng = np.random.default_rng(2)
    spec = pci.CDDFReductionSpec()
    B = 5
    t = torch.as_tensor
    args = (
        t(rng.dirichlet(np.full(S, 0.1), B)), t(rng.uniform(0, 0.3, (B, S))),
        t(rng.integers(0, S, (B, S))), t(rng.integers(-2, spec.n_z_window + 2, (B, S))),
        t(np.arange(S)), t(rng.integers(0, spec.n_lnhi + 1, S)),
        t(rng.integers(0, spec.n_lnhi + 1, S)), t(rng.uniform(0.5, 10, S)),
        t(rng.uniform(0.25, 100, S)),
        spec.p_sample_min, spec.p_switch, spec.n_z_window, spec.n_lnhi,
    )
    before = pci.launch_count
    acc, hist = pci.cddf_sums(*args)
    ref_acc, ref_hist = pci.cddf_sums_reference(*args)
    assert pci.launch_count == before
    assert torch.equal(acc, ref_acc) and torch.equal(hist, ref_hist)
    assert hist.shape == (B, pci.N_CHANNELS, spec.n_z_window * (spec.n_lnhi + 1) + 1)
    # every channel's mass is binned somewhere (the dump slot included)
    np.testing.assert_allclose(hist[:, pci.CH_P].sum(1).numpy(), args[0].sum(1).numpy(), rtol=1e-12)
    np.testing.assert_allclose(hist[:, pci.CH_SMALL2_A].sum(1).numpy(), args[1].sum(1).numpy(),
                               rtol=1e-12)


def test_null_evidence_wrapper_matches_jax_and_the_batch():
    rng = np.random.default_rng(6)
    B, P, k = 9, 300, 20
    y = rng.normal(1.0, 0.3, (B, P))
    mu = 1.0 + 0.1 * np.sin(np.arange(P) / 30.0)[None, :].repeat(B, 0)
    M = rng.normal(size=(B, P, k)) * 0.08
    d = rng.uniform(0.01, 0.2, (B, P))
    mask = rng.uniform(size=(B, P)) > 0.1
    mask[3] = False            # no valid pixel
    y[mask == 0] = np.nan      # masked pixels never reach the density
    t = torch.as_tensor
    before = low_rank_mvn.launch_count
    ours = low_rank_mvn.null_log_likelihoods(t(y), t(mu), t(M), t(d), t(mask))
    assert low_rank_mvn.launch_count == before
    assert torch.equal(ours, low_rank_mvn.null_log_likelihoods_reference(t(y), t(mu), t(M), t(d),
                                                                         t(mask)))
    ref = np.stack([np.asarray(jax_log_mvnpdf(y[i][mask[i]], mu[i][mask[i]], M[i][mask[i]],
                                              d[i][mask[i]])) for i in range(B)])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12, atol=1e-12)
    for rows in (slice(0, 1), slice(4, 5), slice(2, 9)):
        np.testing.assert_array_equal(
            low_rank_mvn.null_log_likelihoods(t(y[rows]), t(mu[rows]), t(M[rows]), t(d[rows]),
                                              t(mask[rows])).numpy(), ours[rows].numpy())
