"""The port's fused lean two-stage chain against the JAX package.

- the device pieces (posterior CDF, inverse-CDF redraws, grid counts,
  ``pack_lean``, ``pack_lean_pair``) against their JAX counterparts and
  the host resampler: bit-equal in float64, at knife edges only in
  float32;
- ``process_spectra_multi_lean(backend="torch")`` against JAX's fused
  lean driver (``process_spectra_multi_sharded`` with
  ``store_sample_likelihoods=False`` on a one-device mesh, XLA, float64)
  at R = 1 and at an explicit R = 2 on 600 samples: evidences and
  posteriors to 1e-9, MAP indices equal;
- lean against the port's own classic driver, checkpoints (resume, and a
  JAX checkpoint directory refused), the draw columns of the z-sorted
  layout, refusals.
"""

import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import multi_dla as jmd
from gp_dla_detection_tpu.parallel import ShardedRunConfig, make_mesh
from gp_dla_detection_tpu.parallel.sharded_multi import process_spectra_multi_sharded
from gp_dla_detection_tpu.parallel.streaming import pack_lean as jax_pack_lean
from gp_dla_detection_tpu_torch import multi_dla as pmd
from gp_dla_detection_tpu_torch.inference import PaddedSpectra
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.parallel import run_fingerprint
from gp_dla_detection_tpu_torch.parallel.sharded_multi import (
    FUSED_LEAN_BASE_REPLICATES,
    lean_base_columns,
    process_spectra_multi_lean,
)
from gp_dla_detection_tpu_torch.parallel.streaming import pack_lean

from synthetic_problem import make_problem

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

t64 = lambda a: torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# device pieces
# ---------------------------------------------------------------------------


def test_device_base_sampler_matches_jax_and_host():
    rng = np.random.default_rng(11)
    sll = rng.normal(-20.0, 4.0, (6, 300))
    sll[2] = np.nan  # degenerate row: uniform fallback
    u = jmd.base_sample_grid(300, 5)
    host = jmd.make_base_sample_inds(sll, seed=5)
    ours = pmd.device_base_sample_inds(t64(sll), u).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jmd.device_base_sample_inds(sll, u)))
    assert (ours == host).mean() > 0.999
    assert len(np.unique(ours[2])) > 250

    sll32 = sll.astype(np.float32)
    ours32 = pmd.device_base_sample_inds(t64(sll32), u).numpy()
    assert (ours32 == jmd.make_base_sample_inds(sll32, seed=5)).mean() > 0.99

    # well-separated posterior mass: bit-exact in any dtype
    peaked = np.full((2, 300), -80.0, np.float32)
    peaked[0, 17] = 0.0
    peaked[1, 230] = 0.0
    np.testing.assert_array_equal(
        pmd.device_base_sample_inds(t64(peaked), u).numpy(),
        jmd.make_base_sample_inds(peaked, seed=5),
    )


def test_grid_inverse_cdf_matches_jax():
    rng = np.random.default_rng(3)
    S = 300
    sll = rng.normal(-20.0, 4.0, (7, S))
    sll[4] = np.nan
    perm = jmd.base_sample_perm(S, 9)
    np.testing.assert_allclose(
        pmd._posterior_cdf(t64(sll)).numpy(), np.asarray(jmd._posterior_cdf(sll)), rtol=1e-14
    )
    grid64 = pmd.device_inverse_cdf_grid(t64(sll), perm).numpy()
    np.testing.assert_array_equal(grid64, np.asarray(jmd.device_inverse_cdf_grid(sll, perm)))
    np.testing.assert_array_equal(
        grid64, pmd.device_base_sample_inds(t64(sll), jmd.base_sample_grid(S, 9)).numpy()
    )
    # composed permutation == composition of results
    order = rng.permutation(S)
    np.testing.assert_array_equal(
        pmd.device_inverse_cdf_grid(t64(sll), perm[order]).numpy(), grid64[:, order]
    )
    assert len(np.unique(grid64[4])) > 250

    sll32 = sll.astype(np.float32)
    ours32 = pmd.device_inverse_cdf_grid(t64(sll32), perm).numpy()
    agree = (ours32 == np.asarray(jmd.device_inverse_cdf_grid(sll32, perm))).mean()
    assert agree > 0.999, agree


def test_coarse_grid_counts_match_searchsorted():
    """grid_size < S (base replication) and > S, random shapes, rows of
    -inf and NaN: bit-equal to searchsorted on the float64 grid."""
    rng = np.random.default_rng(42)
    for trial in range(20):
        S = int(rng.integers(2, 400))
        G = int(rng.integers(1, 2 * S))
        B = int(rng.integers(1, 5))
        sll = rng.normal(-20.0, 6.0, (B, S))
        if trial % 3 == 0:
            sll[rng.integers(B), :] = np.nan
        if trial % 4 == 0:
            sll[:, rng.integers(S)] = -np.inf
        kvec = rng.integers(0, G, size=int(rng.integers(1, 3 * G)))
        u = (kvec + 0.5) / G
        cdf = pmd._posterior_cdf(t64(sll)).numpy()
        want = np.stack([np.searchsorted(row, u, side="left") for row in cdf]).clip(0, S - 1)
        got = pmd.device_inverse_cdf_grid(t64(sll), kvec, grid_size=G).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_pack_lean_matches_jax():
    rows = np.array([
        [1.0, np.nan, 3.0, 2.0],
        [np.nan, np.nan, np.nan, np.nan],
        [-1.0, -2.0, -3.0, -4.0],
        [-np.inf, -np.inf, -np.inf, -np.inf],
        [-5.0, -5.0, -7.0, -6.0],
    ])
    ev, mi = pack_lean(t64(rows))
    jev, jmi = jax_pack_lean(jnp.asarray(rows))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(ev.numpy()), np.isnan(np.asarray(jev)))
    assert mi.tolist() == np.asarray(jmi).astype(int).tolist() == [2, -1, 0, -1, 0]


def test_pack_lean_pair_matches_jax():
    rng = np.random.default_rng(8)
    rows = rng.normal(-300, 20, (6, 40))
    rows[rng.uniform(size=rows.shape) < 0.3] = np.nan
    rows[1] = np.nan
    rows[4, :5] = np.inf              # not a valid pair either
    base = rng.integers(0, 40, (6, 40)).astype(np.int32)
    ev, mi, mb = pmd.pack_lean_pair(t64(rows), t64(base))
    jev, jmi, jmb = jmd.pack_lean_pair(jnp.asarray(rows), jnp.asarray(base))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-12)
    assert np.isnan(ev[1].item())
    np.testing.assert_array_equal(mi.numpy(), np.asarray(jmi).astype(np.int64))
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jmb).astype(np.int64))
    assert mi[1] == -1 and mb[1] == -1


@pytest.mark.parametrize("R", [1, 4])
def test_sorted_layout_draw_columns_match_jax_driver(R):
    # the columns JAX's fused driver builds on its pallas (z-sorted)
    # path, sharded_multi.py:782-796
    rng = np.random.default_rng(R)
    offsets = rng.uniform(size=10000)
    cols, grid, order = lean_base_columns(offsets, 7, R, sorted_axis=True)
    j_order = np.argsort(offsets)
    if R == 1:
        want, want_grid = jmd.base_sample_perm(10000, 7)[j_order], 10000
    else:
        draw_idx, want_grid = jmd.replicate_draw_pattern(10000, 256, R)
        want = jmd.base_sample_perm(want_grid, 7)[draw_idx]
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(cols, want)
    assert grid == want_grid
    if R > 1:
        # lanes l and l + 64 of every full 256-column tile share a draw
        tiles = cols[: 10000 // 256 * 256].reshape(-1, R, 256 // R)
        assert (tiles == tiles[:, :1]).all()
    unsorted, _, no_order = lean_base_columns(offsets, 7, 1, sorted_axis=False)
    assert no_order is None
    np.testing.assert_array_equal(unsorted, jmd.base_sample_perm(10000, 7))


# ---------------------------------------------------------------------------
# the lean driver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def prior_num():
    return np.random.default_rng(7).choice([0, 0, 0, 0, 0, 1, 1, 2], 200)


def samples_600():
    rng = np.random.default_rng(17)
    return rng.uniform(size=600), 10 ** rng.uniform(20, 22, 600)


def run_jax(problem, prior_num, samples=None, R=None, tmp=None):
    params, jmodel, spectra, offsets, nhis, prior_z, _ = problem
    if samples is not None:
        offsets, nhis = samples
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return process_spectra_multi_sharded(
            jmodel, offsets, nhis, spectra, prior_z, prior_num, params=params,
            mesh=make_mesh(num_devices=1),
            config=ShardedRunConfig(
                per_device_batch=4, sample_chunk=32, dtype="float64",
                store_sample_likelihoods=False, base_replicates=R,
                checkpoint_dir=None if tmp is None else str(tmp),
            ),
        )


def run_port(problem, prior_num, samples=None, **kw):
    params, jmodel, spectra, offsets, nhis, prior_z, _ = problem
    if samples is not None:
        offsets, nhis = samples
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    dtype = kw.pop("dtype", torch.float64)
    return process_spectra_multi_lean(
        GPModel.from_numpy(**fields, dtype=dtype), offsets, nhis,
        PaddedSpectra(spectra.wavelengths, spectra.flux, spectra.noise_variance,
                      spectra.mask, spectra.z_qso),
        prior_z, prior_num, params=params, batch_size=4, sample_chunk=200,
        dtype=dtype, **kw,
    )


@pytest.fixture(scope="module")
def lean_r1(problem, prior_num):
    return run_port(problem, prior_num)


def assert_catalogs_match(ours, ref):
    for name in ("log_likelihoods_dla2", "model_posteriors"):
        a, b = getattr(ours, name), getattr(ref, name)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300, err_msg=name)
    for name in ("map_sample_inds2", "map_base_sample_inds"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(ours.single.map_sample_inds, ref.single.map_sample_inds)
    np.testing.assert_allclose(
        ours.single.log_likelihoods_dla, ref.single.log_likelihoods_dla, rtol=1e-9
    )


def test_lean_float64_matches_jax_fused(problem, prior_num, lean_r1):
    ref = run_jax(problem, prior_num)
    assert lean_r1.sample_log_likelihoods_dla2 is None
    assert lean_r1.base_sample_inds is None
    assert lean_r1.single.sample_log_likelihoods_dla is None
    assert_catalogs_match(lean_r1, ref)


def test_lean_float64_replicated_draws_match_jax_fused(problem, prior_num):
    # an explicit R = 2 on a sample axis wider than the 256-column tile:
    # the draws are laid out as JAX's XLA path lays them out, and both
    # packages warn that no kernel fast path engages
    samples = samples_600()
    ref = run_jax(problem, prior_num, samples, R=2)
    with pytest.warns(UserWarning, match="base_replicates=2"):
        ours = run_port(problem, prior_num, samples, base_replicates=2)
    assert_catalogs_match(ours, ref)
    # ... and R = 2 is another draw than R = 1: a coarser grid
    cols1, grid1, _ = lean_base_columns(samples[0], 0, 1, sorted_axis=False)
    cols2, grid2, _ = lean_base_columns(samples[0], 0, 2, sorted_axis=False)
    assert (grid1, grid2) == (600, 344) and not np.array_equal(cols1, cols2)


def test_lean_matches_classic_in_the_port(problem, prior_num, lean_r1):
    """The fused driver against the port's classic host-resampled flow
    (tests/test_lean_multi.py::test_fused_lean_matches_classic)."""
    params, jmodel, spectra, offsets, nhis, prior_z, _ = problem
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    classic = pmd.process_spectra_multi(
        GPModel.from_numpy(**fields), offsets, nhis,
        PaddedSpectra(spectra.wavelengths, spectra.flux, spectra.noise_variance,
                      spectra.mask, spectra.z_qso),
        prior_z, prior_num, params=params, batch_size=4, sample_chunk=200,
    )
    fused = lean_r1
    np.testing.assert_array_equal(
        fused.single.log_likelihoods_no_dla, classic.single.log_likelihoods_no_dla
    )
    np.testing.assert_allclose(
        fused.single.log_likelihoods_dla, classic.single.log_likelihoods_dla, rtol=1e-12
    )
    np.testing.assert_allclose(fused.log_likelihoods_dla2, classic.log_likelihoods_dla2, rtol=1e-9)
    np.testing.assert_allclose(
        fused.model_posteriors, classic.model_posteriors, rtol=1e-9, atol=1e-12
    )
    out2 = classic.sample_log_likelihoods_dla2
    assert np.isfinite(out2).any(axis=1).all()
    expect_map2 = np.nanargmax(out2, axis=1)
    np.testing.assert_array_equal(fused.map_sample_inds2, expect_map2)
    np.testing.assert_array_equal(
        fused.map_base_sample_inds,
        classic.base_sample_inds[np.arange(len(expect_map2)), expect_map2],
    )
    np.testing.assert_array_equal(
        fused.single.map_sample_inds,
        np.argmax(classic.single.sample_log_likelihoods_dla, axis=1),
    )


def test_lean_float32_plain_path_matches_float64(problem, prior_num, lean_r1):
    # the float32 plain path (the layout the kernel runs, on the CPU):
    # the tolerances of tests/test_lean_multi.py::test_fused_lean_pallas_interpret
    ours = run_port(problem, prior_num, dtype=torch.float32)
    np.testing.assert_allclose(ours.model_posteriors, lean_r1.model_posteriors, atol=2e-3)
    np.testing.assert_allclose(
        ours.log_likelihoods_dla2, lean_r1.log_likelihoods_dla2, rtol=5e-4, atol=5e-3
    )


def test_lean_checkpoint_resume(problem, prior_num, lean_r1, tmp_path):
    r1 = run_port(problem, prior_num, checkpoint_dir=tmp_path)
    ckpts = sorted((tmp_path / "fused").glob("batch_*.npz"))
    assert len(ckpts) == 3
    with np.load(ckpts[0]) as f:
        assert "log_likelihood_dla2" in f and "map_base_sample_ind" in f
        assert sum(v.nbytes for v in f.values()) < 4096
    ckpts[1].unlink()
    r2 = run_port(problem, prior_num, checkpoint_dir=tmp_path)
    for r in (r1, r2):
        for attr in ("log_likelihoods_dla2", "model_posteriors", "map_sample_inds2",
                     "map_base_sample_inds"):
            np.testing.assert_array_equal(getattr(r, attr), getattr(lean_r1, attr))
        np.testing.assert_array_equal(r.single.log_likelihoods_dla, lean_r1.single.log_likelihoods_dla)
    with pytest.warns(UserWarning, match="ignoring incompatible"):
        run_port(problem, prior_num, checkpoint_dir=tmp_path, base_seed=1)


def test_jax_checkpoints_are_not_resumed(problem, prior_num, lean_r1, tmp_path):
    run_jax(problem, prior_num, tmp=tmp_path)
    manifest = json.loads((tmp_path / "fused" / "manifest.json").read_text())
    assert manifest["completed_batches"]
    with pytest.warns(UserWarning, match="ignoring incompatible"):
        ours = run_port(problem, prior_num, checkpoint_dir=tmp_path)
    np.testing.assert_array_equal(ours.log_likelihoods_dla2, lean_r1.log_likelihoods_dla2)


def test_fingerprint_separates_backends_and_replicates(problem):
    params, jmodel, spectra, offsets, nhis, *_ = problem
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    model = GPModel.from_numpy(**fields)
    fp = lambda backend, extra=(): run_fingerprint(
        torch.float32, backend, params, model, offsets, nhis, extra=extra
    )
    assert fp("torch") == fp("torch")
    assert len({fp("torch"), fp("cuda"), fp("torch", ([4.0],))}) == 3


def test_lean_cuda_backend_refuses_cpu_and_float64(problem, prior_num):
    assert FUSED_LEAN_BASE_REPLICATES == 4
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="backend='cuda'"):
            run_port(problem, prior_num, dtype=dtype, backend="cuda")
    with pytest.raises(ValueError, match="base_replicates"):
        run_port(problem, prior_num, base_replicates=3)
