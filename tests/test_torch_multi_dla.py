"""The port's two-DLA model against the JAX package.

- the host helpers copied from ``multi_dla`` equal the JAX originals
  exactly on random inputs;
- the plain pair evidence against the JAX Pallas kernel's pair
  configuration in interpret mode (float32, 5e-5 normalized) and against
  JAX's XLA pair evaluator in float64 (1e-10 relative, identical NaN
  mask);
- the classic driver ``parallel.sharded_multi.process_spectra_multi``
  against JAX's on the
  three-spectrum {0, 1, 2}-DLA problem of tests/test_multi_dla.py, in
  float64 (1e-9) and float32 (the bounds of test_two_dla_pallas_backend);
- checkpoint resume, result files shared with JAX, refusals.
"""

import dataclasses
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import multi_dla as jmd
from gp_dla_detection_tpu.inference import PaddedSpectra as JaxPaddedSpectra
from gp_dla_detection_tpu.models.qso_model import GPModel as JaxGPModel
from gp_dla_detection_tpu.ops.evidence_pallas import SAMPLE_TILE, pallas_sample_log_likelihoods
from gp_dla_detection_tpu.ops.voigt import voigt_absorption as jax_voigt
from gp_dla_detection_tpu.params import NullModelParams, Parameters, kms_to_z
from gp_dla_detection_tpu_torch import multi_dla as pmd
from gp_dla_detection_tpu_torch.cddf_inputs import CDDFInputs, CDDFReductionSpec
from gp_dla_detection_tpu_torch.inference import PaddedSpectra
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.ops import evidence
from gp_dla_detection_tpu_torch.parallel.sharded_multi import process_spectra_multi

from synthetic_problem import make_problem
from test_base_replicates import _kernel_problem

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)


def port_model(jmodel, dtype=torch.float64):
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    return GPModel.from_numpy(**fields, dtype=dtype, device="cpu")


def port_spectra(spectra):
    return PaddedSpectra(
        spectra.wavelengths, spectra.flux, spectra.noise_variance, spectra.mask,
        spectra.z_qso,
    )


# ---------------------------------------------------------------------------
# host helpers: exact copies
# ---------------------------------------------------------------------------


def test_prior_dla_multiplicity_equals_jax():
    rng = np.random.default_rng(1)
    z = rng.uniform(2.0, 4.0, 40)
    flags = rng.uniform(size=40) < 0.6
    entries = []
    for i, zq in enumerate(z):
        if i % 5 == 0:
            entries.append(None)
        elif i % 5 == 1:
            entries.append(np.array([]))
        else:
            entries.append(rng.uniform(1.0, zq, i % 4 + 1))
    np.testing.assert_array_equal(
        pmd.prior_dla_multiplicity(z, flags, entries),
        jmd.prior_dla_multiplicity(z, flags, entries),
    )


@pytest.mark.parametrize("S,seed", [(1, 0), (300, 5), (10000, 3)])
def test_base_grid_and_tables_equal_jax(S, seed):
    np.testing.assert_array_equal(pmd.base_sample_perm(S, seed), jmd.base_sample_perm(S, seed))
    np.testing.assert_array_equal(pmd.base_sample_grid(S, seed), jmd.base_sample_grid(S, seed))
    rng = np.random.default_rng(seed)
    off, nh = rng.uniform(size=S), 10 ** rng.uniform(20, 22, S)
    for dt in (np.float32, np.float64):
        a, b = pmd.packed_base_tables(off, nh, dt), jmd.packed_base_tables(off, nh, dt)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S,tile,R", [(10000, 256, 1), (10000, 256, 4), (600, 256, 2), (300, 256, 8), (64, 128, 2)])
def test_replicate_draw_pattern_equals_jax(S, tile, R):
    a, na = pmd.replicate_draw_pattern(S, tile, R)
    b, nb = jmd.replicate_draw_pattern(S, tile, R)
    assert na == nb and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        pmd.replicate_draw_pattern(S, tile, 3)


def test_make_base_sample_inds_equals_jax():
    rng = np.random.default_rng(5)
    sll = rng.normal(-10.0, 3.0, (37, 211))
    sll[3] = np.nan                   # uniform fallback row
    sll[7] = -np.inf
    sll[11, 5] = np.nan
    for arr in (sll, sll.astype(np.float32)):
        for chunk in (8192, 10):
            np.testing.assert_array_equal(
                pmd.make_base_sample_inds(arr, seed=4, row_chunk=chunk),
                jmd.make_base_sample_inds(arr, seed=4, row_chunk=chunk),
            )


def test_rate_priors_and_finalize_equal_jax():
    rng = np.random.default_rng(9)
    params = Parameters()
    z = rng.uniform(2.0, 4.0, 30)
    z[0] = 1.0                        # no prior quasar below the cut
    prior_z = rng.uniform(2.2, 4.4, 300)
    prior_num = rng.choice([0, 0, 0, 1, 1, 2, 3], 300)
    for a, b in zip(
        pmd.multi_dla_rate_priors(z, prior_z, prior_num, params),
        jmd.multi_dla_rate_priors(z, prior_z, prior_num, params),
    ):
        np.testing.assert_array_equal(a, b)

    single = types.SimpleNamespace(
        log_likelihoods_no_dla=rng.normal(-500, 20, 30),
        log_likelihoods_dla=rng.normal(-495, 20, 30),
    )
    out2 = rng.normal(-495, 25, (30, 50))
    out2[rng.uniform(size=out2.shape) < 0.1] = np.nan
    out2[4] = np.nan                  # no valid pair
    base = rng.integers(0, 50, (30, 50))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        a = pmd.finalize_multi(single, out2, base, z, prior_z, prior_num, params)
        b = jmd.finalize_multi(single, out2, base, z, prior_z, prior_num, params)
    ll2 = a.log_likelihoods_dla2
    c = pmd.finalize_multi_from_evidence(single, ll2, z, prior_z, prior_num, params, np.arange(30), np.arange(30))
    d = jmd.finalize_multi_from_evidence(single, ll2, z, prior_z, prior_num, params, np.arange(30), np.arange(30))
    for x, y in ((a, b), (c, d)):
        for name in ("log_likelihoods_dla2", "log_priors_one_dla", "log_priors_two_dla", "model_posteriors"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
    assert np.isnan(a.log_likelihoods_dla2[4])
    np.testing.assert_array_equal(c.map_base_sample_inds, d.map_base_sample_inds)


# ---------------------------------------------------------------------------
# the plain pair evidence
# ---------------------------------------------------------------------------


def normalized_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("S", [256, 300])
def test_plain_pair_evidence_matches_pallas_interpret(S, window):
    # the production pair configuration: base draws in the R = 4 layout
    # of the 256-column tile (both kernels take their shortcut there,
    # bit-identical to R = 1; the wrapper checks the layout)
    args, inst, rng = _kernel_problem(S)
    di, nd = jmd.replicate_draw_pattern(S, SAMPLE_TILE, 4)
    z2 = rng.uniform(2.2, 2.6, (3, nd)).astype(np.float32)[:, di]
    n2 = (10 ** rng.uniform(20, 22, (3, nd))).astype(np.float32)[:, di]
    ref = pallas_sample_log_likelihoods(
        **args, num_lines=3, instrument=inst, interpret=True, window=window,
        z_dlas2=z2, nhi2=n2, base_replicates=4,
    )
    ours = evidence.sample_log_likelihoods_pair(
        *[torch.as_tensor(a) for a in args.values()], torch.as_tensor(z2),
        torch.as_tensor(n2), num_lines=3, instrument=inst, window=window,
        base_replicates=4,
    )
    assert ours.dtype == torch.float32 and ours.shape == (3, S)
    assert normalized_err(ours.numpy(), ref) < 5e-5


def test_pair_evidence_of_a_negligible_second_absorber_is_the_single():
    # a second absorber of negligible column density leaves the single
    # evidence (the pair form reduces to the single one)
    args, inst, rng = _kernel_problem(64)
    t = [torch.as_tensor(a).double() if a.dtype != bool else torch.as_tensor(a) for a in args.values()]
    single = evidence.sample_log_likelihoods_reference(*t, instrument=inst)
    pair = evidence.sample_log_likelihoods_pair_reference(
        *t, t[7].flip(-1), torch.full_like(t[8], 1e-30), instrument=inst,
    )
    np.testing.assert_allclose(pair.numpy(), single.numpy(), rtol=1e-13)


@pytest.fixture(scope="module")
def dla2_inputs():
    params, jmodel, spectra, offsets, nhis, prior_z, _ = make_problem()
    rng = np.random.default_rng(21)
    S = len(offsets)
    base = rng.integers(0, S, (len(spectra), S))
    base[:, 0] = 0                    # a pair of one sample with itself: too close
    return params, jmodel, spectra, offsets, nhis, base


def _spectrum_args(spectra, dtype, as_array):
    return (
        as_array(spectra.wavelengths, dtype),
        as_array(spectra.flux, dtype),
        as_array(spectra.noise_variance, dtype),
        as_array(np.asarray(spectra.mask), None),
        as_array(spectra.z_qso, dtype),
    )


def test_pair_evaluator_float64_matches_jax_xla(dla2_inputs):
    params, jmodel, spectra, offsets, nhis, base = dla2_inputs
    min_sep = kms_to_z(3000.0)
    fn = jmd.make_batch_dla2_fn(jmodel, params, len(offsets), 32, min_sep, "xla")
    jarr = lambda a, dt: jnp.asarray(a) if dt is None else jnp.asarray(a, dt)
    ref = np.asarray(fn(
        *_spectrum_args(spectra, np.float64, jarr),
        jnp.asarray(jmodel.rest_wavelengths), jnp.asarray(jmodel.mu),
        jnp.asarray(jmodel.M), jnp.asarray(jmodel.log_omega),
        jnp.asarray(offsets), jnp.asarray(nhis),
        jnp.asarray(offsets[base]), jnp.asarray(nhis[base]),
    ))
    model = port_model(jmodel)
    tarr = lambda a, dt: torch.as_tensor(a) if dt is None else torch.as_tensor(a, dtype=torch.float64)
    ours = pmd.batch_dla2_log_likelihoods(
        *_spectrum_args(spectra, np.float64, tarr),
        model.rest_wavelengths, model.mu, model.M, model.log_omega,
        model.log_c_0, model.log_tau_0, model.log_beta,
        torch.as_tensor(offsets), torch.as_tensor(nhis),
        torch.as_tensor(offsets[base]), torch.as_tensor(nhis[base]),
        params=params, min_sep_z=min_sep, sample_chunk=24,
    ).numpy()
    nan = np.isnan(ref)
    assert nan[:, 0].all() and 0 < nan.sum() < nan.size
    np.testing.assert_array_equal(np.isnan(ours), nan)
    np.testing.assert_allclose(ours[~nan], ref[~nan], rtol=1e-10)


# ---------------------------------------------------------------------------
# the classic driver on the {0, 1, 2}-DLA problem
# ---------------------------------------------------------------------------


def multi_problem_inputs():
    """tests/test_multi_dla.py's multi_problem, rebuilt from its seed:
    a clean spectrum, one with a DLA and one with two."""
    rng = np.random.default_rng(3)
    params = Parameters(null_model=NullModelParams(k=4))
    grid = params.null_model.rest_wavelengths()
    model = JaxGPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, 4)) * 0.04,
        log_omega=np.log(0.1 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    P = 1280
    z_qso = np.array([3.0, 3.0, 3.0])
    lam = np.stack([10 ** (np.log10(911.9 * (1 + z)) + 1e-4 * np.arange(P)) for z in z_qso])
    noise_sd = 0.08
    flux = np.empty((3, P))
    for i in range(3):
        flux[i] = np.interp(lam[i] / (1 + z_qso[i]), grid, model.mu) + rng.normal(0, noise_sd, P)

    def absorb(i, z_dla, log_n):
        ext = np.concatenate([
            lam[i, :1] * 10 ** (-1e-4 * np.arange(3, 0, -1)),
            lam[i],
            lam[i, -1:] * 10 ** (1e-4 * np.arange(1, 4)),
        ])
        flux[i] *= np.asarray(jax_voigt(ext, z_dla, 10.0**log_n, num_lines=3))

    absorb(1, 2.6, 20.8)
    absorb(2, 2.45, 20.7)
    absorb(2, 2.85, 20.9)
    arrays = (lam, flux, np.full((3, P), noise_sd**2), np.ones((3, P), bool), z_qso)
    S = 600
    offsets = rng.uniform(size=S)
    nhis = 10 ** rng.uniform(20.2, 21.3, S)
    prior_z = rng.uniform(2.2, 3.6, 400)
    prior_num = rng.choice([0, 0, 0, 0, 0, 0, 0, 1, 1, 2], 400)
    return params, model, arrays, offsets, nhis, prior_z, prior_num


@pytest.fixture(scope="module")
def multi_runs():
    params, jmodel, arrays, offsets, nhis, prior_z, prior_num = multi_problem_inputs()
    kw = dict(params=params, batch_size=3, sample_chunk=100)
    out = {
        "jax64": jmd.process_spectra_multi(
            jmodel, offsets, nhis, JaxPaddedSpectra(*arrays), prior_z, prior_num, **kw
        ),
        "jax32": jmd.process_spectra_multi(
            jmodel, offsets, nhis, JaxPaddedSpectra(*arrays), prior_z, prior_num,
            dtype=np.float32, backend="pallas_interpret", **kw
        ),
    }
    for name, dtype in (("port64", torch.float64), ("port32", torch.float32)):
        out[name] = process_spectra_multi(
            port_model(jmodel, dtype), offsets, nhis, PaddedSpectra(*arrays),
            prior_z, prior_num, dtype=dtype, **kw, device="cpu",
        )
    inputs = (params, jmodel, arrays, offsets, nhis, prior_z, prior_num)
    return inputs, out


def test_process_spectra_multi_float64_matches_jax(multi_runs):
    _, out = multi_runs
    ours, ref = out["port64"], out["jax64"]
    np.testing.assert_array_equal(ours.base_sample_inds, ref.base_sample_inds)
    a, b = ours.sample_log_likelihoods_dla2, ref.sample_log_likelihoods_dla2
    nan = np.isnan(b)
    assert nan.any()
    np.testing.assert_array_equal(np.isnan(a), nan)
    np.testing.assert_allclose(a[~nan], b[~nan], rtol=1e-9)
    np.testing.assert_allclose(ours.log_likelihoods_dla2, ref.log_likelihoods_dla2, rtol=1e-9)
    np.testing.assert_allclose(ours.model_posteriors, ref.model_posteriors, rtol=1e-9, atol=1e-12)
    assert np.argmax(ours.model_posteriors, axis=1).tolist() == [0, 1, 2]
    assert ours.model_posteriors[2, 2] > 0.9


def test_process_spectra_multi_float32_matches_jax_pallas(multi_runs):
    # the bounds of tests/test_multi_dla.py::test_two_dla_pallas_backend
    _, out = multi_runs
    ours, ref = out["port32"], out["jax32"]
    assert ours.sample_log_likelihoods_dla2.dtype == np.float32
    a, b = ours.sample_log_likelihoods_dla2, ref.sample_log_likelihoods_dla2
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(ours.base_sample_inds, ref.base_sample_inds)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert np.nanmax(rel) < 1e-2
    np.testing.assert_allclose(ours.model_posteriors, ref.model_posteriors, atol=2e-3)


def test_process_spectra_multi_checkpoint_resume(multi_runs, tmp_path):
    (params, jmodel, arrays, offsets, nhis, prior_z, prior_num), out = multi_runs
    single = out["port32"].single     # reused: only the pair stage runs
    ck = tmp_path / "ck"
    kw = dict(params=params, batch_size=2, sample_chunk=100, dtype=torch.float32,
              single=single, checkpoint_dir=ck)
    model = port_model(jmodel, torch.float32)
    run = lambda **extra: process_spectra_multi(
        model, offsets, nhis, PaddedSpectra(*arrays), prior_z, prior_num, **kw, **extra, device="cpu"
    )
    r1 = run()
    assert (ck / "manifest.json").exists()
    assert len(list(ck.glob("batch_*.npz"))) == 2
    np.testing.assert_array_equal(
        r1.sample_log_likelihoods_dla2, out["port32"].sample_log_likelihoods_dla2
    )
    (ck / "batch_000001.npz").unlink()  # one batch recomputed, one resumed
    r2 = run()
    np.testing.assert_array_equal(r1.sample_log_likelihoods_dla2, r2.sample_log_likelihoods_dla2)
    np.testing.assert_array_equal(r1.model_posteriors, r2.model_posteriors)
    # another base seed draws other pairs: the checkpoints are not reused
    with pytest.warns(UserWarning, match="incompatible two-DLA"):
        r3 = run(base_seed=1)
    assert not np.array_equal(r3.base_sample_inds, r1.base_sample_inds)


def test_multi_results_files_shared_with_jax(multi_runs, tmp_path):
    _, out = multi_runs
    ours, ref = out["port64"], out["jax64"]
    ours.save(tmp_path / "port.npz")
    ref.save(tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    back = jmd.MultiDLAResults.load(tmp_path / "port.npz")
    again = pmd.MultiDLAResults.load(tmp_path / "jax.npz")
    for x, y in ((back, ours), (again, ref)):
        for name in ("sample_log_likelihoods_dla2", "base_sample_inds", "log_likelihoods_dla2",
                     "log_priors_one_dla", "log_priors_two_dla", "model_posteriors"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
        np.testing.assert_array_equal(x.single.p_dlas, y.single.p_dlas)
        assert x.map_sample_inds2 is None and x.single.map_sample_inds is None
    # an artifact with CDDF inputs round-trips through both packages
    rng = np.random.default_rng(0)
    spec = CDDFReductionSpec()
    n = len(ours.model_posteriors)
    cddf = CDDFInputs(
        spec, rng.uniform(size=(n, 8, spec.n_z_window, spec.n_lnhi + 1)),
        np.concatenate([rng.uniform(size=(n, 5 * spec.top_k)), np.zeros((n, 4))], axis=1),
    )
    dataclasses.replace(ours, cddf_inputs=cddf).save(tmp_path / "cddf.npz")
    for loaded in (pmd.MultiDLAResults.load(tmp_path / "cddf.npz"),
                   jmd.MultiDLAResults.load(tmp_path / "cddf.npz")):
        np.testing.assert_array_equal(loaded.cddf_inputs.hist, cddf.hist)
        np.testing.assert_array_equal(loaded.cddf_inputs.ex, cddf.ex)
        assert loaded.cddf_inputs.spec.token() == spec.token()
        np.testing.assert_array_equal(loaded.model_posteriors, ours.model_posteriors)
    with np.load(tmp_path / "port.npz") as f:
        np.savez(tmp_path / "bad.npz", **{k: v for k, v in f.items() if k != "log_priors_two_dla"})
    with pytest.raises(ValueError, match="missing"):
        pmd.MultiDLAResults.load(tmp_path / "bad.npz")


def test_cuda_backend_refuses_cpu_and_float64(dla2_inputs):
    params, jmodel, spectra, offsets, nhis, base = dla2_inputs
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="backend='cuda'"):
            process_spectra_multi(
                port_model(jmodel, dtype), offsets, nhis, port_spectra(spectra),
                np.array([3.0]), np.array([1]), params=params, dtype=dtype,
                backend="cuda", device="cpu",
            )
    model = port_model(jmodel, torch.float32)
    tarr = lambda a, dt: torch.as_tensor(a) if dt is None else torch.as_tensor(a, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pmd.batch_dla2_log_likelihoods(
            *_spectrum_args(spectra, np.float32, tarr),
            model.rest_wavelengths, model.mu, model.M, model.log_omega,
            model.log_c_0, model.log_tau_0, model.log_beta,
            torch.as_tensor(offsets), torch.as_tensor(nhis),
            torch.as_tensor(offsets[base]), torch.as_tensor(nhis[base]),
            params=params, min_sep_z=0.01, backend="cuda",
        )
    with pytest.raises(ValueError, match="unknown backend"):
        process_spectra_multi(
            port_model(jmodel), offsets, nhis, port_spectra(spectra),
            np.array([3.0]), np.array([1]), params=params, backend="xla", device="cpu", dtype=torch.float64,
        )
