"""The port's single-DLA inference slice against the JAX package.

- float64 plain path against the committed golden fixture (1e-9 rel,
  tests/test_golden.py) and against JAX with the reference quirk on;
- the slice end to end: port ``process_spectra`` against JAX
  ``process_spectra`` on a small synthetic set with injected DLAs, in
  float32 (JAX through the Pallas kernel in interpret mode: identical
  decisions at p = 0.9, |dp| < 1e-3) and in float64 (JAX "xla": p_DLA to
  1e-9), with identical result-file keys;
- the model artifact, priors and window sizing shared with JAX;
- ``backend="cuda"`` refusing CPU and float64 tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import inference as jinf
from gp_dla_detection_tpu.models.qso_model import GPModel as JaxGPModel
from gp_dla_detection_tpu.ops.voigt import extend_wavelengths, voigt_absorption
from gp_dla_detection_tpu.params import DLASamplingParams, NullModelParams, Parameters
from gp_dla_detection_tpu.samples import generate_dla_samples
from gp_dla_detection_tpu_torch import inference as pinf
from gp_dla_detection_tpu_torch.models.qso_model import GPModel

from test_golden import FIXTURE

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)


def golden_inputs():
    """tests/test_golden.py's problem, rebuilt from its seed as numpy."""
    rng = np.random.default_rng(20160446)
    params = Parameters(null_model=NullModelParams(k=6))
    grid = params.null_model.rest_wavelengths()
    model = dict(
        rest_wavelengths=grid,
        mu=1.0 + 0.2 * np.sin(grid / 35.0),
        M=rng.normal(size=(grid.size, 6)) * 0.07,
        log_omega=np.log(0.15 + 0.05 * np.cos(grid / 55.0)),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    B, P, S = 3, 700, 64
    z = np.array([2.71, 3.05, 3.42])
    lam = np.stack([10 ** (np.log10(911.8 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z])
    mask = rng.uniform(size=(B, P)) > 0.04
    spectrum = (lam, rng.normal(1.0, 0.25, (B, P)), rng.uniform(0.05, 0.2, (B, P)), mask, z)
    samples = (rng.uniform(size=S), 10 ** rng.uniform(20.0, 22.3, S))
    return params, model, spectrum, samples


def model_args(model):
    return (
        model["rest_wavelengths"], model["mu"], model["M"], model["log_omega"],
        model["log_c_0"], model["log_tau_0"], model["log_beta"],
    )


def port_golden(**kw):
    params, model, spectrum, samples = golden_inputs()
    t = torch.as_tensor
    args = [t(a) for a in spectrum]
    m = model_args(model)
    return pinf.batch_log_likelihoods(
        *args, t(m[0]), t(m[1]), t(m[2]), t(m[3]), *m[4:], t(samples[0]), t(samples[1]),
        params=params, sample_chunk=16, **kw,
    )


def test_golden_log_evidences_float64():
    out = port_golden()
    with np.load(FIXTURE) as f:
        np.testing.assert_allclose(
            out["log_likelihood_no_dla"].numpy(), f["log_likelihood_no_dla"], rtol=1e-9
        )
        np.testing.assert_allclose(
            out["sample_log_likelihoods_dla"].numpy(), f["sample_log_likelihoods_dla"],
            rtol=1e-9,
        )
        np.testing.assert_allclose(out["min_z_dla"].numpy(), f["min_z_dla"], rtol=1e-12)
        np.testing.assert_allclose(out["max_z_dla"].numpy(), f["max_z_dla"], rtol=1e-12)


def test_spectrum_log_likelihoods_is_one_batch_row():
    params, model, spectrum, samples = golden_inputs()
    t = torch.as_tensor
    m = model_args(model)
    one = pinf.spectrum_log_likelihoods(
        *[t(a[1]) for a in spectrum], t(m[0]), t(m[1]), t(m[2]), t(m[3]), *m[4:],
        t(samples[0]), t(samples[1]), params=params, sample_chunk=16,
    )
    batch = port_golden()
    for key, value in one.items():
        np.testing.assert_allclose(value.numpy(), batch[key][1].numpy(), rtol=1e-12)


def test_reference_misaligned_absorption_matches_jax():
    params, model, spectrum, samples = golden_inputs()
    ref = jinf.batch_log_likelihoods(
        *[jnp.asarray(a) for a in spectrum], *[jnp.asarray(a) for a in model_args(model)[:4]],
        *model_args(model)[4:], jnp.asarray(samples[0]), jnp.asarray(samples[1]),
        params=params, sample_chunk=16, reference_misaligned_absorption=True,
    )
    ours = port_golden(reference_misaligned_absorption=True)
    aligned = port_golden()
    np.testing.assert_allclose(
        ours["sample_log_likelihoods_dla"].numpy(),
        np.asarray(ref["sample_log_likelihoods_dla"]), rtol=1e-9,
    )
    # the quirk changes the result wherever a masked pixel is in range
    assert not np.allclose(
        ours["sample_log_likelihoods_dla"].numpy(),
        aligned["sample_log_likelihoods_dla"].numpy(), rtol=1e-6,
    )


def synthetic_set(n=8, P=480, k=5, S=256, seed=11):
    """Spectra from a known low-rank GP with a DLA injected into every
    other one (by the JAX package's Voigt profile), plus the QMC set."""
    rng = np.random.default_rng(seed)
    params = Parameters(
        null_model=NullModelParams(k=k),
        dla_sampling=DLASamplingParams(num_dla_samples=S),
    )
    grid = params.null_model.rest_wavelengths()
    jmodel = JaxGPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2),
        M=rng.normal(size=(grid.size, k)) * 0.05,
        log_omega=np.log(0.1 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    z_qso = rng.uniform(2.6, 3.4, n)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P))[None, :]
    noise_sd = 10 ** rng.uniform(-1.2, -0.4, n)
    flux = np.empty((n, P))
    for i in range(n):
        rest = lam[i] / (1 + z_qso[i])
        flux[i] = (
            np.interp(rest, grid, jmodel.mu)
            + np.interp(rest, grid, jmodel.M @ rng.normal(size=k))
            + rng.normal(0, noise_sd[i], P)
        )
    for i in range(0, n, 2):
        z_dla = lam[i, P // 2] / 1215.6701 - 1
        absorption = voigt_absorption(
            extend_wavelengths(lam[i]), z_dla, 10 ** rng.uniform(20.3, 21.5)
        )
        flux[i] *= np.asarray(absorption)
    mask = rng.uniform(size=(n, P)) > 0.01
    noise = np.broadcast_to((noise_sd**2)[:, None], (n, P)).copy()
    samples = generate_dla_samples(rng.normal(20.7, 0.4, 200).clip(20.05, 22.4), params)
    prior_z = rng.uniform(2.0, 4.4, 2000)
    prior_f = rng.uniform(size=2000) < 0.2
    arrays = (lam, flux, noise, mask, z_qso)
    return params, jmodel, arrays, samples, prior_z, prior_f


@pytest.fixture(scope="module")
def slice_results(tmp_path_factory):
    params, jmodel, arrays, samples, prior_z, prior_f = synthetic_set()
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    common = (samples.offset_samples, samples.nhi_samples)
    out = {}
    for dtype, jax_backend in ((np.float32, "pallas_interpret"), (np.float64, "xla")):
        out[("jax", dtype)] = jinf.process_spectra(
            jmodel, *common, jinf.PaddedSpectra(*arrays), prior_z, prior_f,
            params=params, batch_size=4, dtype=dtype, backend=jax_backend,
            sample_chunk=64,
        )
        tdtype = torch.float32 if dtype == np.float32 else torch.float64
        out[("port", dtype)] = pinf.process_spectra(
            GPModel.from_numpy(**fields, dtype=tdtype), *common,
            pinf.PaddedSpectra(*arrays), prior_z, prior_f,
            params=params, batch_size=4, dtype=tdtype, backend="torch",
            sample_chunk=64,
        )
    return out, tmp_path_factory.mktemp("results")


def test_process_spectra_float64_matches_jax(slice_results):
    out, _ = slice_results
    ours, ref = out[("port", np.float64)], out[("jax", np.float64)]
    detected = ref.p_dlas > 0.9
    assert detected.any() and not detected.all()  # both classes present
    np.testing.assert_allclose(ours.p_dlas, ref.p_dlas, rtol=1e-9, atol=1e-9)
    for name in ("log_likelihoods_no_dla", "log_likelihoods_dla", "min_z_dlas", "max_z_dlas"):
        np.testing.assert_allclose(getattr(ours, name), getattr(ref, name), rtol=1e-9)
    np.testing.assert_allclose(
        ours.sample_log_likelihoods_dla, ref.sample_log_likelihoods_dla, rtol=1e-9
    )


def test_process_spectra_float32_matches_jax_pallas(slice_results):
    out, _ = slice_results
    ours, ref = out[("port", np.float32)], out[("jax", np.float32)]
    assert ours.sample_log_likelihoods_dla.dtype == np.float32
    np.testing.assert_array_equal(ours.p_dlas > 0.9, ref.p_dlas > 0.9)
    assert np.max(np.abs(ours.p_dlas - ref.p_dlas)) < 1e-3


def test_results_files_have_the_jax_keys(slice_results):
    out, tmp = slice_results
    ours, ref = out[("port", np.float64)], out[("jax", np.float64)]
    ours.save(tmp / "port.npz")
    ref.save(tmp / "jax.npz")
    with np.load(tmp / "port.npz") as a, np.load(tmp / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # each package reads the other's artifact
    back = jinf.InferenceResults.load(tmp / "port.npz")
    np.testing.assert_array_equal(back.p_dlas, ours.p_dlas)
    again = pinf.InferenceResults.load(tmp / "jax.npz")
    np.testing.assert_array_equal(again.p_dlas, ref.p_dlas)


def test_gp_model_artifact_round_trips_between_packages(tmp_path):
    params, jmodel, *_ = synthetic_set(n=2)
    jmodel.save(tmp_path / "jax_model.npz")
    ours = GPModel.load(tmp_path / "jax_model.npz")
    np.testing.assert_array_equal(ours.M.numpy(), jmodel.M)
    assert ours.log_beta == jmodel.log_beta and ours.k == jmodel.k
    ours.save(tmp_path / "port_model.npz")
    back = JaxGPModel.load(tmp_path / "port_model.npz")
    np.testing.assert_array_equal(back.mu, jmodel.mu)
    # interpolation on a spectrum's rest grid agrees with the JAX model's
    rest = torch.linspace(912.0, 1215.0, 333, dtype=torch.float64)
    mu, M, log_omega = ours.interpolate(rest)
    jmu, jM, jlo = jmodel.interpolate(jnp.asarray(rest.numpy()))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-12)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(log_omega.numpy(), np.asarray(jlo), rtol=1e-12)
    bad = np.asarray(jmodel.rest_wavelengths).copy()
    bad[5] += 0.1
    with pytest.raises(ValueError, match="uniformly spaced"):
        GPModel.from_numpy(bad, jmodel.mu, jmodel.M, jmodel.log_omega, 0.0, 0.0, 0.0)


def test_priors_and_window_match_jax():
    rng = np.random.default_rng(4)
    params = Parameters()
    z = rng.uniform(2.2, 4.0, 50)
    prior_z = rng.uniform(2.0, 4.4, 300)
    flags = rng.uniform(size=300) < 0.2
    for a, b in zip(
        pinf.dla_rate_priors(z, prior_z, flags, params),
        jinf.dla_rate_priors(z, prior_z, flags, params),
    ):
        np.testing.assert_array_equal(a, b)
    prior_z_dlas = [None if i % 3 else [zq - 0.5, zq - 1.2] for i, zq in enumerate(prior_z)]
    np.testing.assert_array_equal(
        pinf.correct_prior_dla_flags(prior_z, flags, prior_z_dlas),
        jinf.correct_prior_dla_flags(prior_z, flags, prior_z_dlas),
    )
    offsets = rng.uniform(size=10000)
    for chunk, pixels, lines in ((256, 1280, 3), (128, 1206, 3), (256, 1280, 31), (64, 200, 3)):
        assert pinf.compute_sample_window(offsets, chunk, pixels, lines) == \
            jinf.compute_sample_window(offsets, chunk, pixels, lines)


def test_cuda_backend_refuses_cpu_and_float64():
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_golden(backend="cuda")
    params, jmodel, arrays, samples, prior_z, prior_f = synthetic_set(n=2)
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="backend='cuda'"):
            pinf.process_spectra(
                GPModel.from_numpy(**fields), samples.offset_samples, samples.nhi_samples,
                pinf.PaddedSpectra(*arrays), prior_z, prior_f, params=params,
                dtype=dtype, backend="cuda",
            )
    with pytest.raises(ValueError, match="unknown backend"):
        port_golden(backend="xla")
