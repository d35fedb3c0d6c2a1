"""The port's GP training against the JAX package's.

- ``prepare_training_data``, ``initialize_model_params``,
  ``ops.pca.pairwise_pca`` and ``ops.lbfgs.minimize_lbfgs`` (Rosenbrock
  and a checkpoint resume) equal to the JAX copies;
- ``objective``'s value and its ``torch.autograd`` gradient against
  ``jax.value_and_grad`` of the JAX objective, 1e-10 relative in float64;
- ``learn_gp_model`` with a small budget: the same iterations, function
  evaluations and termination as JAX, parameters within 1e-6 relative;
- the learned-model npz read by both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax import flatten_util
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.models import training as jtr
from gp_dla_detection_tpu.models.qso_model import GPModel as JaxGPModel
from gp_dla_detection_tpu.ops.lbfgs import minimize_lbfgs as jax_minimize_lbfgs
from gp_dla_detection_tpu.ops.pca import pairwise_pca as jax_pairwise_pca
from gp_dla_detection_tpu.params import NullModelParams, OptimizationParams, Parameters
from gp_dla_detection_tpu_torch.models import training as ptr
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.ops.lbfgs import minimize_lbfgs
from gp_dla_detection_tpu_torch.ops.pca import pairwise_pca

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)


def rosenbrock(x):
    a, b = 1.0, 100.0
    f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
    g = np.array([-2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                  2 * b * (x[1] - x[0] ** 2)])
    return f, g


def assert_results_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    assert (a.f, a.iterations, a.fun_evals, a.message) == (b.f, b.iterations, b.fun_evals, b.message)


@pytest.fixture(scope="module")
def params():
    return Parameters(
        null_model=NullModelParams(k=3),
        optimization=OptimizationParams(max_iterations=8, max_fun_evals=20),
    )


@pytest.fixture(scope="module")
def spectra():
    """Observed-frame quasar-like spectra from a seed: a smooth continuum
    with noise, masked pixels and a noisy stretch (learn_qso_model.m's
    noise cut)."""
    rng = np.random.default_rng(21)
    out = []
    for z in rng.uniform(2.2, 3.2, 24):
        lam = 10 ** (np.log10(890.0 * (1 + z)) + 1e-4 * np.arange(int(np.log10(1400 / 890) / 1e-4)))
        rest = lam / (1 + z)
        flux = 1.0 + 0.3 * np.exp(-0.5 * ((rest - 1215.67) / 12.0) ** 2) + rng.normal(0, 0.1, lam.size)
        noise = rng.uniform(0.005, 0.02, lam.size)
        noise[rng.uniform(size=lam.size) < 0.01] = 3.0
        out.append((lam, flux, noise, rng.uniform(size=lam.size) < 0.02, z))
    return out


@pytest.fixture(scope="module")
def data_pair(spectra, params):
    cols = list(zip(*spectra))
    args = ([*cols[:4]], np.array(cols[4]))
    return (
        ptr.prepare_training_data(*args[0], args[1], params),
        jtr.prepare_training_data(*args[0], args[1], params),
    )


def test_prepare_and_initialize_equal_jax(data_pair, params):
    ours, ref = data_pair
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)
    assert ours.mask.any() and not ours.mask.all()
    a = ptr.initialize_model_params(ours, params)
    b = jtr.initialize_model_params(ref, params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pairwise_pca_equals_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(50, 12)) @ rng.normal(size=(12, 12))
    X[rng.uniform(size=X.shape) < 0.2] = np.nan
    for a, b in zip(pairwise_pca(X, 4), jax_pairwise_pca(X, 4)):
        np.testing.assert_array_equal(a, b)


def test_lbfgs_equals_jax_with_checkpoint_resume(tmp_path):
    assert_results_equal(
        minimize_lbfgs(rosenbrock, np.array([-1.2, 1.0]), max_iterations=200),
        jax_minimize_lbfgs(rosenbrock, np.array([-1.2, 1.0]), max_iterations=200),
    )
    runs = []
    for opt, d in ((minimize_lbfgs, tmp_path / "port"), (jax_minimize_lbfgs, tmp_path / "jax")):
        d.mkdir()
        ckpt = d / "lbfgs.npz"
        opt(rosenbrock, np.array([-1.2, 1.0]), max_iterations=10,
            checkpoint_path=ckpt, checkpoint_every=2)
        assert ckpt.exists()
        runs.append(opt(rosenbrock, np.array([-1.2, 1.0]), max_iterations=200,
                        checkpoint_path=ckpt, checkpoint_every=50))
    assert_results_equal(*runs)
    assert runs[0].f < 1e-9


def random_params(R, k, seed):
    rng = np.random.default_rng(seed)
    return {
        "M": rng.normal(size=(R, k)) * 0.3,
        "log_omega": np.log(rng.uniform(0.1, 0.4, size=R)),
        "log_c_0": np.float64(np.log(0.12)),
        "log_tau_0": np.float64(np.log(0.0025)),
        "log_beta": np.float64(np.log(3.5)),
    }


@pytest.mark.parametrize("prior_in_value", [True, False])
def test_objective_value_and_grad_match_jax(data_pair, prior_in_value):
    ours, ref = data_pair
    R, k = ours.centered_flux.shape[1], 3
    mp = random_params(R, k, 7)
    flat0 = ptr.ravel(mp)
    layout = ptr.flat_layout(mp)
    # the flat layout is ravel_pytree's
    jflat, unravel = flatten_util.ravel_pytree({k_: jnp.asarray(v) for k_, v in mp.items()})
    np.testing.assert_array_equal(flat0, np.asarray(jflat))

    jargs = (jnp.asarray(ref.centered_flux), jnp.asarray(ref.lya_1pzs),
             jnp.asarray(ref.noise_variance), jnp.asarray(ref.mask))
    jf, jg = jax.value_and_grad(
        lambda x: jtr.objective(unravel(x), *jargs, prior_in_value=prior_in_value)
    )(jflat)
    x = torch.tensor(flat0, requires_grad=True)
    targs = (torch.as_tensor(ours.centered_flux), torch.as_tensor(ours.lya_1pzs),
             torch.as_tensor(ours.noise_variance), torch.as_tensor(ours.mask))
    f = ptr.objective(ptr.unravel(x, layout), *targs, prior_in_value=prior_in_value)
    (g,) = torch.autograd.grad(f, x)
    jg, g, f = np.asarray(jg), g.numpy(), float(f.detach())
    assert abs(f - float(jf)) <= 1e-10 * abs(float(jf))
    assert np.max(np.abs(g - jg)) <= 1e-10 * np.max(np.abs(jg))
    np.testing.assert_allclose(g, jg, rtol=1e-10, atol=1e-10 * np.max(np.abs(jg)))


def test_learn_gp_model_matches_jax(data_pair, params, tmp_path):
    ours, ref = data_pair
    model, res = ptr.learn_gp_model(ours, params, device="cpu")
    jmodel, jres = jtr.learn_gp_model(ref, params)
    assert (res.iterations, res.fun_evals, res.message) == (
        jres.iterations, jres.fun_evals, jres.message
    )
    assert res.iterations >= 5
    np.testing.assert_allclose(res.x, jres.x, rtol=1e-6, atol=1e-6 * np.max(np.abs(jres.x)))
    np.testing.assert_allclose(res.f, jres.f, rtol=1e-10)
    for name in ("M", "log_omega"):
        np.testing.assert_allclose(getattr(model, name).numpy(), getattr(jmodel, name), rtol=1e-6,
                                   atol=1e-6 * np.max(np.abs(getattr(jmodel, name))))
    for name in ("log_c_0", "log_tau_0", "log_beta"):
        np.testing.assert_allclose(getattr(model, name), getattr(jmodel, name), rtol=1e-6)
    assert model.metadata["iterations"] == jmodel.metadata["iterations"]

    # the npz artifact: each package loads what the other wrote
    model.save(tmp_path / "port.npz")
    jmodel.save(tmp_path / "jax.npz")
    from_port = JaxGPModel.load(tmp_path / "port.npz")
    from_jax = GPModel.load(tmp_path / "jax.npz", device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(from_port.M, model.M.numpy())
    np.testing.assert_array_equal(from_jax.M.numpy(), jmodel.M)
    assert from_port.metadata == model.metadata
    assert from_jax.log_beta == jmodel.log_beta


def test_device_optimizer_not_ported(data_pair, params):
    # the on-device optimizer is ported (ops/lbfgs_device.py): with the
    # small budget it walks the JAX device optimizer's path
    ours, ref = data_pair
    _, res = ptr.learn_gp_model(ours, params, optimizer="device", device="cpu")
    _, jres = jtr.learn_gp_model(ref, params, optimizer="device")
    assert (res.iterations, res.fun_evals, res.message) == (
        jres.iterations, jres.fun_evals, jres.message
    )
    np.testing.assert_allclose(res.x, jres.x, rtol=1e-6, atol=1e-6 * np.max(np.abs(jres.x)))
    with pytest.raises(ValueError, match="unknown optimizer"):
        ptr.learn_gp_model(data_pair[0], params, optimizer="adam", device="cpu")
