"""The port's on-device L-BFGS against the JAX package's.

``ops.lbfgs_device.minimize_lbfgs_device`` runs the JAX optimizer's
algorithm (two-loop recursion over circular buffers, backtracking
Armijo, curvature pairs only when y's > 1e-10) with the state on the
device; in float64 both reach the same iterate through the same
iterations, evaluations and termination (x to 1e-8), on Rosenbrock and
on the GP training objective (tests/test_training.py:412-486).  Also: a
checkpoint resume equals the uninterrupted run and resumes a JAX state
file, a NaN gradient ends both the same way, the host reads only
scalars per evaluation, and ``learn_gp_model(optimizer="device")``
reaches the host optimizer's NLL to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.models import training as jtr
from gp_dla_detection_tpu.ops.lbfgs_device import minimize_lbfgs_device as jax_minimize
from gp_dla_detection_tpu.params import NullModelParams, OptimizationParams, Parameters
from gp_dla_detection_tpu_torch.models import training as ptr
from gp_dla_detection_tpu_torch.ops import lbfgs_device
from gp_dla_detection_tpu_torch.ops.lbfgs_device import minimize_lbfgs_device

torch.set_num_threads(1)


def rosenbrock_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosenbrock_torch(x):
    x = x.detach().requires_grad_(True)
    f = torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def assert_same_run(ours, ref, xtol=1e-8):
    assert (ours.iterations, ours.fun_evals, ours.message) == (
        ref.iterations, ref.fun_evals, ref.message
    )
    np.testing.assert_allclose(ours.x, ref.x, rtol=xtol, atol=xtol)
    assert abs(ours.f - ref.f) <= 1e-10 * max(1.0, abs(ref.f))


@pytest.mark.parametrize("x0", [[-1.2, 1.0], [-1.0] * 10], ids=["2d", "10d"])
def test_rosenbrock_matches_jax(x0):
    x0 = np.asarray(x0)
    ref = jax_minimize(jax.value_and_grad(rosenbrock_jax), jnp.asarray(x0), max_iterations=300)
    ours = minimize_lbfgs_device(rosenbrock_torch, torch.as_tensor(x0), max_iterations=300)
    assert_same_run(ours, ref)
    assert ours.f < 1e-8
    np.testing.assert_allclose(ours.x, np.ones_like(x0), atol=1e-4)


def test_host_reads_scalars_only(monkeypatch):
    # one read per line-search trial and one per iteration, plus the
    # initial gradient test: no n-vector crosses to the host per evaluation
    reads = []
    real_read = lbfgs_device._read

    def spy(*scalars):
        assert all(s.ndim == 0 for s in scalars)
        reads.append(len(scalars))
        return real_read(*scalars)

    monkeypatch.setattr(lbfgs_device, "_read", spy)
    before = lbfgs_device.host_syncs
    res = minimize_lbfgs_device(rosenbrock_torch, torch.full((10,), -1.0), max_iterations=120)
    trials = res.fun_evals - 1
    assert len(reads) == 1 + trials + res.iterations
    assert lbfgs_device.host_syncs - before == len(reads)


def small_training_problem(N=300, seed=9):
    """tests/test_training.py's _small_training_problem, for both packages."""
    rng = np.random.default_rng(seed)
    R, k = 64, 2
    kw = dict(
        null_model=NullModelParams(min_lambda=1000.0, max_lambda=1000.0 + 0.25 * (R - 1), k=k),
        optimization=OptimizationParams(max_iterations=300, max_fun_evals=600),
    )
    grid = Parameters(**kw).null_model.rest_wavelengths()
    true_M = rng.normal(size=(R, k)) * 0.4
    wavelengths, flux, noise, masks = [], [], [], []
    for _ in range(N):
        cov_noise = rng.uniform(0.01, 0.02, size=R)
        y = 1.0 + true_M @ rng.normal(size=k) + rng.normal(size=R) * np.sqrt(0.15**2 + cov_noise)
        wavelengths.append(grid * 3.5)
        flux.append(y)
        noise.append(cov_noise)
        masks.append(np.zeros(R, bool))
    args = (wavelengths, flux, noise, masks, np.full(N, 2.5))
    from gp_dla_detection_tpu_torch import params as pp

    port_params = pp.Parameters(
        null_model=pp.NullModelParams(**vars(kw["null_model"])),
        optimization=pp.OptimizationParams(**vars(kw["optimization"])),
    )
    return (
        (ptr.prepare_training_data(*args, port_params), port_params),
        (jtr.prepare_training_data(*args, Parameters(**kw)), Parameters(**kw)),
    )


@pytest.fixture(scope="module")
def training_problem():
    return small_training_problem()


def with_budget(params, iterations):
    return dataclasses.replace(
        params, optimization=dataclasses.replace(params.optimization, max_iterations=iterations)
    )


def test_gp_training_matches_jax(training_problem):
    # 60 iterations: the two float64 objectives differ by ~1e-15, which
    # the problem's flat directions amplify past 1e-8 in x after ~80
    (data, params), (jdata, jparams) = training_problem
    _, ours = ptr.learn_gp_model(data, with_budget(params, 60), optimizer="device", device="cpu")
    _, ref = jtr.learn_gp_model(jdata, with_budget(jparams, 60), optimizer="device")
    assert_same_run(ours, ref)
    # to convergence: the host strong-Wolfe optimizer's NLL to 1e-6
    # (tests/test_training.py::test_device_lbfgs_matches_host_on_gp_training)
    _, dev = ptr.learn_gp_model(data, params, optimizer="device", device="cpu")
    _, host = ptr.learn_gp_model(data, params, optimizer="host", device="cpu")
    assert dev.message in ("optTol", "progTol_step", "progTol_f", "MaxIter")
    assert abs(host.f - dev.f) < 1e-6 * abs(host.f)


def test_checkpoint_resume(tmp_path):
    x0 = torch.full((10,), -1.0, dtype=torch.float64)
    ck = tmp_path / "lbfgs_state.npz"
    direct = minimize_lbfgs_device(rosenbrock_torch, x0, max_iterations=120)
    part = minimize_lbfgs_device(
        rosenbrock_torch, x0, max_iterations=30, checkpoint_path=ck, checkpoint_every=10
    )
    assert part.iterations == 30 and ck.exists()
    resumed = minimize_lbfgs_device(
        rosenbrock_torch, x0, max_iterations=120, checkpoint_path=ck, checkpoint_every=10
    )
    assert (resumed.iterations, resumed.fun_evals, resumed.message) == (
        direct.iterations, direct.fun_evals, direct.message
    )
    assert abs(resumed.f - direct.f) <= 1e-12 * max(1.0, abs(direct.f))
    np.testing.assert_allclose(resumed.x, direct.x, rtol=1e-12)

    # the state file has the JAX package's keys: a JAX run's state resumes here
    jck = tmp_path / "jax_state.npz"
    jax_minimize(jax.value_and_grad(rosenbrock_jax), jnp.full(10, -1.0), max_iterations=30,
                 checkpoint_path=jck, checkpoint_every=10)
    with np.load(jck) as a, np.load(ck) as b:
        assert sorted(a.files) == sorted(b.files)
    from_jax = minimize_lbfgs_device(
        rosenbrock_torch, x0, max_iterations=120, checkpoint_path=jck, checkpoint_every=10
    )
    assert_same_run(from_jax, direct)

    # a reader that does not write (a non-coordinator rank) resumes the same
    stamp = jck.stat().st_mtime_ns
    again = minimize_lbfgs_device(
        rosenbrock_torch, x0, max_iterations=120, checkpoint_path=jck, checkpoint_every=10,
        write_checkpoints=False,
    )
    assert jck.stat().st_mtime_ns == stamp
    assert_same_run(again, from_jax, xtol=0)


def test_nan_gradient_terminates():
    """A gradient that turns NaN: the port stops there with the host
    optimizer's "NonFinite".  The JAX optimizer never returns in this
    case (its loop condition refuses to step on a NaN gradient while its
    host loop keeps asking for another segment), so it is compared up to
    that iteration, where it returns on its iteration budget."""

    def torch_vg(x):
        x = x.detach().requires_grad_(True)
        f = torch.sum((x - 3.0) ** 2)
        (g,) = torch.autograd.grad(f, x)
        return f.detach(), torch.where(f < 5.0, torch.nan, 1.0) * g

    def jax_vg(x):
        f, g = jax.value_and_grad(lambda v: jnp.sum((v - 3.0) ** 2))(x)
        return f, jnp.where(f < 5.0, jnp.nan, 1.0) * g

    ours = minimize_lbfgs_device(torch_vg, torch.zeros(4, dtype=torch.float64), max_iterations=50)
    assert ours.message == "NonFinite" and np.isnan(ours.g).all()
    assert 0 < ours.iterations < 50
    ref = jax_minimize(jax_vg, jnp.zeros(4), max_iterations=ours.iterations)
    assert np.isnan(np.asarray(ref.g)).all()
    assert (ours.iterations, ours.fun_evals) == (ref.iterations, ref.fun_evals)
    np.testing.assert_allclose(ours.x, ref.x, rtol=1e-12)
    assert ours.f == ref.f
