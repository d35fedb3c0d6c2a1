"""The port's numerics ops against the JAX package's on the same inputs.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: float64 ops agree with JAX to 1e-10 relative or better (the
same formulas in the same order); float32 ops to 1e-5 relative;
interpolation is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import wofz

from gp_dla_detection_tpu.ops import faddeeva as jf
from gp_dla_detection_tpu.ops import interp as ji
from gp_dla_detection_tpu.ops import low_rank_mvn as jl
from gp_dla_detection_tpu.ops import voigt as jv
from gp_dla_detection_tpu.params import InstrumentParams
from gp_dla_detection_tpu_torch.ops import faddeeva as pf
from gp_dla_detection_tpu_torch.ops import interp as pi
from gp_dla_detection_tpu_torch.ops import low_rank_mvn as pl
from gp_dla_detection_tpu_torch.ops import lyman_series as lines
from gp_dla_detection_tpu_torch.ops import voigt as pv

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

LINE_YS = lines.LORENTZIAN_WIDTHS / (lines.DOPPLER_SIGMA * np.sqrt(2.0))
X_SWEEP = np.concatenate([np.linspace(0.0, 10.0, 4001), 10 ** np.linspace(1.0, 4.2, 1001)])


def rel_err(approx, exact):
    approx, exact = np.asarray(approx, np.float64), np.asarray(exact, np.float64)
    return np.max(np.abs((approx - exact) / exact))


@pytest.mark.parametrize("y", [*LINE_YS[:3], LINE_YS[30], 0.01, 0.5, 3.0])
def test_wofz_real_matches_jax_and_scipy(y):
    x = np.concatenate([-X_SWEEP[::7], X_SWEEP])
    yy = np.full_like(x, y)
    ours = pf.wofz_real(torch.as_tensor(x), torch.as_tensor(yy)).numpy()
    assert rel_err(ours, np.asarray(jf.wofz_real(x, yy))) < 1e-12
    # the JAX package's own scipy bound (tests/test_faddeeva.py)
    assert rel_err(ours, wofz(x + 1j * y).real) < 5e-8


@pytest.mark.parametrize("y", [*LINE_YS[[0, 1, 2, 30]]])
def test_wofz_real_fast_matches_jax_and_scipy(y):
    yy = np.full_like(X_SWEEP, y)
    ours = pf.wofz_real_fast(torch.as_tensor(X_SWEEP), torch.as_tensor(yy)).numpy()
    assert rel_err(ours, np.asarray(jf.wofz_real_fast(X_SWEEP, yy))) < 1e-12
    assert rel_err(ours, wofz(X_SWEEP + 1j * y).real) < 1.6e-5
    # float32: same dtype out, close to the JAX float32 evaluation
    x32, y32 = X_SWEEP.astype(np.float32), yy.astype(np.float32)
    o32 = pf.wofz_real_fast(torch.as_tensor(x32), torch.as_tensor(y32))
    assert o32.dtype == torch.float32
    assert rel_err(o32.numpy(), np.asarray(jf.wofz_real_fast(x32, y32))) < 1e-5


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_stack_uniform_bit_equal(dtype):
    rng = np.random.default_rng(3)
    grid = (911.75 + 0.25 * np.arange(1217)).astype(dtype)
    mu = rng.normal(size=1217).astype(dtype)
    M = rng.normal(size=(1217, 5)).astype(dtype)
    # random queries, every knot exactly, and the two ends
    x = np.concatenate([rng.uniform(911.75, 1215.75, 2000), grid, [911.75, 1215.75]]).astype(dtype)
    xb = np.stack([x, x[::-1]])                       # a batch axis
    ours = pi.interp_stack_uniform(
        torch.as_tensor(grid), (torch.as_tensor(mu), torch.as_tensor(M)), torch.as_tensor(xb)
    )
    for b in range(2):
        ref = ji.interp_stack_uniform(jnp.asarray(grid), (jnp.asarray(mu), jnp.asarray(M)), jnp.asarray(xb[b]))
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o[b].numpy(), np.asarray(r))


def _mvn_problem(seed=0, n=300, k=6, S=40):
    rng = np.random.default_rng(seed)
    y = rng.normal(1.0, 0.3, n)
    mu = 1.0 + 0.1 * np.sin(np.arange(n) / 30)
    M = rng.normal(size=(n, k)) * 0.08
    omega2 = rng.uniform(0.01, 0.05, n)
    noise = rng.uniform(0.05, 0.2, n)
    mask = rng.uniform(size=n) > 0.05
    absorption = np.clip(rng.uniform(0.0, 1.3, (S, n)), 0.0, 1.0)
    return y, mu, M, omega2, noise, mask, absorption


def test_log_mvnpdf_low_rank_matches_jax():
    y, mu, M, omega2, noise, mask, _ = _mvn_problem()
    t = torch.as_tensor
    ours = pl.log_mvnpdf_low_rank(t(y), t(mu), t(M), t(omega2 + noise), mask=t(mask))
    ref = jl.log_mvnpdf_low_rank(y, mu, M, omega2 + noise, mask=mask)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10)
    # batched over spectra: each row equals its single-spectrum value
    batched = pl.log_mvnpdf_low_rank(
        t(np.stack([y, y[::-1]])), t(np.stack([mu, mu])), t(np.stack([M, M])),
        t(np.stack([omega2 + noise] * 2)), mask=t(np.stack([mask, mask])),
    )
    np.testing.assert_allclose(batched[0].numpy(), ours.numpy(), rtol=1e-12)


def test_batched_dla_log_likelihoods_matches_jax():
    y, mu, M, omega2, noise, mask, absorption = _mvn_problem(seed=1)
    t = torch.as_tensor
    ours = pl.batched_dla_log_likelihoods(t(y), t(mu), t(M), t(omega2), t(noise), t(mask), t(absorption))
    ref = jl.batched_dla_log_likelihoods(y, mu, M, omega2, noise, mask, absorption)
    assert ours.shape == (absorption.shape[0],)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10)


def _voigt_problem(seed=2, n=500, S=48, B=2):
    rng = np.random.default_rng(seed)
    inst = InstrumentParams()
    lam = np.stack([10 ** (np.log10(3600.0 + 150 * b) + 1e-4 * np.arange(n)) for b in range(B)])
    ext = pv.extend_wavelengths(lam, inst)
    zc = ext[:, inst.width + n // 2] / 1215.6701 - 1
    z = np.sort(rng.uniform(zc[:, None] - 0.01, zc[:, None] + 0.01, (B, S)), axis=1)
    nhi = 10 ** rng.uniform(20.0, 22.0, (B, S))
    return inst, ext, z, nhi


def test_extend_and_broaden_match_jax():
    inst, ext, _, _ = _voigt_problem()
    lam = ext[:, inst.width : -inst.width]
    np.testing.assert_array_equal(pv.extend_wavelengths(lam, inst), jv.extend_wavelengths(lam, inst))
    raw = np.random.default_rng(0).uniform(size=(3, 40))
    np.testing.assert_allclose(
        pv.instrumental_broadening(torch.as_tensor(raw), inst).numpy(),
        np.asarray(jv.instrumental_broadening(raw, inst)), rtol=1e-14,
    )


def test_voigt_absorption_f64_matches_jax():
    inst, ext, z, nhi = _voigt_problem()
    ours = pv.voigt_absorption(torch.as_tensor(ext), torch.as_tensor(z), torch.as_tensor(nhi))
    assert ours.shape == (2, z.shape[1], ext.shape[1] - 2 * inst.width)
    for b in range(2):
        ref = np.asarray(jv.voigt_absorption(ext[b], z[b], nhi[b]))
        np.testing.assert_allclose(ours[b].numpy(), ref, rtol=1e-10, atol=1e-250)
    # a scalar sample gives one profile
    one = pv.voigt_absorption(torch.as_tensor(ext[0]), float(z[0, 0]), float(nhi[0, 0]))
    np.testing.assert_allclose(one.numpy(), ours[0, 0].numpy(), rtol=1e-14)


@pytest.mark.parametrize("num_lines", [3, 31])
def test_voigt_absorption_windowed_f32_matches_jax(num_lines):
    inst, ext, z, nhi = _voigt_problem(seed=4)
    f32 = lambda a: np.asarray(a, np.float32)
    ours = pv.voigt_absorption_windowed(
        torch.as_tensor(f32(ext)), torch.as_tensor(f32(z)), torch.as_tensor(f32(nhi)),
        num_lines=num_lines, window=160,
    )
    for b in range(2):
        ref = np.asarray(
            jv.voigt_absorption_windowed(f32(ext[b]), f32(z[b]), f32(nhi[b]), num_lines=num_lines, window=160)
        )
        # float32: 1e-5 relative, with an absolute floor of 1e-6 of the
        # unit continuum for profile values near zero
        np.testing.assert_allclose(ours[b].numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        pv.voigt_absorption_windowed(torch.as_tensor(ext), torch.as_tensor(z), torch.as_tensor(nhi))
