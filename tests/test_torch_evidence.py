"""The port's plain evidence path against the JAX Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_evidence_pallas.py runs it; the port's wrapper, given CPU
tensors, runs its plain PyTorch version.  Bound: the 5e-5 normalized
error of tests/test_evidence_pallas.py (two float32 implementations that
sum in different orders).  The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.ops.evidence_pallas import pallas_sample_log_likelihoods
from gp_dla_detection_tpu.params import InstrumentParams
from gp_dla_detection_tpu_torch.inference import batch_log_likelihoods as port_batch
from gp_dla_detection_tpu_torch.ops import evidence

from test_evidence_pallas import make_problem, run

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

BOUND = 5e-5


def normalized_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))


def kernel_inputs(B=2, P=384, S=160, k=5, seed=0):
    """Prepared per-spectrum inputs at the Pallas test's sizes, with the
    samples z-sorted in a narrow band so a 256-pixel window covers any
    tile of them."""
    rng = np.random.default_rng(seed)
    w = InstrumentParams().width
    P6 = P + 2 * w
    lam = np.stack(
        [10 ** (np.log10(3600.0 + 40 * b) + 1e-4 * np.arange(P6)) for b in range(B)]
    )
    flux = rng.normal(1, 0.3, (B, P))
    mu = 1.0 + 0.1 * np.sin(np.arange(P) / 40)[None, :].repeat(B, 0)
    M = rng.normal(size=(B, P, k)) * 0.08
    omega2 = rng.uniform(0.01, 0.05, (B, P))
    noise = rng.uniform(0.05, 0.2, (B, P))
    mask = rng.uniform(size=(B, P)) > 0.05
    zc = lam[:, w + P // 2] / 1215.6701 - 1
    z = np.sort(rng.uniform(zc[:, None] - 0.02, zc[:, None] + 0.02, (B, S)), axis=1)
    nhi = 10 ** rng.uniform(20, 22, (B, S))
    return [a.astype(np.float32) if a.dtype != bool else a
            for a in (lam, flux, mu, M, omega2, noise, mask, z, nhi)]


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("S", [160, 130])
def test_plain_evidence_matches_pallas_interpret(S, window):
    arrays = kernel_inputs(S=S)
    ref = pallas_sample_log_likelihoods(
        *[jnp.asarray(a) for a in arrays], num_lines=3, tile=128,
        interpret=True, window=window,
    )
    ours = evidence.sample_log_likelihoods(
        *[torch.as_tensor(a) for a in arrays], num_lines=3, window=window
    )
    assert ours.dtype == torch.float32 and ours.shape == (2, S)
    assert normalized_err(ours.numpy(), ref) < BOUND


def test_plain_evidence_windowed_equals_full_grid():
    # outside the window the Gaussian core is below 1.4e-11 relative
    arrays = [torch.as_tensor(a) for a in kernel_inputs(S=130)]
    full = evidence.sample_log_likelihoods_reference(*arrays, window=None)
    win = evidence.sample_log_likelihoods_reference(*arrays, window=256)
    assert normalized_err(win.numpy(), full.numpy()) < 1e-6


def test_masked_nonfinite_inputs_are_neutralized():
    # NaN flux, inf noise and an overflowed omega2 on masked pixels must
    # not reach any sum (the Pallas wrapper's precondition)
    lam, flux, mu, M, omega2, noise, mask, z, nhi = kernel_inputs(B=1, S=64, seed=5)
    clean = evidence.sample_log_likelihoods_reference(
        *[torch.as_tensor(a) for a in (lam, flux, mu, M, omega2, noise, mask, z, nhi)]
    )
    mask[0, -8:] = False
    clean_masked = evidence.sample_log_likelihoods_reference(
        *[torch.as_tensor(a) for a in (lam, flux, mu, M, omega2, noise, mask, z, nhi)]
    )
    flux[0, -8:] = np.nan
    noise[0, -6:] = np.inf
    omega2[0, -4:] = np.inf
    dirty = evidence.sample_log_likelihoods_reference(
        *[torch.as_tensor(a) for a in (lam, flux, mu, M, omega2, noise, mask, z, nhi)]
    )
    assert torch.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty.numpy(), clean_masked.numpy())
    assert not np.array_equal(clean.numpy(), clean_masked.numpy())


def test_extended_grid_width_is_checked():
    arrays = [torch.as_tensor(a) for a in kernel_inputs(S=16)]
    arrays[0] = arrays[0][:, :-1]
    with pytest.raises(ValueError, match="convolution-padding"):
        evidence.sample_log_likelihoods(*arrays)


def test_windowed_chunks_must_fit_the_window_span():
    arrays = [torch.as_tensor(a) for a in kernel_inputs(S=16)]
    with pytest.raises(ValueError, match="exceed"):
        evidence.sample_log_likelihoods_reference(
            *arrays, window=256, sample_chunk=evidence.SAMPLE_TILE + 1
        )


def _port_run(params, model, spectra, offsets, nhis, dtype=torch.float32, **kw):
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)
    return port_batch(
        t(spectra.wavelengths), t(spectra.flux), t(spectra.noise_variance),
        torch.as_tensor(spectra.mask), t(spectra.z_qso),
        t(model.rest_wavelengths), t(model.mu), t(model.M), t(model.log_omega),
        model.log_c_0, model.log_tau_0, model.log_beta, t(offsets), t(nhis),
        params=params, **kw,
    )


@pytest.mark.parametrize("S", [160, 130])
def test_batch_log_likelihoods_matches_pallas_interpret(S):
    prob = make_problem(S=S)
    ref = run("pallas_interpret", *prob)
    ours = _port_run(*prob, sample_chunk=32)
    assert normalized_err(
        ours["sample_log_likelihoods_dla"].numpy(), ref["sample_log_likelihoods_dla"]
    ) < BOUND
    np.testing.assert_allclose(
        ours["log_likelihood_no_dla"].numpy(), np.asarray(ref["log_likelihood_no_dla"]),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        ours["min_z_dla"].numpy(), np.asarray(ref["min_z_dla"]), rtol=1e-6
    )


def _line_count_problem(seed=0, B=2, P=384, k=4, S=64):
    """tests/test_evidence_pallas.py::test_line_loop_matches_unrolled's
    inputs: one grid from 3600 Å, samples z-sorted in a narrow band
    around an anchor line's center mid-grid."""
    rng = np.random.default_rng(seed)
    w = InstrumentParams().width
    P6 = P + 2 * w
    f32 = np.float32
    lam = np.stack([10 ** (np.log10(3600.0) + 1e-4 * np.arange(P6))] * B).astype(f32)
    arrays = [
        lam,
        rng.normal(1, 0.3, (B, P)).astype(f32),
        np.ones((B, P), f32),
        (rng.normal(size=(B, P, k)) * 0.1).astype(f32),
        rng.uniform(0.01, 0.05, (B, P)).astype(f32),
        rng.uniform(0.05, 0.2, (B, P)).astype(f32),
        rng.uniform(size=(B, P)) > 0.05,
    ]

    def sample_z(anchor_lambda):
        zc = lam[:, w + P // 2] / anchor_lambda - 1
        return np.sort(rng.uniform(zc[:, None] - 0.02, zc[:, None] + 0.02, (B, S)), axis=1).astype(f32)

    nhi = (10 ** rng.uniform(20, 22, (B, S))).astype(f32)
    return arrays, sample_z, nhi


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("num_lines", [9, 31])
def test_plain_evidence_matches_pallas_interpret_at_many_lines(num_lines, window):
    # beyond the 8-line unroll the TPU kernel loops over its line table
    # (windowed); samples around Lyα's core mid-grid
    arrays, sample_z, nhi = _line_count_problem()
    z = sample_z(1215.6701)
    ref = pallas_sample_log_likelihoods(
        *[jnp.asarray(a) for a in (*arrays, z, nhi)], num_lines=num_lines,
        interpret=True, tile=64, window=window,
    )
    ours = evidence.sample_log_likelihoods(
        *[torch.as_tensor(a) for a in (*arrays, z, nhi)], num_lines=num_lines,
        window=window,
    )
    assert normalized_err(ours.numpy(), ref) < BOUND


# float32 position rounding with saturated high-order line cores on the
# grid: one ulp of lambda * c / (lambda_t (1 + z)) ~ 3e10 cm/s is ~1e-3
# Doppler widths, and moves evidences by ~3-5e-4 normalized from the
# float64 evaluation of the same formula, for the Pallas kernel and the
# port alike; the two round the line multiplier in another order
# ((c / (lambda_t 1e8)) / (1 + z) against c / (lambda_t (1 + z)) / 1e8),
# so they differ from each other by as much
F32_POSITION_BOUND = 1e-3


def test_plain_evidence_at_a_high_order_line_anchor():
    # z anchored at line 9's core (the loop-vs-unroll geometry of
    # tests/test_evidence_pallas.py), so lines 4-9 dominate
    arrays, sample_z, nhi = _line_count_problem()
    z = sample_z(920.9631)
    ref = np.asarray(pallas_sample_log_likelihoods(
        *[jnp.asarray(a) for a in (*arrays, z, nhi)], num_lines=9,
        interpret=True, tile=64, window=256,
    ))
    t = [torch.as_tensor(a) for a in (*arrays, z, nhi)]
    ours = evidence.sample_log_likelihoods(*t, num_lines=9, window=256).numpy()
    exact = evidence.sample_log_likelihoods_reference(
        *[a.double() if a.is_floating_point() else a for a in t], num_lines=9,
    ).numpy()
    assert normalized_err(ours, ref) < F32_POSITION_BOUND
    assert normalized_err(ours, exact) < F32_POSITION_BOUND
    assert normalized_err(ref, exact) < F32_POSITION_BOUND
