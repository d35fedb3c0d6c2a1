"""scripts/torch_synthetic_universe.py against
validation/synthetic_universe.py, on the CPU.

The port builds the JAX harness's universes draw for draw (``main``:
512 spectra, seed 12; ``main_multi``: 256 spectra, seed 21): the same
sightlines, continua, injected truth, QMC samples and prior catalogue,
and, in float64, the same absorbed fluxes.  The JAX harness runs with its
inference stubbed (it stops at the driver's call, before it writes any
file under validation/).  On a few of those spectra (200 of the QMC
samples) the port's float64 plain path gives the JAX drivers' results
(``backend="xla"``, x64) within 1e-9.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import gp_dla_detection_tpu.ops.voigt as jax_voigt
import gp_dla_detection_tpu.parallel as jax_parallel
from torch_harness_support import VALIDATION, jax_harness, port_script, start_without_jax

torch.set_num_threads(1)

SU = port_script("torch_synthetic_universe")
PARITY_ROWS, PARITY_SAMPLES = 4, 200
# validation/RESULTS.md and RESULTS_MULTI.md: the JAX harness's universes
RECORDED_INJECTED = 153
RECORDED_MULTIPLICITIES = [92, 86, 78]


class Stopped(Exception):
    """The JAX harness reached its inference driver."""


def jax_universe(fn: str, driver: str) -> dict:
    """The JAX harness's ``fn`` up to its ``driver`` call: the driver's
    arguments and the injected (z, N_HI) of each Voigt call, in order."""
    seen = {"voigt": []}
    real = jax_voigt.voigt_absorption

    def voigt_spy(ext, z, nhi, num_lines=3, **kw):
        seen["voigt"].append((float(z), float(nhi)))
        return real(ext, z, nhi, num_lines=num_lines, **kw)

    def stop(*args, **kw):
        seen.update(args=args, kw=kw)
        raise Stopped

    results = set(VALIDATION.glob("RESULTS*.md"))
    stamps = {p: p.stat().st_mtime_ns for p in results}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_voigt, "voigt_absorption", voigt_spy)
        mp.setattr(jax_parallel, driver, stop)
        with pytest.raises(Stopped):
            jax_harness("synthetic_universe")[fn]()
    assert set(VALIDATION.glob("RESULTS*.md")) == results
    assert all(p.stat().st_mtime_ns == t for p, t in stamps.items())
    return seen


@pytest.fixture(scope="module")
def single():
    return jax_universe("main", "process_spectra_sharded"), SU["build_single"]()


@pytest.fixture(scope="module")
def multi():
    return jax_universe("main_multi", "process_spectra_multi_sharded"), SU["build_multi"]()


def assert_same_universe(jax_run, ours, injected_rows):
    model, offsets, nhis, spectra, prior_z, prior = jax_run["args"]
    for name in ("rest_wavelengths", "mu", "M", "log_omega"):
        np.testing.assert_array_equal(ours.model[name], np.asarray(getattr(model, name)))
    for name in ("log_c_0", "log_tau_0", "log_beta"):
        assert ours.model[name] == getattr(model, name)
    s = ours.spectra
    for name in ("wavelengths", "noise_variance", "mask", "z_qso"):
        np.testing.assert_array_equal(getattr(s, name), getattr(spectra, name), strict=True)
    clean = np.setdiff1d(np.arange(len(s.z_qso)), injected_rows)
    np.testing.assert_array_equal(s.flux[clean], spectra.flux[clean], strict=True)
    # absorbed rows: the two packages' float64 Voigt profiles
    np.testing.assert_allclose(s.flux[injected_rows], spectra.flux[injected_rows], rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(ours.samples.offset_samples, offsets)
    np.testing.assert_allclose(ours.samples.nhi_samples, nhis, rtol=1e-13)
    np.testing.assert_array_equal(ours.prior_z, prior_z)
    np.testing.assert_array_equal(ours.prior, prior)
    assert ours.params.null_model.k == jax_run["kw"]["params"].null_model.k == 20


def assert_same_truth(truth, voigt_calls):
    """The port's injected (z, log10 N_HI), in order, against the JAX
    harness's Voigt calls (z, N_HI): bit for bit."""
    np.testing.assert_array_equal(np.array([z for z, _ in truth]),
                                  np.array([z for z, _ in voigt_calls]))
    np.testing.assert_array_equal(np.array([logn for _, logn in truth]),
                                  np.log10(np.array([n for _, n in voigt_calls])))


def test_single_universe_equals_jax(single):
    jax_run, ours = single
    truth = [(z, logn) for _, z, logn in ours.injected]
    assert len(truth) == len(jax_run["voigt"]) == RECORDED_INJECTED
    assert_same_truth(truth, jax_run["voigt"])
    assert_same_universe(jax_run, ours, np.array([i for i, _, _ in ours.injected]))


def test_multi_universe_equals_jax(multi):
    jax_run, ours = multi
    truth = [zn for i in sorted(ours.injected) for zn in ours.injected[i]]
    assert len(truth) == len(jax_run["voigt"])
    assert_same_truth(truth, jax_run["voigt"])
    counts = np.bincount([len(ours.injected.get(i, [])) for i in range(len(ours.spectra.z_qso))],
                         minlength=3)
    assert counts.tolist() == RECORDED_MULTIPLICITIES
    assert_same_universe(jax_run, ours, np.array(sorted(ours.injected)))


def _parity_inputs(jax_run, ours, rows):
    """The JAX driver's arguments and the port's universe cut to ``rows``
    and the first PARITY_SAMPLES QMC samples."""
    model, offsets, nhis, spectra, prior_z, prior = jax_run["args"]
    cut = lambda sp: type(sp)(sp.wavelengths[rows], sp.flux[rows], sp.noise_variance[rows],
                              sp.mask[rows], sp.z_qso[rows])
    samples = types.SimpleNamespace(offset_samples=offsets[:PARITY_SAMPLES],
                                    nhi_samples=nhis[:PARITY_SAMPLES])
    jax_args = (model, offsets[:PARITY_SAMPLES], nhis[:PARITY_SAMPLES], cut(spectra), prior_z,
                prior)
    return jax_args, dataclasses.replace(ours, samples=samples), cut(ours.spectra)


def _jax_config(batch):
    return jax_parallel.ShardedRunConfig(per_device_batch=batch, sample_chunk=100,
                                         dtype="float64", backend="xla")


def test_single_float64_matches_jax(single):
    jax_run, ours = single
    rows = np.r_[ours.injected[0][0], ours.injected[1][0], 0, 1][:PARITY_ROWS]
    jax_args, small, spectra = _parity_inputs(jax_run, ours, rows)
    ref = jax_parallel.process_spectra_sharded(
        *jax_args, params=jax_run["kw"]["params"], mesh=jax_parallel.make_mesh(num_devices=1),
        config=_jax_config(PARITY_ROWS))
    got = SU["infer_single"](small, spectra=spectra, device="cpu", dtype="float64")
    for name in ("p_dlas", "log_likelihoods_no_dla", "log_likelihoods_dla",
                 "sample_log_likelihoods_dla", "min_z_dlas", "max_z_dlas"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-300, err_msg=name)
    assert (got.p_dlas[:2] > 0.9).all()


def test_multi_float64_matches_jax(multi):
    jax_run, ours = multi
    doubles = [i for i in sorted(ours.injected) if len(ours.injected[i]) == 2]
    singles = [i for i in sorted(ours.injected) if len(ours.injected[i]) == 1]
    clean = [i for i in range(len(ours.spectra.z_qso)) if i not in ours.injected]
    rows = np.array([doubles[0], doubles[1], singles[0], clean[0]])
    jax_args, small, spectra = _parity_inputs(jax_run, ours, rows)
    ref = jax_parallel.process_spectra_multi_sharded(
        *jax_args, params=jax_run["kw"]["params"], mesh=jax_parallel.make_mesh(num_devices=1),
        config=_jax_config(PARITY_ROWS))
    got = SU["infer_multi"](small, spectra=spectra, device="cpu", dtype="float64")
    for name in ("model_posteriors", "log_likelihoods_dla2", "sample_log_likelihoods_dla2"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-300, err_msg=name)
    np.testing.assert_array_equal(got.base_sample_inds, np.asarray(ref.base_sample_inds))


def test_without_a_card_the_default_run_raises(tmp_path):
    proc = start_without_jax(["scripts/torch_synthetic_universe.py", "--n-spectra", "4"],
                             tmp_path / "block")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "UNIVERSE" not in out and "no CUDA device" in err
