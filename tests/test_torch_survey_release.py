"""scripts/torch_survey_release.py against validation/survey_release.py,
on the CPU at toy size (12 sightlines).

The port's worker (the lean + CDDF multi stage and the ASCII stage,
float64, the plain path) and its analysis stage give the JAX worker's
and ``Pipeline.run_analysis``'s results (``backend="xla"``, x64) on the
same artifacts within 1e-9; the full ``orchestrate``, run in processes
where jax and the JAX package cannot be imported, builds the universe,
kills a real worker, resumes, and gives the uninterrupted worker's
catalogue bit for bit; the worker's JSON and the report carry the JAX
script's keys.
"""

import contextlib
import io
import json
import warnings

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu import Parameters as JaxParameters
from gp_dla_detection_tpu.params import NullModelParams as JaxNullModelParams
from gp_dla_detection_tpu.pipeline import Pipeline as JaxPipeline
from gp_dla_detection_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig
from torch_harness_support import (
    N_SPECTRA,
    PARITY_SAMPLES,
    SEED,
    TOY_BATCH,
    TOY_SAMPLES,
    VALIDATION,
    assert_npz_close,
    assert_npz_equal,
    finish,
    jax_harness,
    jax_on_the_plain_path,
    marked_json,
    port_script,
    printed_labels,
    report_labels,
    start_without_jax,
)

torch.set_num_threads(1)

LEAN = dict(multi_dla=True, store_sample_likelihoods=False, cddf_inputs=True)
VARIANCE_CHANNELS = [3, 4]   # cddf_inputs.CH_P_VAR, CH_P_VAR_NU2
ASCII = ("dr12q_results.dat", "dr12q_multi_results.dat", "dr12q_spectra.dat",
         "dr12q_dla_samples.dat")


@pytest.fixture(scope="module")
def orchestrated(tmp_path_factory):
    """The release's orchestrate on a toy universe it builds itself, then
    an uninterrupted worker at the same batch in a second directory;
    started at once and read when a test asks."""
    root = tmp_path_factory.mktemp("release")
    wd = root / "work"
    common = ["--workdir", str(wd), "--batch", str(TOY_BATCH), "--device", "cpu"]
    code = (
        "import subprocess, sys\n"
        f"for argv in {[['scripts/torch_survey_release.py', *common, '--n-spectra', str(N_SPECTRA), '--num-samples', str(TOY_SAMPLES), '--seed', str(SEED)], ['scripts/torch_survey_release.py', '--worker', *common, '--run-name', 'uninterrupted']]!r}:\n"
        "    subprocess.run([sys.executable, *argv], check=True)\n"
    )
    proc = start_without_jax(["-c", code], root / "block")
    state = {}

    def result():
        if not state:
            state["out"] = finish(proc, timeout=400)
        return state["out"], wd

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def parity(tmp_path_factory, orchestrated):
    """The port's worker and analysis (float64, the plain path, on the
    CPU) and the JAX harness's worker and ``run_analysis``
    (``backend="xla"``, float64) on one universe with PARITY_SAMPLES
    samples; the JAX harness writes under ``release``."""
    wd = tmp_path_factory.mktemp("parity")
    port_script("torch_scale_rehearsal")["build"](wd, N_SPECTRA, SEED, PARITY_SAMPLES,
                                                   device="cpu")
    ours = port_script("torch_survey_release")["worker"](
        wd, 4, device="cpu", run_name="port", dtype="float64", backend="torch")
    stats = Pipeline(params(), PipelineConfig(
        workdir=str(wd / "port"), device="cpu", dtype="float64", **LEAN,
    )).run_analysis(force=True, plots=False)
    printed = io.StringIO()
    with jax_on_the_plain_path(), warnings.catch_warnings(), contextlib.redirect_stdout(printed):
        warnings.simplefilter("ignore", UserWarning)
        jax_harness("survey_release")["worker"](wd, 1)
        jax_stats = JaxPipeline(
            JaxParameters(null_model=JaxNullModelParams(k=20)),
            JaxPipelineConfig(workdir=str(wd / "release"), compilation_cache=False, **LEAN),
        ).run_analysis(force=True, plots=False)
    return wd, ours, stats, jax_stats, marked_json(printed.getvalue(), "WORKER COMPLETE")


def params():
    return port_script("torch_scale_rehearsal")["rehearsal_params"]()


def parse_dat(path):
    rows = [line.split() for line in path.read_text().strip().split("\n")]
    return [r[:2] for r in rows], np.array([[float(v) for v in r[2:]] for r in rows])


def assert_json_close(a, b, where="statistics"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_json_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=1e-9,
                                   atol=0, err_msg=where)
    else:
        assert a == b, where


def test_lean_release_matches_jax(parity):
    wd, _, stats, jax_stats, _ = parity
    assert_npz_close(wd / "port" / "dla_samples.npz", wd / "release" / "dla_samples.npz")
    with np.load(wd / "port" / "processed_qsos_multi_dr12q.npz") as a, \
            np.load(wd / "release" / "processed_qsos_multi_dr12q.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "cddf_hist" in a.files and "sample_log_likelihoods_dla" not in a.files
        for k in a.files:
            x, y = a[k], b[k]
            if k == "cddf_hist":
                # the port clamps each sample's Bernoulli variance p (1 - p) at
                # 0 (ROADMAP C, deliberate differences): a posterior peaked on
                # one sample gives p = 1 + 1 ulp, and JAX a negative variance
                y = y.copy()
                assert (y[:, VARIANCE_CHANNELS] < 0).any()
                y[:, VARIANCE_CHANNELS] = np.maximum(y[:, VARIANCE_CHANNELS], 0.0)
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(x, y, err_msg=k)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-300, err_msg=k)
    for name in ASCII:
        if name == "dr12q_dla_samples.dat":
            a = np.loadtxt(wd / "port" / name)
            b = np.loadtxt(wd / "release" / name)
        else:
            (ids_a, a), (ids_b, b) = parse_dat(wd / "port" / name), parse_dat(wd / "release" / name)
            assert ids_a == ids_b, name
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=name)
    assert stats["lean_inputs"] is True
    # the same clamp: JAX's Omega_DLA error bar is the square root of the
    # negative variance there, NaN, the port's finite
    err, jax_err = (np.asarray(s["omega_dla_direct"]["err"], float) for s in (stats, jax_stats))
    assert np.isnan(jax_err).any() and np.isfinite(err).all()
    jax_stats["omega_dla_direct"]["err"] = np.where(np.isnan(jax_err), err, jax_err).tolist()
    assert_json_close(stats, jax_stats)


def test_worker_json_keys_are_the_jax_workers(parity):
    wd, ours, _, _, theirs = parity
    assert set(ours) == set(theirs) | {"launches"}
    assert sorted(ours["ascii"]) == sorted(theirs["ascii"])
    assert set(ours["launches"]) == {"single", "pair", "null", "redraw", "cddf"}
    # on the plain path no kernel runs
    assert not any(ours["launches"].values())


def test_orchestrate_kill_resume_is_bit_identical(orchestrated):
    out, wd = orchestrated()
    summary = marked_json(out, "RELEASE")
    assert "RELEASE OK" in out
    assert summary["build"]["build_s"] > 0 and summary["n_batches"] == N_SPECTRA
    assert summary["killed"] and summary["kill_point"] < N_SPECTRA
    assert summary["expected_launches"]["single"] == N_SPECTRA - summary["kill_point"]
    assert summary["exact_multiplicity_acc"] > 0.95
    # the resumed catalogue, its CDDF inputs included, is the
    # uninterrupted worker's
    assert_npz_equal(wd / "release" / "processed_qsos_multi_dr12q.npz",
                     wd / "uninterrupted" / "processed_qsos_multi_dr12q.npz")
    for name in ASCII:
        assert (wd / "release" / name).read_text() == (wd / "uninterrupted" / name).read_text()
    stats = json.loads((wd / "release" / "analysis" / "statistics.json").read_text())
    assert stats["lean_inputs"] is True
    assert (wd / "release_report.md").read_text().startswith("# One-command lean release")
    # the JAX report's labels, less the tunnel-epoch probe's and the
    # classic A/B's (printed only beside a classic catalogue)
    dropped = {"epoch calibration (adjacent upload-stream probe)", "classic statistics pass"}
    assert "lean-vs-classic survey statistics A/B skipped" in out
    assert report_labels(VALIDATION / "survey_release.py", "orchestrate") - dropped <= (
        printed_labels(out))
