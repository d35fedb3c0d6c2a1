"""The port's pipeline against the JAX package's, on the synthetic release.

FITS files on disk -> catalog -> preload -> (model) -> samples -> process
-> SNRs -> multi -> ASCII -> statistics, classic and lean with CDDF
inputs, torch backend in float64.  The JAX-learned model is copied into
the port's workdir, so that the downstream stages compare at 1e-9
(the training is compared in tests/test_torch_training.py).  Also: a
resume recomputes nothing, the CLI runs ``--stage all`` in a process
where jax cannot be imported, and ``backend="cuda"`` without a CUDA
device raises.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.params import DLASamplingParams, NullModelParams, OptimizationParams
from gp_dla_detection_tpu.pipeline import Pipeline as JaxPipeline
from gp_dla_detection_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from gp_dla_detection_tpu_torch.pipeline import Pipeline, PipelineConfig, main

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

MODES = {
    "classic": dict(multi_dla=True, export_matlab=True),
    "lean_cddf": dict(multi_dla=True, store_sample_likelihoods=False, cddf_inputs=True),
}


def small_params(base):
    """tests/test_pipeline.py's test-sized parameter set."""
    return dataclasses.replace(
        base,
        null_model=NullModelParams(k=3),
        optimization=OptimizationParams(max_iterations=15, max_fun_evals=30),
        dla_sampling=DLASamplingParams(num_dla_samples=100),
    )


def port_config(workdir, **mode):
    return PipelineConfig(
        workdir=str(workdir), per_device_batch=4, sample_chunk=50, dtype="float64",
        backend="torch", device="cpu", **mode,
    )


def assert_npz_close(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files), (a.files, b.files)
        for k in a.files:
            x, y = a[k], b[k]
            if x.dtype.kind in "biuU":
                np.testing.assert_array_equal(x, y, err_msg=k)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-300, err_msg=k)


def parse_dat(path):
    rows = [line.split() for line in Path(path).read_text().strip().split("\n")]
    ids = [r[:2] for r in rows]
    nums = np.array([[float(v) for v in r[2:]] for r in rows])
    return ids, nums


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


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_all_matches_jax(synthetic_release, tmp_path, mode):
    params = small_params(synthetic_release)
    jax_pipe = JaxPipeline(params, JaxPipelineConfig(
        workdir=str(tmp_path / "jax"), per_device_batch=1, sample_chunk=50, dtype="float64",
        compilation_cache=False, **MODES[mode],
    ))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jax_summary = jax_pipe.run_all()

    pipe = Pipeline(params, port_config(tmp_path / "port", **MODES[mode]))
    shutil.copy(jax_pipe.model_path, pipe.model_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        summary = pipe.run_all()

    paths = lambda s: {k: Path(v).name for k, v in s["artifacts"].items()}
    assert paths(summary) == paths(jax_summary)
    assert {k: v for k, v in summary.items() if k != "artifacts"} == {
        k: v for k, v in jax_summary.items() if k != "artifacts"
    }
    assert summary["num_processed"] == 8
    for name in ("catalog.npz", "preloaded_qsos.npz", "dla_samples.npz", "snrs.npz",
                 "processed_qsos_dr12q.npz", "processed_qsos_multi_dr12q.npz"):
        assert_npz_close(pipe.workdir / name, jax_pipe.workdir / name)
    with np.load(pipe.multi_results_path) as f:
        assert ("cddf_hist" in f.files) == (mode == "lean_cddf")
        mp = f["multi_model_posteriors"]
    ok = np.isfinite(mp).all(axis=1)
    assert ok.sum() >= 5
    np.testing.assert_allclose(mp[ok].sum(axis=1), 1.0, rtol=1e-12)

    for name in ("dr12q_results.dat", "dr12q_multi_results.dat", "dr12q_spectra.dat",
                 "dr12q_dla_samples.dat"):
        if name == "dr12q_dla_samples.dat":
            a = np.loadtxt(pipe.workdir / name)
            b = np.loadtxt(jax_pipe.workdir / name)
        else:
            (ids_a, a), (ids_b, b) = parse_dat(pipe.workdir / name), parse_dat(jax_pipe.workdir / name)
            assert ids_a == ids_b, name
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=name)

    # the .mat v7.3 exports (classic), the multi one with the alias flag
    mats = sorted(p.name for p in jax_pipe.workdir.glob("*.mat"))
    assert mats == sorted(p.name for p in pipe.workdir.glob("*.mat"))
    assert len(mats) == (4 if mode == "classic" else 0)
    for name in mats:
        with h5py.File(pipe.workdir / name) as a, h5py.File(jax_pipe.workdir / name) as b:
            assert sorted(a.keys()) == sorted(b.keys()), name
            for k in b.keys():
                x, y = a[k][()], b[k][()]
                assert a[k].attrs.get("MATLAB_class") == b[k].attrs.get("MATLAB_class"), k
                if x.dtype.kind == "f":
                    np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-300, err_msg=f"{name}:{k}")
                else:
                    np.testing.assert_array_equal(x, y, err_msg=f"{name}:{k}")

    stats = json.loads((pipe.workdir / "analysis" / "statistics.json").read_text())
    assert stats["lean_inputs"] is (mode == "lean_cddf")
    assert_json_close(
        stats, json.loads((jax_pipe.workdir / "analysis" / "statistics.json").read_text())
    )

    # resume: a second run loads every artifact, recomputing nothing
    stamps = {
        p: p.stat().st_mtime_ns
        for p in (pipe.model_path, pipe.results_path, pipe.multi_results_path,
                  pipe.workdir / "analysis" / "statistics.json")
    }
    assert Pipeline(params, port_config(tmp_path / "port", **MODES[mode])).run_all() == summary
    for p, t in stamps.items():
        assert p.stat().st_mtime_ns == t, f"{p} recomputed on resume"


def test_cli_runs_without_jax(synthetic_release, tmp_path):
    """``python -m gp_dla_detection_tpu_torch.pipeline --stage all`` (the
    lean CDDF release) in a process where jax cannot be imported, with
    the test-sized parameter set: learning, the multi-DLA ASCII catalogue
    and the lean statistics all run on the port alone."""
    workdir = tmp_path / "run"
    code = (
        "import dataclasses, runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import gp_dla_detection_tpu.params as P\n"
        "full = P.Parameters\n"
        "P.Parameters = lambda **kw: dataclasses.replace(\n"
        "    full(**kw), null_model=P.NullModelParams(k=3),\n"
        "    optimization=P.OptimizationParams(max_iterations=15, max_fun_evals=30),\n"
        "    dla_sampling=P.DLASamplingParams(num_dla_samples=50))\n"
        f"sys.argv = ['pipeline', '--workdir', {str(workdir)!r}, '--base-directory',\n"
        f"    {str(synthetic_release.base_directory)!r}, '--device', 'cpu', '--dtype', 'float64',\n"
        "    '--per-device-batch', '4', '--lean', '--multi-dla', '--cddf-inputs']\n"
        "runpy.run_module('gp_dla_detection_tpu_torch.pipeline', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert summary["num_processed"] == 8
    assert (workdir / "learned_qso_model_dr9q_minus_concordance.npz").exists()
    assert len((workdir / "dr12q_multi_results.dat").read_text().strip().split("\n")) == 8
    stats = json.loads((workdir / "analysis" / "statistics.json").read_text())
    assert stats["lean_inputs"] is True
    assert np.all(np.isfinite(stats["omega_dla_direct"]["omega"]))


def test_config_refusals(synthetic_release, tmp_path):
    with pytest.raises(ValueError, match="float32-only"):
        PipelineConfig(backend="cuda", dtype="float64")
    with pytest.raises(ValueError, match="CUDA device"):
        PipelineConfig(backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        PipelineConfig(backend="xla")
    with pytest.raises(ValueError, match="cddf_inputs=True requires"):
        PipelineConfig(cddf_inputs=True, multi_dla=True)
    with pytest.raises(ValueError, match="base_replicates"):
        PipelineConfig(base_replicates=4)
    with pytest.raises(ValueError, match=".mat export"):
        PipelineConfig(store_sample_likelihoods=False, export_matlab=True)
    if not torch.cuda.is_available():
        # no quiet move to the CPU: the CUDA backend (or device) without
        # a card raises before any stage runs
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--workdir", str(tmp_path / "run"), "--backend", "cuda",
                  "--base-directory", str(synthetic_release.base_directory)])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Pipeline(small_params(synthetic_release), PipelineConfig(workdir=str(tmp_path)))
