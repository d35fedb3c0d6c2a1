"""scripts/torch_scale_demo.py against scripts/scale_demo.py at toy size
(6 spectra x 120 samples, seed 3): the port's script, run on the CPU in
a process where jax and the JAX package cannot be imported, prints the
JAX script's JSON lines with the same three rates, and draws the same
workload (model, spectra, injected DLAs, QMC samples, prior catalogue)
from the same seed."""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import gp_dla_detection_tpu.parallel as jax_parallel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOY = dict(n_spectra=6, seed=3, num_samples=120)
RATES = ("exact_multiplicity_acc", "detection_rate", "clean_false_positive_rate")


def json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.strip().splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def demos():
    """(the port's JSON lines, JAX's JSON lines, the workload JAX's
    driver received); the port's run in a subprocess meanwhile."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gp_dla_detection_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "ns = runpy.run_path('scripts/torch_scale_demo.py')\n"
        f"ns['main'](backend='torch', device='cpu', **{TOY!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gp_dla_detection_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
    )
    try:
        seen = {}
        real = jax_parallel.process_spectra_multi_sharded

        def spy(model, offsets, nhis, spectra, prior_z, prior_num, **kw):
            seen.update(model=model, offsets=offsets, nhis=nhis, spectra=spectra,
                        prior_z=prior_z, prior_num=prior_num, config=kw["config"])
            return real(model, offsets, nhis, spectra, prior_z, prior_num, **kw)

        jax_parallel.process_spectra_multi_sharded = spy
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                runpy.run_path(str(REPO / "scripts" / "scale_demo.py"))["main"](backend="xla", **TOY)
        finally:
            jax_parallel.process_spectra_multi_sharded = real
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-4000:]
    return json_lines(stdout), json_lines(out.getvalue()), seen


def test_lines_and_rates_equal_the_jax_script(demos):
    ours, ref, _ = demos
    assert [ln["stage"] for ln in ours] == [ln["stage"] for ln in ref] == [
        "prepare", "two_stage_model_selection"]
    last, ref_last = ours[-1], ref[-1]
    assert sorted(last) == sorted(ref_last)
    assert (last["n_spectra"], last["num_samples"], last["backend"]) == (6, 120, "torch")
    assert np.isfinite(last["seconds"]) and last["spectra_per_sec_end_to_end"] > 0
    for k in RATES:
        assert last[k] == ref_last[k], k


def test_same_workload_as_the_jax_script(demos):
    """The port's generator against what JAX's driver received: the same
    draws (bit-equal), and the same flux to 1e-4 of the unit continuum:
    the port computes the injected profiles in float32 through the fast
    Faddeeva path, as the JAX script does without x64, while this test
    process runs JAX with x64, which takes the accurate float64 profile
    (the fast path is within 1.3e-5 of it in Re w; the noise is 0.1)."""
    _, _, seen = demos
    w = runpy.run_path(str(REPO / "scripts" / "torch_scale_demo.py"))["synthetic_survey"](
        TOY["n_spectra"], TOY["seed"], TOY["num_samples"])
    spectra = seen["spectra"]
    np.testing.assert_array_equal(w["M"], seen["model"].M)
    np.testing.assert_array_equal(w["mu"], seen["model"].mu)
    np.testing.assert_array_equal(w["z_qso"], spectra.z_qso)
    np.testing.assert_array_equal(w["lam"], spectra.wavelengths)
    np.testing.assert_array_equal(w["noise_variance"], spectra.noise_variance)
    np.testing.assert_allclose(w["flux"], spectra.flux, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(w["samples"].offset_samples, seen["offsets"])
    np.testing.assert_array_equal(w["samples"].nhi_samples, seen["nhis"])
    np.testing.assert_array_equal(w["prior_z"], seen["prior_z"])
    np.testing.assert_array_equal(w["prior_num"], seen["prior_num"])
    assert (seen["config"].per_device_batch, seen["config"].sample_chunk) == (1, 120)
    assert w["injected"].sum() >= 2
