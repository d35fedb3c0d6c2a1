"""Shared by the tests of the port's survey harnesses
(``scripts/torch_scale_rehearsal.py``, ``torch_survey_run.py``,
``torch_survey_release.py``) and of the JAX harnesses they port
(``validation/``)."""

from __future__ import annotations

import ast
import contextlib
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np

import gp_dla_detection_tpu.pipeline as jax_pipeline

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
VALIDATION = REPO / "validation"
N_SPECTRA, SEED = 12, 40
TOY_BATCH = 1             # 12 batches: room for the kill points and the 4 batches
                          # the pipelined loop holds in flight before it checkpoints
TOY_SAMPLES = 600         # ~1 s a batch on one CPU thread, so that a kill lands mid-stage
PARITY_SAMPLES = 200      # the float64 parity runs
TOY_SEED = 6              # the orchestrated universe: 7 of 12 sightlines host a DLA, 2 of
                          # them two (the survey run's pair stage needs a double)

# every Python process started with this on its path (the orchestrator
# and the workers it starts) finds jax and the JAX package unimportable
_BLOCK = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['gp_dla_detection_tpu'] = None\n"
)


def port_script(name: str) -> dict:
    """The globals of ``scripts/<name>.py``."""
    return runpy.run_path(str(SCRIPTS / f"{name}.py"))


def jax_harness(name: str) -> dict:
    """The globals of ``validation/<name>.py`` (unchanged)."""
    return runpy.run_path(str(VALIDATION / f"{name}.py"))


def start_without_jax(argv: list[str], block_dir: Path) -> subprocess.Popen:
    """``python <argv>`` from the repo root, on the CPU with one thread,
    in processes where jax and the JAX package cannot be imported."""
    block_dir.mkdir(parents=True, exist_ok=True)
    (block_dir / "sitecustomize.py").write_text(_BLOCK)
    path = os.pathsep.join(filter(None, [str(block_dir), os.environ.get("PYTHONPATH")]))
    return subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
    )


def finish(proc: subprocess.Popen, timeout: float = 300) -> str:
    """The process's stdout once it exits 0 (killed on a timeout)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (out[-3000:], err[-4000:])
    return out


def marked_json(text: str, marker: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith(marker + " {")]
    assert len(lines) == 1, (marker, text[-2000:])
    return json.loads(lines[0][len(marker) + 1:])


@contextlib.contextmanager
def jax_on_the_plain_path():
    """The JAX harnesses' ``PipelineConfig(backend="pallas",
    dtype="float32")`` as ``backend="xla"`` in float64: the Pallas kernel
    through its plain reference, at the parity dtype."""
    real = jax_pipeline.PipelineConfig

    def config(**kw):
        return real(**{**kw, "backend": "xla", "dtype": "float64", "compilation_cache": False})

    jax_pipeline.PipelineConfig = config
    try:
        yield
    finally:
        jax_pipeline.PipelineConfig = real


def assert_npz_close(a_path, b_path, rtol=1e-9):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files), (a.files, b.files)
        for k in a.files:
            x, y = a[k], b[k]
            assert x.shape == y.shape, k
            if x.dtype.kind in "biuU":
                np.testing.assert_array_equal(x, y, err_msg=k)
            else:
                np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-300, err_msg=k)


def assert_npz_equal(a_path, b_path):
    """Bit for bit, NaN-aware (the harnesses' own comparison)."""
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k, strict=True)


def report_labels(path: Path, function: str) -> set[str]:
    """The labels of the report lines that ``function`` in the script at
    ``path`` writes: each string that starts with "- " and holds a
    "label: value" pair in its literal text."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    labels = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.JoinedStr):
            head = node.values[0] if node.values else None
            text = head.value if isinstance(head, ast.Constant) else ""
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        else:
            continue
        if text.startswith("- ") and ":" in text:
            labels.add(text[2:].split(":")[0])
    return labels


def printed_labels(text: str) -> set[str]:
    return {ln[2:].split(":")[0] for ln in text.splitlines() if ln.startswith("- ") and ":" in ln}
