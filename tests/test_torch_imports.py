"""The PyTorch port imports without jax, and its copied constants equal
the JAX package's."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.ops import faddeeva as jax_faddeeva
from gp_dla_detection_tpu.ops import lyman_series as jax_lines
from gp_dla_detection_tpu_torch.ops import faddeeva as port_faddeeva
from gp_dla_detection_tpu_torch.ops import lyman_series as port_lines

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "gp_dla_detection_tpu_torch",
    "gp_dla_detection_tpu_torch._build",
    "gp_dla_detection_tpu_torch.ops",
    "gp_dla_detection_tpu_torch.ops.lyman_series",
    "gp_dla_detection_tpu_torch.ops.faddeeva",
    "gp_dla_detection_tpu_torch.ops.interp",
    "gp_dla_detection_tpu_torch.ops.low_rank_mvn",
    "gp_dla_detection_tpu_torch.ops.voigt",
    "gp_dla_detection_tpu_torch.ops.evidence",
    "gp_dla_detection_tpu_torch.models",
    "gp_dla_detection_tpu_torch.models.qso_model",
    "gp_dla_detection_tpu_torch.inference",
    "gp_dla_detection_tpu_torch.multi_dla",
    "gp_dla_detection_tpu_torch.parallel",
    "gp_dla_detection_tpu_torch.parallel.streaming",
    "gp_dla_detection_tpu_torch.parallel.sharded_inference",
    "gp_dla_detection_tpu_torch.parallel.sharded_multi",
    "gp_dla_detection_tpu_torch.cddf_inputs",
    "gp_dla_detection_tpu_torch.analysis",
    "gp_dla_detection_tpu_torch.analysis.lean_catalogue",
    "gp_dla_detection_tpu_torch.alias_flag",
    "gp_dla_detection_tpu_torch.ascii_catalog",
    "gp_dla_detection_tpu_torch.spectra",
    "gp_dla_detection_tpu_torch.ops.pca",
    "gp_dla_detection_tpu_torch.ops.lbfgs",
    "gp_dla_detection_tpu_torch.models.training",
    "gp_dla_detection_tpu_torch.pipeline",
    "gp_dla_detection_tpu_torch.params",
    "gp_dla_detection_tpu_torch.samples",
    "gp_dla_detection_tpu_torch.io",
    "gp_dla_detection_tpu_torch.utils",
]


def test_port_imports_without_jax():
    # jax made unimportable: any import chain that reaches it fails
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib', 'triton'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "port_name, jax_name, names",
    [
        ("params", "params", ["Parameters", "OptimizationParams", "LYA_WAVELENGTH", "LYMAN_LIMIT"]),
        ("samples", "samples", ["DLASamples", "generate_dla_samples"]),
        ("io", "io.fits", ["read_bintable", "write_bintable"]),
        ("utils", "utils.synthetic", ["synthetic_workload"]),
    ],
)
def test_shared_host_modules_are_the_jax_ones(port_name, jax_name, names):
    import importlib

    port = importlib.import_module(f"gp_dla_detection_tpu_torch.{port_name}")
    ref = importlib.import_module(f"gp_dla_detection_tpu.{jax_name}")
    assert set(names) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is getattr(ref, name), name


def test_chip_smoke_imports_only_the_port():
    # chip_smoke.py reaches the JAX package's jax-free modules only
    # through the port's re-exports
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "gp_dla_detection_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "gp_dla_detection_tpu"}, roots


@pytest.mark.parametrize(
    "name",
    [
        "TRANSITION_WAVELENGTHS",
        "OSCILLATOR_STRENGTHS",
        "TRANSITION_RATES",
        "LEADING_CONSTANTS",
        "LORENTZIAN_WIDTHS",
        "DOPPLER_SIGMA",
        "C_CGS",
        "NUM_LINES",
    ],
)
def test_lyman_constants_equal(name):
    np.testing.assert_array_equal(getattr(port_lines, name), getattr(jax_lines, name))


def test_g_coefficients_bit_equal():
    port = port_faddeeva._g_global_coeffs()
    ref = jax_faddeeva._g_global_coeffs()
    assert len(port) == 13
    assert port == ref  # tuples of Python floats: bitwise equality
    assert port_faddeeva._weideman_constants(64) == jax_faddeeva._weideman_constants(64)
