"""The PyTorch port imports without jax, and its copied constants equal
the JAX package's."""

import ast
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
PORT = REPO / "gp_dla_detection_tpu_torch"

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
    "gp_dla_detection_tpu_torch.ops.redraw",
    "gp_dla_detection_tpu_torch.models",
    "gp_dla_detection_tpu_torch.models.qso_model",
    "gp_dla_detection_tpu_torch.inference",
    "gp_dla_detection_tpu_torch.multi_dla",
    "gp_dla_detection_tpu_torch.parallel",
    "gp_dla_detection_tpu_torch.parallel.streaming",
    "gp_dla_detection_tpu_torch.parallel.overlap",
    "gp_dla_detection_tpu_torch.parallel.batches",
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
    "gp_dla_detection_tpu_torch.ops.lbfgs_device",
    "gp_dla_detection_tpu_torch.parallel.mesh",
    "gp_dla_detection_tpu_torch.utils.observability",
    "gp_dla_detection_tpu_torch.analysis.tables",
    "gp_dla_detection_tpu_torch.download",
    "gp_dla_detection_tpu_torch.models.training",
    "gp_dla_detection_tpu_torch.pipeline",
    "gp_dla_detection_tpu_torch.params",
    "gp_dla_detection_tpu_torch.samples",
    "gp_dla_detection_tpu_torch.io",
    "gp_dla_detection_tpu_torch.utils",
    "gp_dla_detection_tpu_torch.runtime",
    "gp_dla_detection_tpu_torch.catalog",
    "gp_dla_detection_tpu_torch.io.fits",
    "gp_dla_detection_tpu_torch.io.matio",
    "gp_dla_detection_tpu_torch.io.native",
    "gp_dla_detection_tpu_torch.utils.atomic_io",
    "gp_dla_detection_tpu_torch.utils.synthetic",
    "gp_dla_detection_tpu_torch.analysis.cddf",
    "gp_dla_detection_tpu_torch.analysis.cosmology",
    "gp_dla_detection_tpu_torch.analysis.pb",
    "gp_dla_detection_tpu_torch.analysis.plots",
    "gp_dla_detection_tpu_torch.bench",
]


def test_port_imports_without_jax():
    # jax and the JAX package made unimportable: any import chain that
    # reaches either fails; every module of the port is listed
    listed = {
        ".".join(("gp_dla_detection_tpu_torch", *p.relative_to(PORT).with_suffix("").parts))
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py")
        if "_build" not in p.parts
    }
    assert listed == set(PORT_MODULES), listed ^ set(PORT_MODULES)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gp_dla_detection_tpu'] = None\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton',"
        " 'gp_dla_detection_tpu') and sys.modules[m] is not None]\n"
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
    # the port's own copies: the same public names, defined in the port
    # (not re-exported from the JAX package), and the same source text
    import importlib
    import inspect

    port = importlib.import_module(f"gp_dla_detection_tpu_torch.{port_name}")
    ref = importlib.import_module(f"gp_dla_detection_tpu.{jax_name}")
    for name in names:
        ours, theirs = getattr(port, name), getattr(ref, name)
        assert ours is not theirs, name
        if inspect.isclass(ours) or inspect.isfunction(ours):
            assert ours.__module__.startswith("gp_dla_detection_tpu_torch."), name
        else:
            assert ours == theirs, name


def _imported_roots(tree) -> set[str]:
    """The top-level package of every absolute import in ``tree``,
    function-level imports included."""
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py") if "_build" not in p.parts)
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("torch_*.py"))
    + ["chip_smoke.py", "examples/quickstart_torch.py",
       ".claude/skills/verify/verify_drive_torch.py", "tests/torch_distributed_worker.py"],
)
def test_no_import_of_the_jax_package(path):
    # an AST scan: no import of jax or of the JAX package or any of its
    # submodules, anywhere in the file
    roots = _imported_roots(ast.parse((REPO / path).read_text()))
    assert not roots & {"jax", "jaxlib", "gp_dla_detection_tpu"}, (path, roots)


@pytest.mark.parametrize("path", ["inference.py", "multi_dla.py", "cddf_inputs.py"])
def test_the_batch_math_imports_nothing_of_the_drivers(path):
    # the per-batch math sits below parallel/ (the drivers): no import of
    # it, function-level imports included
    found = []
    for node in ast.walk(ast.parse((PORT / path).read_text())):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            names = [module] if module else [a.name for a in node.names]
            if node.level == 0:
                names = [m.removeprefix("gp_dla_detection_tpu_torch.") for m in names]
            found += [m for m in names if m.split(".")[0] == "parallel"]
        elif isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.startswith("gp_dla_detection_tpu_torch.parallel")]
    assert not found, (path, found)


def test_chip_smoke_imports_only_the_port():
    # chip_smoke.py drives the port (test_no_import_of_the_jax_package
    # scans it for the JAX package)
    roots = _imported_roots(ast.parse((REPO / "chip_smoke.py").read_text()))
    assert "gp_dla_detection_tpu_torch" in roots


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
