"""The full 31-line Lyman series on the port's normal path, on the CPU.

- The benchmark's cell ``multi31_b1024`` through ``gpbench.harness`` at a
  golden size: the port's float64 plain path (the fused lean chain, pair
  stage and CDDF inputs included) equals the benchmark's plain reference
  at 1e-9 at 31 lines, as ``gpbench/tests/test_gpbench_reference.py``
  holds the 3-line cells.  The reference's line tables widened to the
  whole series are the port's, bit for bit.
- The port's float32 plain version of the full-grid kernel at 31 lines,
  single and pair, against the JAX package's Pallas kernel in interpret
  mode, within the float32 gate (5e-5 normalized).
- ``compute_sample_window`` sends 31 lines to the full grid.
- The evidence stages' spans carry ``lines`` and ``window`` (0 for the
  full grid; the plain path takes no window).
- The cell ``multi_b128`` is the README's lean release at batch 128.

The size is cut where the CPU needs it (3 sightlines of 300 pixels, 160
QMC samples): every width of the model is the configuration's.
"""

import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gp_dla_detection_tpu.ops.evidence_pallas import pallas_sample_log_likelihoods  # noqa: E402
from gp_dla_detection_tpu_torch.inference import compute_sample_window, kernel_sample_window  # noqa: E402
from gp_dla_detection_tpu_torch.ops import evidence, lyman_series  # noqa: E402
from gp_dla_detection_tpu_torch.params import Parameters  # noqa: E402
from gp_dla_detection_tpu_torch.parallel import ShardedRunConfig  # noqa: E402
from gp_dla_detection_tpu_torch.utils import observability as obs  # noqa: E402
from gpbench import check, harness, program  # noqa: E402
from gpbench.reference import lyman_series as ref_lines  # noqa: E402
from gpbench.reference import physics  # noqa: E402

from test_torch_evidence import BOUND, _line_count_problem, normalized_err  # noqa: E402

torch.set_num_threads(1)

# the golden size: sightlines with absorbers (noise that leaves the few
# samples a broad posterior, a prior catalogue whose every quasar has
# two, as gpbench/tests/_tiny.py), 300 pixels of the forest's blue end
GOLDEN = dict(pool_size=3, samples=160, driver={"per_device_batch": 3, "pipeline_depth": 1},
              traffic={"dla_dndx": 3.0, "noise_sd": 1.0, "pixels": [240, 300]},
              config={"pixel_pad": 300, "prior_catalogue": {"dla_rate": 50.0}})
STAGE_IDS = {"gpdla.stage.single", "gpdla.stage.pair"}


def golden_call(cell: str, config=None):
    """The cell's entry on its whole golden pool, the float64 plain path,
    with the span recorder on: (run, outputs, spans)."""
    c = harness.sized_cell(harness.load_cell(cell), **{**GOLDEN, "config": {
        **GOLDEN["config"], **(config or {})}})
    r = harness.Run(c, 2147483777, 0.0, False, torch.device("cpu"), "torch", "float64")
    harness.make_inputs(r)
    r.params = program.parameters(c.cfg)
    r.gp_model = program.gp_model(r.model, r.device, torch.float64)
    with obs.recording() as rec:
        got = c.entry.call(r, np.arange(GOLDEN["pool_size"]), None)
    return r, got, rec.drain()


@pytest.fixture(scope="module")
def lines31():
    return golden_call("multi31_b1024")


@pytest.fixture(scope="module")
def lines3():
    return golden_call("multi_b1024")


def test_the_cell_runs_31_lines():
    c = harness.load_cell("multi31_b1024")
    lean = harness.load_cell("multi_b1024")
    assert c.cfg["num_lines"] == 31 and program.parameters(c.cfg).num_lines == 31
    differ = {k for k in lean.cfg if lean.cfg[k] != c.cfg[k]}
    assert differ == {"num_lines", "source", "deployment"}
    assert c.spec["driver"] == lean.spec["driver"] and c.entry.MULTI
    assert c.mix == lean.mix


def test_the_references_line_tables_are_the_ports():
    for name in ("TRANSITION_WAVELENGTHS", "OSCILLATOR_STRENGTHS", "TRANSITION_RATES",
                 "LEADING_CONSTANTS", "LORENTZIAN_WIDTHS"):
        np.testing.assert_array_equal(getattr(ref_lines, name), getattr(lyman_series, name))
        assert len(getattr(physics, name)) in (3, 31)
        np.testing.assert_array_equal(getattr(physics, name)[:3], getattr(ref_lines, name)[:3])
    assert ref_lines.NUM_LINES == lyman_series.NUM_LINES == evidence.MAX_LINES == 31
    ref_lines.install()
    assert len(physics.TRANSITION_WAVELENGTHS) == 31


def test_reference_matches_the_programs_float64_plain_path_at_31_lines(lines31, lines3):
    r, got, _ = lines31
    c = r.cell
    rows = np.arange(GOLDEN["pool_size"])
    assert (r.pool["n_dlas"][rows] > 0).all()
    ref = check.reference_for(c.cfg, r.model, r.samples, "cpu", plain_program=True)
    priors = check.priors_of(c.cfg, r.catalogue, r.pool["z_qso"][rows])
    want = check.reference_outputs(ref, r.pool, rows, priors, True, log_nhis=r.samples[2],
                                   spec=check.cddf_spec())
    for key in ("ll0", "ev1", "p_dla", "ev2"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-9, err_msg=key)
    for key in ("map1", "map2", "map_base"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["post"], want["post"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["hist"], want["hist"], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(got["ex"], want["ex"], rtol=1e-9, atol=1e-14)
    assert np.abs(got["hist"]).sum() > 0
    nums = check.compare(ref, got, want, True, spec=check.cddf_spec())
    assert all(v < 1e-6 for v in nums.values()), nums
    # the 28 lines past Lyγ are in the evidence: the 3-line chain reads otherwise
    _, got3, _ = lines3
    assert np.abs(got3["ev1"] - got["ev1"]).max() > 1e-6


@pytest.mark.parametrize("stage", ["single", "pair"])
def test_plain_full_grid_evidence_matches_pallas_interpret_at_31_lines(stage):
    arrays, sample_z, nhi = _line_count_problem()
    z = sample_z(1215.6701)
    second = ()
    if stage == "pair":
        rng = np.random.default_rng(5)
        z2 = sample_z(1215.6701)[:, rng.permutation(z.shape[1])]
        second = (z2, (nhi * 0.5).astype(np.float32))
    ref = pallas_sample_log_likelihoods(
        *[jnp.asarray(a) for a in (*arrays, z, nhi)], num_lines=31, interpret=True, tile=64,
        window=None, **(dict(z_dlas2=jnp.asarray(second[0]), nhi2=jnp.asarray(second[1]))
                        if second else {}),
    )
    t = [torch.as_tensor(a) for a in (*arrays, z, nhi, *second)]
    fn = evidence.sample_log_likelihoods_pair if second else evidence.sample_log_likelihoods
    ours = fn(*t, num_lines=31, window=None)
    assert ours.dtype == torch.float32
    assert normalized_err(ours.numpy(), ref) < BOUND


def test_the_sample_window_leaves_31_lines_on_the_full_grid():
    off = np.sort(np.random.default_rng(0).uniform(size=10_000))
    assert compute_sample_window(off, evidence.SAMPLE_TILE, 1280, num_lines=3) is not None
    assert compute_sample_window(off, evidence.SAMPLE_TILE, 1280, num_lines=31) is None
    params = Parameters(num_lines=31)
    assert kernel_sample_window(off, 1274, params) is None


def stage_ids(spans) -> dict:
    """The (lines, window) ids of each evidence stage's spans."""
    out = {}
    for s in spans:
        if s.name in STAGE_IDS:
            out.setdefault(s.name, set()).add((s.ids["lines"], s.ids["window"]))
    return out


def test_the_evidence_stages_spans_carry_their_lines_and_window(lines31, lines3):
    *_, spans = lines31
    assert stage_ids(spans) == {name: {(31, 0)} for name in STAGE_IDS}
    # the 3-line chain: the plain path takes no window
    *_, spans3 = lines3
    assert stage_ids(spans3) == {name: {(3, 0)} for name in STAGE_IDS}
    # the single-DLA driver's stage
    for lines in (3, 31):
        *_, spans1 = golden_call("single_b1024", {"num_lines": lines})
        assert stage_ids(spans1) == {"gpdla.stage.single": {(lines, 0)}}


def test_the_full_grid_counters_count_kernel_launches_only():
    counters = ("launch_count", "pair_launch_count", "full_grid_launch_count",
                "full_grid_pair_launch_count")
    assert set(counters) <= set(evidence.__all__)
    before = [getattr(evidence, c) for c in counters]
    golden_call("multi_b1024")
    assert [getattr(evidence, c) for c in counters] == before   # the plain path


def test_multi_b128_is_the_readmes_lean_release():
    c = harness.load_cell("multi_b128")
    bulk = harness.load_cell("multi_b1024")
    readme = (REPO / "README.md").read_text()
    batches = {int(b) for b in re.findall(
        r"--lean --multi-dla --cddf-inputs --per-device-batch (\d+)", readme)}
    assert batches == {128}
    assert c.spec["driver"] == {"per_device_batch": 128,
                                "pipeline_depth": ShardedRunConfig().pipeline_depth,
                                "store_cddf_inputs": True, "checkpoints": True, "lean": True}
    assert c.cfg == bulk.cfg and c.mix == bulk.mix and c.spec["check"] == bulk.spec["check"]
    assert c.spec["entry"] == bulk.spec["entry"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rate = next(m for m in bench["end_to_end"] if m["name"] == "spectra_per_s")
    assert {"multi_b1024", "multi31_b1024", "multi_b128"} <= set(rate["workloads"])
