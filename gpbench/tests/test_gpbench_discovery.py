"""A cell, a configuration, a traffic mix and a per-layer metric are
added to a copy of the benchmark by adding files and BENCHMARK.json
entries alone, and the harness finds and runs them by name; no file that
was there is edited."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.tests import _tiny

GPBENCH = Path(__file__).resolve().parents[1]
REPO = GPBENCH.parent

READER = '''"""Calls the window completed per second (host clock)."""

NAME, UNIT, BETTER, SOURCE = "calls_per_s", "calls/s", "higher", "program_counter"
LAYER = "drivers"


def read(run):
    return len(run.calls) / run.window_s if run.window_s > 0 else None
'''


def digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture()
def copy(tmp_path):
    shutil.copytree(GPBENCH, tmp_path / "gpbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_cell_config_mix_and_metric_added_by_files_alone(copy, monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    root = copy / "gpbench"
    before = digest(copy)
    cfg = json.loads((root / "configs" / "garnett17.json").read_text())
    cfg["source"] = "https://example.org/another-deployment"
    (root / "configs" / "other_deployment.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "survey_bulk.json").read_text())
    mix["pool"]["z_qso"] = [2.8, 3.4]
    mix["loop"]["call_size"] = 3
    (root / "traffic" / "high_z_calls3.json").write_text(json.dumps(mix))
    cell = json.loads((root / "workloads" / "single_b1024.json").read_text())
    cell.update(config="other_deployment", traffic="high_z_calls3", why="a test cell")
    (root / "workloads" / "high_z_single.json").write_text(json.dumps(cell))
    (root / "metrics" / "calls_per_s.py").write_text(READER)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "other_deployment", "source": cfg["source"],
                             "file": "gpbench/configs/other_deployment.json",
                             "reduced": cfg["reduced"], "why": "a test configuration"})
    bench["workloads"].append({"name": "high_z_single", "config": "other_deployment",
                               "traffic": "high_z_calls3", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "spectra_per_s":
            m["workloads"].append("high_z_single")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "program_counter", "layer": "drivers",
                               "moves": "spectra_per_s", "workloads": ["high_z_single"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digest(copy)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}          # entries added there, no file edited
    assert set(after) - set(before) == {
        "gpbench/configs/other_deployment.json", "gpbench/traffic/high_z_calls3.json",
        "gpbench/workloads/high_z_single.json", "gpbench/metrics/calls_per_s.py"}

    c = harness.load_cell("high_z_single", root)
    assert c.cfg["source"] == cfg["source"] and c.mix["loop"]["call_size"] == 3
    assert [m["name"] for m in harness.metric_plan(bench, "high_z_single", "per_layer")] == [
        "calls_per_s"]
    result, _ = _tiny.run("high_z_single", root=root, bench=bench)
    assert set(result["metrics"]) == {"spectra_per_s", "setup_s"}
    assert min(result["run"]["spectra"], 3) == 3
    z = result["run"]
    assert z["calls"] >= 1
    # the new per-layer metric is read in a run of the new cell
    reader = harness.load_module(root / "metrics" / "calls_per_s.py")
    assert reader.NAME == "calls_per_s"
