"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the program, and
BENCHMARK.json keeps to the contract's shape."""

import ast
import json
import re
from pathlib import Path

GPBENCH = Path(__file__).resolve().parents[1]
REPO = GPBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gp_dla_detection_tpu"}
PROGRAM = "gp_dla_detection_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(GPBENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = top_level_imports(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((GPBENCH / "reference").rglob("*.py")):
        assert PROGRAM not in top_level_imports(f), f
    # the harness takes the program through one module only (tests may
    # import both)
    users = {f.relative_to(GPBENCH).as_posix() for f in GPBENCH.rglob("*.py")
             if PROGRAM in top_level_imports(f) and "tests" not in f.parts}
    assert users == {"program.py"}, users


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys

    from gpbench import harness

    monkeypatch.setitem(sys.modules, "gp_dla_detection_tpu_torch_fake", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "gp_dla_detection_tpu", raising=False)
    before = set(harness.forbidden_modules())
    assert "gp_dla_detection_tpu" not in before
    monkeypatch.setitem(sys.modules, "gp_dla_detection_tpu.params", sys)
    assert "gp_dla_detection_tpu" in harness.forbidden_modules()


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpbench"] and 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("gpbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = json.loads((GPBENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert (GPBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (GPBENCH / "entries" / f"{spec['entry']}.py").is_file()
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    from gpbench import harness

    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and harness.reader_path(m["name"]).is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:   # every cell: setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])


def test_the_metric_readers_declare_what_benchmark_json_says():
    from gpbench import harness

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = harness.load_module(harness.reader_path(m["name"]))
        assert (reader.NAME, reader.UNIT, reader.BETTER, reader.SOURCE) == (
            m["name"].split(".")[0], m["unit"], m["better"], m["source"])
        if "layer" in m:
            assert reader.LAYER == m["layer"]


def test_one_reader_per_quantity():
    # a metric split by the end-to-end metric it moves shares its
    # quantity's reader: no file reads what another file reads
    from gpbench import harness

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    used = {harness.reader_path(m["name"]).name for m in bench["end_to_end"] + bench["per_layer"]}
    files = {f.name for f in (GPBENCH / "metrics").glob("*.py") if not f.name.startswith("_")}
    assert used == files
    assert all(f.count(".") == 1 for f in files)
