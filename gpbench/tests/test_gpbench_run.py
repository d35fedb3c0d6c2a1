"""``run.py`` on a whole run at a size the CPU holds (the look for a chip
skipped): a sound run prints its result line and exits 0; a run in which
a metric reader loads JAX exits non-zero and prints no result, because
the look at ``sys.modules`` comes after the comparison and the readers."""

import functools
import json
import sys

import pytest

from gpbench import harness
from gpbench.tests import _tiny

ARGS = ["--workload", "multi_calls128", "--seed", "2147483999", "--seconds", "0.01",
        "--trace", "0"]

PROBE = '''"""setup_s, read by a reader that loads JAX."""

import jax  # noqa: F401

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"


def read(run):
    return run.setup_s
'''


@pytest.fixture()
def main(monkeypatch, tmp_path):
    # run.py points the kernel caches into the checkout: undone after
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    from gpbench import run

    # JAX as a stub package that only this test can load
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(harness, "run", functools.partial(
        harness.run, log=lambda *a, **k: None, **_tiny.TINY))
    return run.main


def last_line(out: str):
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None


def test_a_sound_run_prints_its_result(main, capsys):
    assert main(ARGS) == 0
    result = last_line(capsys.readouterr().out)
    assert result["correct"] and "checks" in result


def test_a_reader_that_loads_jax_fails_the_run(main, capsys, monkeypatch, tmp_path):
    probe = tmp_path / "setup_s.py"
    probe.write_text(PROBE)
    real = harness.reader_path
    monkeypatch.setattr(harness, "reader_path",
                        lambda name, root=harness.ROOT: probe if name == "setup_s" else real(name, root))
    assert main(ARGS) != 0
    captured = capsys.readouterr()
    assert last_line(captured.out) is None
    assert "jax" in captured.err
