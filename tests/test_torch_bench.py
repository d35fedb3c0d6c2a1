"""The port's flagship benchmark (``gp_dla_detection_tpu_torch.bench``)
against the JAX script (``bench.py``) at the JAX entry-point tests' toy
sizes (B = 4, S = 64, P = 250, k = 4), on the CPU through the plain path:
the kernel mode's device function against JAX's
``batch_log_likelihoods(backend="xla")`` on the same numpy arrays, both
modes' JSON lines, the driver mode's timed call against a direct call of
the same driver, the CLI's flags and refusals."""

import ast
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gp_dla_detection_tpu import inference as jinf
from gp_dla_detection_tpu_torch import bench
from gp_dla_detection_tpu_torch.parallel import (
    ShardedRunConfig,
    process_spectra_multi_sharded,
    process_spectra_sharded,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOY = dict(batch_size=4, num_samples=64, pixels=250, k=4)
SAMPLE_CHUNK = 32
NORMALIZED_BOUND = 5e-5   # float32 port vs float32 JAX: max |a-b| / max(|b|, 1)
BASELINE = 162861 / 3600  # DR12Q in one hour on one card


def normalized(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.strip().splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def problem():
    return bench._synthetic_problem(TOY["batch_size"], TOY["num_samples"], TOY["pixels"], TOY["k"])


def test_kernel_step_matches_jax(problem):
    # tolerance: 5e-5 normalized (float32 on both sides)
    from gp_dla_detection_tpu.utils.synthetic import synthetic_workload

    out = bench.kernel_step(bench.kernel_args(problem, "cpu"), problem["params"],
                            sample_chunk=SAMPLE_CHUNK, backend="torch", sample_window=None)
    # the JAX script's workload is the same arrays; its Parameters are JAX's
    jprob = synthetic_workload(*TOY.values())
    for key, v in problem.items():
        if key != "params":
            np.testing.assert_array_equal(jprob[key], v, err_msg=key)
    j = lambda k: jnp.asarray(problem[k])
    ref = jinf.batch_log_likelihoods(
        j("wavelengths"), j("flux"), j("noise_variance"), j("mask"), j("z_qso"), j("grid"),
        j("mu"), j("M"), j("log_omega"), problem["log_c_0"], problem["log_tau_0"],
        problem["log_beta"], j("offsets"), j("nhis"), params=jprob["params"],
        sample_chunk=SAMPLE_CHUNK, backend="xla",
    )
    sll = out["sample_log_likelihoods_dla"]
    assert sll.dtype == torch.float32 and sll.shape == (4, 64)
    assert normalized(sll, ref["sample_log_likelihoods_dla"]) < NORMALIZED_BOUND
    assert normalized(out["log_likelihood_no_dla"], ref["log_likelihood_no_dla"]) < NORMALIZED_BOUND
    # the fetched vector: the null half, then the sum of the matrix's rows
    reduced = out["reduced"]
    assert reduced.shape == (8,)
    assert torch.equal(reduced[:4], out["log_likelihood_no_dla"])
    assert torch.equal(reduced[4:], torch.sum(sll, dim=-1))
    np.testing.assert_allclose(reduced[4:].numpy(), sll.double().sum(-1).numpy(), rtol=1e-6)


class HostReads(TorchDispatchMode):
    """Operations that on the card would wait for it or copy host data
    over and wait: ``item()``/``bool()``, a tensor made from host data,
    ``nonzero``, ``masked_select``, boolean indexing; off inside the
    plain evidence (the kernel's stand-in on the CPU)."""

    def __init__(self):
        super().__init__()
        self.seen, self.plain = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        reads = name in {"aten._local_scalar_dense.default", "aten.lift_fresh.default",
                         "aten.nonzero.default", "aten.masked_select.default"} or (
            name == "aten.index.Tensor"
            and any(i is not None and i.dtype == torch.bool for i in args[1]))
        if reads and not self.plain:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_kernel_step_reads_nothing_back(problem, monkeypatch):
    """The timed window's calls must not wait for the card one by one:
    the device function (prep, the windowed path's sort and un-sort, the
    reduction) reads no tensor's value and makes no tensor from host data."""
    from gp_dla_detection_tpu_torch.ops import evidence

    reads = HostReads()
    real = evidence.sample_log_likelihoods_reference

    def plain(*a, **kw):
        reads.plain += 1
        try:
            return real(*a, **kw)
        finally:
            reads.plain -= 1

    monkeypatch.setattr(evidence, "sample_log_likelihoods_reference", plain)
    params = problem["params"]
    # the windowed path (chunks of 4 samples: a window narrower than the
    # toy grid) sorts the samples and un-sorts the columns
    window = jinf.compute_sample_window(
        problem["offsets"], 4, TOY["pixels"] + 2 * params.instrument.width
    )
    assert window is not None
    args = bench.kernel_args(problem, "cpu")
    with reads:
        out = bench.kernel_step(args, params, sample_chunk=4, backend="torch",
                                sample_window=window)
    assert reads.seen == []
    assert torch.isfinite(out["reduced"]).all()


def test_main_prints_its_record(capsys):
    rec = bench.main(**TOY, sample_chunk=SAMPLE_CHUNK, iters=1, backend="torch", device="cpu")
    lines = json_lines(capsys.readouterr().out)
    assert lines == [rec]
    assert rec["unit"] == "spectra/s"
    assert "DLA evidence" in rec["metric"] and "64 QMC samples" in rec["metric"]
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / BASELINE, 2)
    assert rec["backend"] == "torch" and rec["launches"] == {"single": 0}


def result_arrays(res) -> dict:
    """Every numpy array of a driver result (and of its single stage)."""
    out = {k: v for k, v in vars(res).items() if isinstance(v, np.ndarray)}
    single = getattr(res, "single", None)
    if single is not None:
        out.update({"single_" + k: v for k, v in vars(single).items()
                    if isinstance(v, np.ndarray)})
    return out


@pytest.mark.parametrize(
    "lean, two_stage, words",
    [
        (False, False, "float32 results"),
        (True, False, "lean device-reduced results"),
        (True, True, "fused two-stage {0,1,2} catalog, lean device-reduced results"),
    ],
)
def test_main_driver_modes(lean, two_stage, words, capsys, monkeypatch):
    """One JSON line per mode; the timed full run's results bit-identical
    to a direct call of the same driver on the same spectra, and its
    checkpoints written."""
    calls = []
    real = bench.run_driver

    def spy(work, sl, ckpt_dir, **kw):
        res = real(work, sl, ckpt_dir, **kw)
        ckpt = None if ckpt_dir is None else Path(ckpt_dir)
        calls.append(dict(work=work, sl=sl, kw=kw, res=res, files=(
            None if ckpt is None else
            (len(list(ckpt.rglob("batch_*.npz"))), len(list(ckpt.rglob("manifest.json")))))))
        return res

    monkeypatch.setattr(bench, "run_driver", spy)
    rec = bench.main_driver(
        n_spectra=12, per_device_batch=4, num_samples=64, pixels=250, k=4,
        backend="torch", lean=lean, two_stage=two_stage, device="cpu",
    )
    assert json_lines(capsys.readouterr().out) == [rec]
    assert rec["unit"] == "spectra/s"
    assert "sustained end-to-end driver" in rec["metric"] and words in rec["metric"]
    assert "checkpointing" in rec["metric"]
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / BASELINE, 2)
    assert rec["mesh_chips"] == 1

    # warm-up (no checkpoints), the one-batch run, the full run
    assert [c["sl"] for c in calls] == [slice(0, 4), slice(0, 4), slice(0, 12)]
    assert [c["files"] for c in calls] == [None, (1, 1), (3, 1)]
    full = calls[-1]
    work = full["work"]
    cfg = ShardedRunConfig(per_device_batch=4, backend="torch", device="cpu",
                           store_sample_likelihoods=not lean)
    spectra = work.spectra.slice(slice(0, 12))
    if two_stage:
        direct = process_spectra_multi_sharded(
            work.model, work.offsets, work.nhis, spectra, work.prior_z, work.prior_num,
            config=cfg,
        )
    else:
        direct = process_spectra_sharded(
            work.model, work.offsets, work.nhis, spectra, work.prior_z, work.prior_flags,
            config=cfg,
        )
    got, want = result_arrays(full["res"]), result_arrays(direct)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    # the full mode stores the (N, S) matrix, the lean modes do not
    assert ("sample_log_likelihoods_dla" in want) == (not lean)


def test_cli_flags_are_the_jax_scripts():
    """--help lists every flag of the JAX script (none of them is among
    the pieces left out), plus --device."""
    def flags(tree):
        return {
            node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
        }

    jax_flags = flags(ast.parse((REPO / "bench.py").read_text()))
    port_flags = flags(ast.parse((REPO / "gp_dla_detection_tpu_torch" / "bench.py").read_text()))
    assert len(jax_flags) == 15
    assert port_flags == jax_flags | {"--device"}


def test_cli_two_stage_requires_lean(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.cli(["--two-stage", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--two-stage requires --lean" in capsys.readouterr().err


@pytest.mark.parametrize("pixels, num_lines", [(1274, 3), (250, 3), (1274, 31)])
def test_kernel_sample_window_is_the_jax_drivers(pixels, num_lines):
    """The kernel mode's window (``inference.kernel_sample_window``, the
    one every kernel caller of the port uses) is the window the JAX
    drivers give their kernel on the bench's samples: the kernel's tile
    over the extended grid at the parameters' lines and pixel spacing
    (exact: both are integers or None)."""
    import dataclasses

    from gp_dla_detection_tpu.ops.evidence_pallas import SAMPLE_TILE as JAX_TILE
    from gp_dla_detection_tpu.params import Parameters as JaxParameters
    from gp_dla_detection_tpu_torch.inference import kernel_sample_window

    offsets = bench._synthetic_problem(2, 10000, 8, 2)["offsets"]
    params = dataclasses.replace(bench._synthetic_problem(2, 8, 8, 2)["params"],
                                 num_lines=num_lines)
    jparams = JaxParameters(num_lines=num_lines)
    want = jinf.compute_sample_window(
        offsets, JAX_TILE, pixels + 2 * jparams.instrument.width, num_lines=num_lines,
        pixel_spacing=jparams.instrument.pixel_spacing,
    )
    assert kernel_sample_window(offsets, pixels, params) == want
    assert (want is None) == (num_lines == 31)


def test_cli_default_invocation_runs_both_lines(monkeypatch):
    """No --driver: the kernel line, then the fused lean two-stage chain
    at 16,384 spectra with checkpoints, at the same batch; --kernel-only
    drops the second."""
    seen = []
    monkeypatch.setattr(bench, "main", lambda *a, **kw: seen.append(("main", a, kw)))
    monkeypatch.setattr(bench, "main_driver", lambda *a, **kw: seen.append(("driver", a, kw)))
    bench.cli([])
    assert [s[0] for s in seen] == ["main", "driver"]
    assert seen[0][1] == (1024, 10000, 1274, 20, 2500, 5, None, None)
    assert seen[1][1] == (16384, 1024, 10000, 1274, 20, None, True, 4)
    assert seen[1][2] == dict(lean=True, two_stage=True, device=None)
    seen.clear()
    bench.cli(["--kernel-only"])
    assert [s[0] for s in seen] == ["main"]
    seen.clear()
    bench.cli(["--driver"])
    assert [s[0] for s in seen] == ["driver"]
    assert seen[0][1][:2] == (8192, 1024) and seen[0][1][6] is True


def test_no_card_no_device_raises(monkeypatch):
    """With no device named and no card, neither mode runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(**TOY, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main_driver(n_spectra=12, per_device_batch=4, num_samples=64, pixels=250, k=4)
