"""The single driver's full mode reduces each batch on its device.

``process_spectra_sharded`` with ``store_sample_likelihoods=True``
reduces each batch's rows to their evidence with the lean mode's
``streaming.row_evidence``, in the kernel's column layout, and puts the
rows back in original sample order on the device before the fetch:

- the full mode's evidences and p(DLA) equal the lean mode's bit for
  bit, float32 and float64, at depths 1 and 4 and batches 4 and 8;
- the rows it returns are the host reorder (``in_sample_order``) of the
  rows the evaluation returned, bit for bit, with the kernel's z-sorted
  layout and without one;
- ``streaming.evidence_reduce_count`` rises by the batches evaluated;
- a call stopped after 2 of 3 checkpointed batches resumes to the
  uninterrupted call's bits; a checkpoint without the evidence, or one
  written under the previous port token, is evaluated again.

The kernel's layout is emulated on the CPU: the driver runs as under
``"cuda"`` with a sample window, so it z-sorts the samples, and the
plain path stands in for the kernel (tests/test_torch_cuda.py holds the
same on the card).  The sample axis: tests/test_torch_parallel.py.
"""

import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from gp_dla_detection_tpu_torch.parallel import batches, sharded_inference, streaming
from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
    ShardedRunConfig,
    in_sample_order,
    process_spectra_sharded,
)

WINDOW = 128   # any window: the plain path stands in for the kernel
FLATTEN = 64   # the rows span ~200 nats: ~3 after the scaling
N = 11         # the problem's spectra


@pytest.fixture(scope="module")
def problem():
    return worker.port_problem()


@pytest.fixture(params=["kernel", "plain"])
def evaluation(request, monkeypatch, problem):
    """The driver's evaluation, recorded: (the column order of the rows
    it returns, None for the original order; the rows of each batch as it
    returned them).  Under "kernel" the driver runs as under ``"cuda"``
    with a sample window (the samples z-sorted once a call) and the plain
    path evaluates in the kernel's place.  The rows are scaled down, so
    that every sample carries weight in the evidence and the order of its
    sums shows in the bits."""
    real = sharded_inference.batch_log_likelihoods
    kernel = request.param == "kernel"
    rows = []

    def evaluate(*args, backend, sample_window, samples_sorted, **kw):
        if kernel:
            assert (backend, sample_window, samples_sorted) == ("cuda", WINDOW, True)
            backend, sample_window = "torch", None
        out = real(*args, backend=backend, sample_window=sample_window,
                   samples_sorted=samples_sorted, **kw)
        out["sample_log_likelihoods_dla"] = out["sample_log_likelihoods_dla"] / FLATTEN
        rows.append(out["sample_log_likelihoods_dla"].clone())
        return out

    if kernel:
        monkeypatch.setattr(sharded_inference, "resolve_run",
                            lambda device, dtype, backend: (torch.device("cpu"), dtype, "cuda"))
        monkeypatch.setattr(sharded_inference, "kernel_sample_window", lambda *a: WINDOW)
    monkeypatch.setattr(sharded_inference, "batch_log_likelihoods", evaluate)
    return (np.argsort(problem[3], kind="stable") if kernel else None), rows


def run(problem, *, lean=False, dtype="float64", batch=4, depth=1, checkpoint_dir=None):
    """The driver on the problem: (results, evidence reductions made)."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    config = ShardedRunConfig(
        per_device_batch=batch, sample_chunk=32, dtype=dtype, device="cpu", backend="torch",
        pipeline_depth=depth, store_sample_likelihoods=not lean, checkpoint_dir=checkpoint_dir,
    )
    before = streaming.evidence_reduce_count
    res = process_spectra_sharded(model, offsets, nhis, spectra, prior_z, prior_f,
                                  params=params, config=config)
    return res, streaming.evidence_reduce_count - before


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_full_mode_evidence_is_lean_modes_bit_for_bit(problem, evaluation, dtype, depth, batch):
    full, n_full = run(problem, dtype=dtype, batch=batch, depth=depth)
    lean, n_lean = run(problem, lean=True, dtype=dtype, batch=batch, depth=depth)
    assert n_full == n_lean == -(-N // batch)
    assert np.isfinite(full.log_likelihoods_dla).all()
    for k in ("log_likelihoods_dla", "p_dlas", "model_posteriors", "log_likelihoods_no_dla"):
        np.testing.assert_array_equal(getattr(full, k), getattr(lean, k), err_msg=k)
    assert full.sample_log_likelihoods_dla.dtype == np.dtype(dtype)
    assert lean.sample_log_likelihoods_dla is None and full.map_sample_inds is None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_full_mode_rows_are_the_host_reorder_of_the_evaluated_rows(problem, evaluation, dtype):
    """The rows the driver returns are what the host's reorder of each
    batch gave before the reorder moved to the device; their evidence is
    ``row_evidence`` of the evaluated rows, and within float32 rounding
    of the host's max + log(mean(exp(ll - max))) in the original order."""
    order, evaluated = evaluation
    res, n = run(problem, dtype=dtype, batch=4)
    assert n == len(evaluated) == 3
    host = np.concatenate([in_sample_order(r.numpy(), order) for r in evaluated])[:N]
    np.testing.assert_array_equal(res.sample_log_likelihoods_dla, host)
    ev = torch.cat([streaming.row_evidence(r) for r in evaluated])[:N].numpy()
    np.testing.assert_array_equal(res.log_likelihoods_dla, ev)
    peak = host.max(axis=1)
    numpy_ev = peak + np.log(np.mean(np.exp(host - peak[:, None]), axis=1))
    eps = np.finfo(np.dtype(dtype)).eps
    np.testing.assert_allclose(res.log_likelihoods_dla, numpy_ev, rtol=64 * eps)


def stop_after(real, batch: int, ckpt_dir: Path):
    """``run_pipelined_split`` whose ``complete`` raises at ``batch``,
    once the manifest lists every batch before it."""

    def split(items, upload, issue, complete, **kw):
        def complete_or_fail(item, state):
            if item[0] == batch:
                manifest = ckpt_dir / "manifest.json"
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline and not (
                        manifest.exists()
                        and json.loads(manifest.read_text())["completed_batches"]
                        == list(range(batch))):
                    time.sleep(0.01)
                raise RuntimeError(f"stopped at batch {batch}")
            complete(item, state)

        real(items, upload, issue, complete_or_fail, **kw)

    return split


def test_full_mode_resumes_its_checkpoints_and_refuses_stale_ones(problem, evaluation, tmp_path,
                                                                  monkeypatch):
    """Stopped after 2 of 3 checkpointed batches, the call resumes to the
    uninterrupted call's bits, evaluating and reducing the third alone; a
    batch file without ``log_likelihood_dla`` is evaluated again, and a
    directory written under numerics v3 is ignored with a warning."""
    evaluated = evaluation[1]
    fields = lambda r: {k: getattr(r, k) for k in (
        "log_likelihoods_dla", "sample_log_likelihoods_dla", "p_dlas", "log_likelihoods_no_dla")}

    def resumed(expect_evaluated):
        evaluated.clear()
        res, n = run(problem, checkpoint_dir=str(tmp_path), dtype="float32")
        assert n == len(evaluated) == expect_evaluated
        for k, v in fields(res).items():
            np.testing.assert_array_equal(v, whole[k], err_msg=k)

    whole = fields(run(problem, dtype="float32")[0])
    with monkeypatch.context() as m:
        m.setattr(batches, "run_pipelined_split",
                  stop_after(batches.run_pipelined_split, 2, tmp_path))
        with pytest.raises(RuntimeError, match="stopped at batch 2"):
            run(problem, checkpoint_dir=str(tmp_path), dtype="float32")
    assert json.loads((tmp_path / "manifest.json").read_text())["completed_batches"] == [0, 1]
    with np.load(tmp_path / "batch_000000.npz") as f:
        assert "log_likelihood_dla" in f.files
    resumed(1)
    # a batch file without the evidence is evaluated again
    path = tmp_path / "batch_000001.npz"
    with np.load(path) as f:
        kept = {k: f[k] for k in f.files if k != "log_likelihood_dla"}
    np.savez(path, **kept)
    resumed(1)
    # checkpoints written under the previous port token are not trusted
    for f in tmp_path.iterdir():
        f.unlink()
    with monkeypatch.context() as m:
        m.setattr(sharded_inference, "PORT_TOKEN", "gp_dla_detection_tpu_torch|numerics:v3")
        run(problem, checkpoint_dir=str(tmp_path), dtype="float32")
    with pytest.warns(UserWarning, match="ignoring incompatible inference checkpoints"):
        resumed(3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resumed(0)
