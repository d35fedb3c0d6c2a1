"""The port's drivers on a mesh of two gloo ranks on the CPU.

tests/torch_distributed_worker.py runs as two OS processes, one rank
each (one spawn per mode for the module), float64 on the plain path, on
tests/synthetic_problem.py's inputs:

- ``process_spectra_sharded`` on a 2-rank data mesh: bit-equal to the
  port's one-process run at the same per-rank batch, full and lean; on a
  data 1 x sample 2 mesh: within the JAX package's 1e-12 / 1e-10 / 1e-9
  (tests/test_parallel.py); both against JAX's
  ``process_spectra_sharded`` on the 8-device CPU mesh at 1e-9;
- the fused lean chain with CDDF inputs on 2 ranks: bit-equal to the
  one-process run, and JAX's fused driver at 1e-9 with MAP indices equal;
  the classic flow likewise; on a data 1 x sample 2 mesh the chain
  (R = 1 and R = 4) bit-equal to the one-process run, JAX's sample-mesh
  run at 1e-9 with indices equal, and resuming the data mesh's
  checkpoints; under "cuda" the chain refuses a sample axis;
- every rank holds the same catalogue, only rank 0 wrote checkpoints and
  manifests, and a one-rank mesh resumes every batch of them;
- ``learn_gp_model`` on 2 ranks (host and device L-BFGS) against the
  one-process run and JAX's ``mesh=make_mesh()`` run, at JAX's training
  bounds (f 1e-6 relative, M rtol 1e-5);
- the pipeline CLI under 2 ranks (``WORLD_SIZE``/``RANK``, as torchrun
  sets them) on the synthetic release, against the one-process CLI.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_dla_detection_tpu.models.training import TrainingData as JaxTrainingData
from gp_dla_detection_tpu.models.training import learn_gp_model as jax_learn_gp_model
from gp_dla_detection_tpu.params import NullModelParams as JaxNullModelParams
from gp_dla_detection_tpu.params import OptimizationParams as JaxOptimizationParams
from gp_dla_detection_tpu.params import Parameters as JaxParameters
from gp_dla_detection_tpu.parallel import ShardedRunConfig as JaxRunConfig
from gp_dla_detection_tpu.parallel import make_mesh as jax_make_mesh
from gp_dla_detection_tpu.parallel import process_spectra_sharded as jax_sharded
from gp_dla_detection_tpu.parallel.sharded_multi import (
    process_spectra_multi_sharded as jax_multi_sharded,
)
from gp_dla_detection_tpu_torch import multi_dla, pipeline
from gp_dla_detection_tpu_torch.models.training import TrainingData, learn_gp_model
from gp_dla_detection_tpu_torch.parallel import (
    Mesh,
    fetch_global,
    initialize_distributed,
    is_coordinator,
    batches,
    make_mesh,
    sharded_inference,
    sharded_multi,
)
from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
    ShardedRunConfig,
    process_spectra_sharded,
)
from gp_dla_detection_tpu_torch.parallel.sharded_multi import (
    process_spectra_multi_lean,
    process_spectra_multi_sharded,
)
from gp_dla_detection_tpu_torch.parallel.streaming import row_evidence

import torch_distributed_worker as worker
from synthetic_problem import make_problem

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PDB = worker.PER_RANK_BATCH


def spawn(out_dir: Path, mode: str, *extra):
    """Start the worker as two gloo-coupled processes; their output goes
    to files (a full pipe would block one rank inside a collective and
    deadlock both)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out_dir.mkdir(parents=True, exist_ok=True)
    logs = [out_dir / f"{mode}_rank{r}.log" for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"), str(r), "2",
                 f"127.0.0.1:{port}", str(out_dir), mode, *extra],
                env=env, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
            ))
    return procs, logs


def join(procs, logs, timeout: float = 300) -> None:
    """Wait for both ranks; neither outlives the wait."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log.read_text()[-4000:]}"


def cfg(**kw):
    return ShardedRunConfig(per_device_batch=PDB, sample_chunk=32, dtype="float64",
                            device="cpu", backend="torch", **kw)


@pytest.fixture(scope="module")
def problem():
    return worker.port_problem()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, problem):
    """The two ranks' runs (loaded per name and rank) and, meanwhile, the
    port's one-process runs at the workers' per-rank batch."""
    out = tmp_path_factory.mktemp("ranks")
    procs = spawn(out, "drivers")
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    # the serial loop here; the ranks run at depth 4
    serial = dict(pipeline_depth=1)
    single = lambda **kw: process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f, params=params, config=cfg(**serial, **kw)
    )
    multi = lambda **kw: process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params,
        config=cfg(**serial, **kw),
    )
    lean = dict(store_sample_likelihoods=False, store_cddf_inputs=True)
    one = {
        "single_full": worker.single_fields(single()),
        "single_lean": worker.single_fields(single(store_sample_likelihoods=False)),
        "fused": worker.multi_fields(multi(**lean)),
        "classic": worker.multi_fields(multi()),
    }
    with pytest.warns(UserWarning, match="base_replicates=4"):
        one["fused_r4"] = worker.multi_fields(process_spectra_multi_sharded(
            model, *worker.samples_320(), spectra, prior_z, worker.prior_num(), params=params,
            config=cfg(base_replicates=4, **serial, **lean),
        ))
    join(*procs)

    def load(name, rank=0):
        with np.load(out / f"{name}_p{rank}.npz") as f:
            return {k: f[k] for k in f.files}

    load.dir = out
    return load, one


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


def jax_run(lean=False, multi=False, sample_parallelism=1, **kw):
    params, model, spectra, offsets, nhis, prior_z, prior_f = make_problem()
    mesh = jax_make_mesh(sample_parallelism=sample_parallelism)
    config = JaxRunConfig(per_device_batch=1, sample_chunk=32, dtype="float64",
                          store_sample_likelihoods=not lean, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if multi:
            return jax_multi_sharded(model, offsets, nhis, spectra, prior_z, worker.prior_num(),
                                     params=params, mesh=mesh, config=config)
        return jax_sharded(model, offsets, nhis, spectra, prior_z, prior_f, params=params,
                           mesh=mesh, config=config)


def assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_inputs_are_the_jax_problem(problem):
    ours, ref = problem, make_problem()
    for i in (3, 4, 5, 6):
        np.testing.assert_array_equal(ours[i], ref[i])
    for f in dataclasses.fields(ref[2]):
        np.testing.assert_array_equal(getattr(ours[2], f.name), getattr(ref[2], f.name))
    np.testing.assert_array_equal(ours[1].M.numpy(), ref[1].M)
    assert ours[0].to_json() == ref[0].to_json()


def test_one_rank_mesh_and_refusals():
    mesh = make_mesh()
    assert (mesh.world, mesh.shape, mesh.device, mesh.is_coordinator) == (
        1, {"data": 1, "sample": 1}, None, True
    )
    assert is_coordinator()
    initialize_distributed()  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(fetch_global(x, mesh), x.numpy())
    with pytest.raises(ValueError, match="one process per card"):
        make_mesh(num_devices=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(sample_parallelism=2)


@pytest.mark.parametrize("mode", ["full", "lean"])
def test_data_axis_is_bit_equal_to_one_process(ranks, one, mode):
    ours = ranks(f"single_{mode}")
    assert_bit_equal(ours, one[f"single_{mode}"])
    assert_bit_equal(ranks(f"single_{mode}", 1), ours)


@pytest.mark.parametrize("mode", ["full", "lean"])
def test_sample_axis_matches_one_process(ranks, one, mode):
    ours, ref = ranks(f"sample_{mode}"), one[f"single_{mode}"]
    assert_bit_equal(ranks(f"sample_{mode}", 1), ours)
    np.testing.assert_allclose(ours["log_likelihoods_no_dla"], ref["log_likelihoods_no_dla"],
                               rtol=1e-12)
    if mode == "full":
        np.testing.assert_allclose(ours["sample_log_likelihoods_dla"],
                                   ref["sample_log_likelihoods_dla"], rtol=1e-10)
    else:
        np.testing.assert_array_equal(ours["map_sample_inds"], ref["map_sample_inds"])
        np.testing.assert_allclose(ours["log_likelihoods_dla"], ref["log_likelihoods_dla"],
                                   rtol=1e-10)
    np.testing.assert_allclose(ours["p_dlas"], ref["p_dlas"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("axis", ["data", "sample"])
def test_full_mode_evidence_is_the_one_device_reduction_of_its_rows(ranks, axis):
    """The full mode's evidence on either axis: the lean mode's bit for
    bit, and the one-device reduction (``streaming.row_evidence``) of the
    whole rows it returns; on the sample axis the rows are gathered on the
    host and the evidence reduced from them on the device."""
    name = {"data": "single", "sample": "sample"}[axis]
    full, lean = ranks(f"{name}_full"), ranks(f"{name}_lean")
    for k in ("log_likelihoods_dla", "p_dlas", "model_posteriors"):
        np.testing.assert_array_equal(full[k], lean[k], err_msg=k)
    rows = torch.as_tensor(full["sample_log_likelihoods_dla"])
    np.testing.assert_array_equal(full["log_likelihoods_dla"], row_evidence(rows).numpy())


@pytest.mark.parametrize("sample_parallelism", [1, 2], ids=["data", "sample"])
@pytest.mark.parametrize("mode", ["full", "lean"])
def test_single_driver_matches_jax_mesh(ranks, mode, sample_parallelism):
    name = ("single_" if sample_parallelism == 1 else "sample_") + mode
    ours = ranks(name)
    ref = jax_run(lean=mode == "lean", sample_parallelism=sample_parallelism)
    for k in ("log_likelihoods_no_dla", "log_likelihoods_dla", "p_dlas", "min_z_dlas"):
        np.testing.assert_allclose(ours[k], getattr(ref, k), rtol=1e-9, atol=1e-300, err_msg=k)
    if mode == "full":
        np.testing.assert_allclose(ours["sample_log_likelihoods_dla"],
                                   ref.sample_log_likelihoods_dla, rtol=1e-9)
    else:
        np.testing.assert_array_equal(ours["map_sample_inds"], ref.map_sample_inds)


def assert_chain_matches_jax(ours: dict, ref):
    """The fused chain against JAX's at 1e-9: the MAP, MAP-pair and
    MAP-base indices equal, and in ``cddf_ex`` the exact entries' sample
    indices and the counters equal, their probabilities at 1e-9."""
    for k in ("log_likelihoods_dla2", "model_posteriors", "log_likelihoods_dla"):
        a, b = ours[k], getattr(ref, k) if hasattr(ref, k) else getattr(ref.single, k)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300, err_msg=k)
    for k in ("map_sample_inds2", "map_base_sample_inds"):
        np.testing.assert_array_equal(ours[k], getattr(ref, k), err_msg=k)
    np.testing.assert_array_equal(ours["map_sample_inds"], ref.single.map_sample_inds)
    np.testing.assert_allclose(ours["cddf_hist"], ref.cddf_inputs.hist, rtol=1e-9, atol=1e-300)
    K = ref.cddf_inputs.spec.top_k
    ex, ref_ex = ours["cddf_ex"], ref.cddf_inputs.ex
    for blk in (1, 3, 4):   # ex1_idx, ex2_pair_idx, ex2_base_idx
        np.testing.assert_array_equal(ex[:, blk * K : (blk + 1) * K], ref_ex[:, blk * K : (blk + 1) * K])
    np.testing.assert_array_equal(ex[:, 5 * K :], ref_ex[:, 5 * K :])
    for blk in (0, 2):      # ex1_p, ex2_p
        np.testing.assert_allclose(ex[:, blk * K : (blk + 1) * K], ref_ex[:, blk * K : (blk + 1) * K],
                                   rtol=1e-9, atol=1e-300)


def test_fused_chain_matches_one_process_and_jax(ranks, one):
    ours = ranks("fused")
    assert_bit_equal(ours, one["fused"])
    assert_bit_equal(ranks("fused", 1), ours)
    assert_chain_matches_jax(ours, jax_run(lean=True, multi=True, store_cddf_inputs=True))


@pytest.fixture(scope="module")
def jax_fused_sample():
    """JAX's fused chain with CDDF inputs on the 8-device CPU mesh with a
    sample axis of 2 (its XLA path shards the whole chain)."""
    return jax_run(lean=True, multi=True, sample_parallelism=2, store_cddf_inputs=True)


def test_fused_chain_on_sample_axis_matches_one_process_and_jax(ranks, one, jax_fused_sample):
    """Data 1 x sample 2: each rank evaluates half the columns of the
    one-device layout in both stages; the gathered rows give the
    one-process chain bit for bit, every index and tie order included."""
    ours = ranks("fused_sample")
    assert_bit_equal(ours, one["fused"])
    assert_bit_equal(ranks("fused_sample", 1), ours)
    assert_chain_matches_jax(ours, jax_fused_sample)


def test_fused_chain_on_sample_axis_at_r4(ranks, one):
    """R = 4 on 320 samples on the sample axis: the draw pattern is laid
    out once on the whole axis (a 256-column tile of 64 distinct draws),
    so the 160-column blocks, whose boundary cuts a tile, redraw the
    one-process pairs."""
    assert multi_dla.replicate_draw_pattern(320, sharded_multi.PATTERN_TILE, 4)[1] < 320
    ours = ranks("fused_sample_r4")
    assert_bit_equal(ours, one["fused_r4"])
    assert_bit_equal(ranks("fused_sample_r4", 1), ours)


@pytest.mark.parametrize("stage", ["single", "pair"])
def test_float32_plain_path_halves_of_the_axis_equal_the_whole(stage):
    """What the sample-axis chain's bit-identity in float32 rests on: the
    plain path evaluates the two halves of the column layout, each a whole
    number of sample chunks, to the whole axis's values bit for bit
    (tests/test_torch_cuda.py holds it on the card at production shapes)."""
    halves, whole = worker.plain_path_halves("cpu", stage, 3, 384, 4, 400, 100)
    assert np.isfinite(whole).any()
    np.testing.assert_array_equal(halves, whole)


def test_fused_chain_on_sample_axis_resumes_data_axis_checkpoints(ranks):
    """The sample mesh at the data mesh's super-batch resumes its
    checkpoints (test_only_the_coordinator_writes: nothing more written)."""
    for r in (0, 1):
        assert_bit_equal(ranks("fused_sample_resumed", r), ranks("fused"))


def test_classic_flow_matches_one_process_and_jax(ranks, one):
    ours = ranks("classic")
    assert_bit_equal(ours, one["classic"])
    assert_bit_equal(ranks("classic", 1), ours)
    ref = jax_run(multi=True)
    np.testing.assert_array_equal(ours["base_sample_inds"], ref.base_sample_inds)
    a, b = ours["sample_log_likelihoods_dla2"], ref.sample_log_likelihoods_dla2
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=1e-9)
    np.testing.assert_allclose(ours["model_posteriors"], ref.model_posteriors, rtol=1e-9,
                               atol=1e-12)


def test_only_the_coordinator_writes(ranks):
    w0, w1 = ranks("writes"), ranks("writes", 1)
    # two super-batches of 8 in each checkpointed stream: the single
    # driver full and lean, the fused chain, the classic single and pair
    assert (int(w0["npz"]), int(w0["json"])) == (10, 10)
    assert (int(w1["npz"]), int(w1["json"])) == (0, 0)
    for sub in ("ckpt_full", "ckpt_lean", "ckpt_fused/fused", "ckpt_classic/single",
                "ckpt_classic/pair"):
        manifest = json.loads((ranks.dir / sub / "manifest.json").read_text())
        assert manifest["completed_batches"] == [0, 1], sub
        assert manifest["batch_size"] == 2 * PDB


def test_sample_axis_is_refused_by_the_chain(ranks, problem):
    """Under "cuda" only (the kernels run data-parallel), before anything
    reaches the card: a CPU run names the CUDA device and is refused."""
    for r in (0, 1):
        assert "data-only mesh" in str(ranks("writes", r)["refused"])
    params, model, spectra, offsets, nhis, prior_z, _ = problem
    mesh = Mesh(world=2, rank=0, local_rank=0, n_data=1, n_sample=2, groups={}, backend="gloo")
    with pytest.raises(ValueError, match="CUDA kernels data-parallel only.*data-only mesh"):
        process_spectra_multi_lean(model, offsets, nhis, spectra, prior_z, worker.prior_num(),
                                   params=params, device="cuda", mesh=mesh)


def test_one_rank_mesh_resumes_every_batch(ranks, problem, monkeypatch):
    """The two ranks' checkpoints (super-batch 8) resume on one rank at
    per_device_batch 8: nothing is evaluated, the results are the ranks'."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem

    def refuse(*a, **kw):
        raise AssertionError("a resumed batch was evaluated")

    for module, name in ((sharded_inference, "batch_log_likelihoods"),
                         (sharded_multi, "batch_log_likelihoods"),
                         (sharded_multi, "batch_dla2_log_likelihoods")):
        monkeypatch.setattr(module, name, refuse)
    resume = lambda sub, **kw: ShardedRunConfig(
        per_device_batch=2 * PDB, sample_chunk=32, dtype="float64", device="cpu",
        backend="torch", checkpoint_dir=str(ranks.dir / sub), **kw,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = {
            "single_full": process_spectra_sharded(
                model, offsets, nhis, spectra, prior_z, prior_f, params=params,
                config=resume("ckpt_full")),
            "single_lean": process_spectra_sharded(
                model, offsets, nhis, spectra, prior_z, prior_f, params=params,
                config=resume("ckpt_lean", store_sample_likelihoods=False)),
        }
        got = {k: worker.single_fields(v) for k, v in got.items()}
        for name, kw in (("fused", dict(store_sample_likelihoods=False, store_cddf_inputs=True)),
                         ("classic", {})):
            got[name] = worker.multi_fields(process_spectra_multi_sharded(
                model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params,
                config=resume(f"ckpt_{name}", **kw)))
    for name, fields in got.items():
        assert_bit_equal(fields, ranks(name))


@pytest.mark.parametrize("optimizer", ["host", "device"])
def test_training_on_two_ranks(ranks, optimizer):
    fields, null_kw = worker.training_problem()
    ours = ranks(f"train_{optimizer}")
    assert_bit_equal(ranks(f"train_{optimizer}", 1), ours)
    model, res = learn_gp_model(TrainingData(**fields), worker.training_params(null_kw),
                                device="cpu", optimizer=optimizer)
    refs = [(model.M.numpy(), res.f)]
    if optimizer == "host":
        jparams = JaxParameters(null_model=JaxNullModelParams(**null_kw),
                                optimization=JaxOptimizationParams(max_iterations=10,
                                                                   max_fun_evals=20))
        jmodel, jres = jax_learn_gp_model(JaxTrainingData(**fields), jparams,
                                          mesh=jax_make_mesh())
        refs.append((jmodel.M, jres.f))
    assert (int(ours["iterations"]), int(ours["fun_evals"]), str(ours["message"])) == (
        res.iterations, res.fun_evals, res.message)
    for M, f in refs:
        assert abs(float(ours["f"]) - f) < 1e-6 * abs(f)
        np.testing.assert_allclose(ours["M"], M, rtol=1e-5, atol=1e-7)


def test_pipeline_cli_on_two_ranks(synthetic_release, tmp_path, monkeypatch):
    base = synthetic_release.base_directory
    ranks = spawn(tmp_path, "cli", str(base))
    # the one-process run meanwhile
    monkeypatch.setattr(pipeline, "Parameters", worker.small_parameters)
    one_dir = tmp_path / "one"
    pipeline.main(worker.cli_argv(one_dir, base, 2))
    join(*ranks)
    two_dir = tmp_path / "cli"
    summary = lambda d: json.loads((d / "summary.json").read_text())
    s1, s2 = summary(one_dir), summary(two_dir)
    assert {k: v for k, v in s2.items() if k != "artifacts"} == {
        k: v for k, v in s1.items() if k != "artifacts"
    }
    assert s2["num_processed"] == 8
    # the host stages: the coordinator's artifacts, bit for bit
    for name in ("catalog.npz", "preloaded_qsos.npz", "dla_samples.npz"):
        with np.load(one_dir / name, allow_pickle=True) as a, \
                np.load(two_dir / name, allow_pickle=True) as b:
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
    # training on two ranks: the NLL to JAX's bound and the same budget
    # used.  The release's few training spectra leave M's weakest
    # direction nearly free and 15 iterations stop far from convergence,
    # so the sums' other order moves the path: M M' to 1e-3 of its scale
    with np.load(one_dir / "learned_qso_model_dr9q_minus_concordance.npz") as a, \
            np.load(two_dir / "learned_qso_model_dr9q_minus_concordance.npz") as b:
        ma, mb = json.loads(str(a["metadata"])), json.loads(str(b["metadata"]))
        assert abs(mb.pop("log_likelihood") / ma.pop("log_likelihood") - 1) < 1e-6
        assert mb == ma
        cov_a, cov_b = a["M"] @ a["M"].T, b["M"] @ b["M"].T
        assert np.max(np.abs(cov_b - cov_a)) < 1e-3 * np.max(np.abs(cov_a))
    with np.load(one_dir / "processed_qsos_multi_dr12q.npz") as a, \
            np.load(two_dir / "processed_qsos_multi_dr12q.npz") as b:
        np.testing.assert_allclose(b["multi_model_posteriors"], a["multi_model_posteriors"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(b["map_sample_inds"], a["map_sample_inds"])
    stats = lambda d: json.loads((d / "analysis" / "statistics.json").read_text())
    assert stats(two_dir)["lean_inputs"] is True
    # 8 test spectra in super-batches of 2 x 2, checkpointed once
    manifest = json.loads((two_dir / "multi_ckpt" / "fused" / "manifest.json").read_text())
    assert (manifest["batch_size"], manifest["completed_batches"]) == (4, [0, 1])


# ---------------------------------------------------------------------------
# the pipelined loop: upload / issue / complete
# ---------------------------------------------------------------------------

PIPELINES = (1, 2, 4, 6)


def run_driver(problem, driver: str, **kw):
    """``driver`` ("single_full", "single_lean", "classic", "fused") on
    the problem in super-batches of 2 (six batches), one process."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    config = ShardedRunConfig(per_device_batch=2, sample_chunk=32, device="cpu",
                              backend="torch", **{"dtype": "float64", **kw})
    if driver.startswith("single"):
        config.store_sample_likelihoods = driver == "single_full"
        return worker.single_fields(process_spectra_sharded(
            model, offsets, nhis, spectra, prior_z, prior_f, params=params, config=config))
    if driver == "fused":
        config.store_sample_likelihoods = False
    return worker.multi_fields(process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, worker.prior_num(), params=params, config=config))


def test_pipeline_defaults_and_refusal(problem):
    """The JAX package's default: four batches in flight; a depth below 1
    is refused before anything runs."""
    assert ShardedRunConfig().pipeline_depth == JaxRunConfig().pipeline_depth == 4
    for driver in ("single_full", "classic", "fused"):
        with pytest.raises(ValueError, match="depth must be >= 1"):
            run_driver(problem, driver, pipeline_depth=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("driver", ["single_full", "single_lean", "classic"])
def test_every_pipeline_depth_gives_the_same_bits(problem, driver, dtype):
    """The single driver (full and lean) and the classic flow (its single
    stage and its pair stage pipelined) at depths 1, 2, 4 and 6 (every
    one of the six batches in flight): bit-identical results."""
    runs = {d: run_driver(problem, driver, dtype=dtype, pipeline_depth=d) for d in PIPELINES}
    serial = runs[1]
    for key, fields in runs.items():
        assert_bit_equal(fields, serial)


def fail_in_complete(real, batch: int):
    """``run_pipelined_split`` whose ``complete`` raises at ``batch``."""

    def split(items, upload, issue, complete, **kw):
        def complete_or_fail(item, state):
            if item[0] == batch:
                raise RuntimeError(f"injected failure at batch {batch}")
            complete(item, state)

        real(items, upload, issue, complete_or_fail, **kw)

    return split


STREAMS = {  # driver -> (the module of its evaluation, its checkpoint subdirectory)
    "single_full": (sharded_inference, "."),
    "fused": (sharded_multi, "fused"),
    "classic": (sharded_multi, "pair"),
}


@pytest.mark.parametrize("driver", sorted(STREAMS))
def test_resume_after_a_failure_mid_pipeline(problem, driver, tmp_path, monkeypatch):
    """A failure in batch 2's ``complete`` at depth 4: the manifest lists
    only batches whose file landed, none at or past the failure; a rerun
    computes exactly the batches it does not list and gives the
    uninterrupted run's results bit for bit."""
    home, sub = STREAMS[driver]
    ckpt = tmp_path / sub
    uninterrupted = run_driver(problem, driver, pipeline_depth=1)
    with monkeypatch.context() as m:
        m.setattr(batches, "run_pipelined_split", fail_in_complete(batches.run_pipelined_split, 2))
        with pytest.raises(RuntimeError, match="injected failure at batch 2"):
            run_driver(problem, driver, checkpoint_dir=str(tmp_path))
    manifest = ckpt / "manifest.json"
    listed = json.loads(manifest.read_text())["completed_batches"] if manifest.exists() else []
    files = sorted(int(f.stem.split("_")[1]) for f in ckpt.glob("batch_*.npz"))
    assert set(listed) <= set(files) <= {0, 1}
    assert not list(ckpt.glob("*.tmp"))

    evaluated = []
    name = "batch_dla2_log_likelihoods" if driver == "classic" else "batch_log_likelihoods"
    real = getattr(home, name)
    monkeypatch.setattr(home, name, lambda *a, **kw: evaluated.append(1) or real(*a, **kw))
    resumed = run_driver(problem, driver, checkpoint_dir=str(tmp_path))
    assert len(evaluated) == 6 - len(listed)
    assert_bit_equal(resumed, uninterrupted)


@pytest.mark.parametrize("driver", sorted(STREAMS))
def test_a_failed_checkpoint_write_raises(problem, driver, tmp_path, monkeypatch):
    def full_disk(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(batches, "atomic_savez", full_disk)
    with pytest.raises(OSError, match="disk full"):
        run_driver(problem, driver, checkpoint_dir=str(tmp_path))


def test_fetch_global_takes_a_host_tensor_without_copying():
    """``complete`` hands ``fetch_global`` the host buffer its copy landed
    in; on an axis with no group the array returned is that buffer."""
    x = torch.arange(6.0).reshape(2, 3)
    got = fetch_global(x, make_mesh())
    assert np.shares_memory(got, x.numpy())
    np.testing.assert_array_equal(got, x.numpy())
