"""Two-rank torch.distributed worker for tests/test_torch_parallel.py.

Each worker is one rank of a gloo process group on the CPU and runs the
port's drivers on a mesh of both ranks, float64 on the plain path,
saving what it holds to ``<out_dir>/<run>_p<rank>.npz``.  The inputs are
tests/synthetic_problem.py's, built with the port's own classes (this
file imports nothing of jax or of the JAX package).

Usage: python torch_distributed_worker.py <rank> <world> <addr> <out_dir> <mode> [base_directory]

mode "drivers": the single-DLA driver (full and lean) on a data mesh
  and on a data 1 x sample 2 mesh, the fused lean chain with CDDF
  inputs and the classic flow on the data mesh (with checkpoints and a
  count of each rank's checkpoint writes), the fused chain on the sample
  mesh (R = 1, R = 4, and resuming the data mesh's checkpoints), its
  refusal of the sample mesh under ``"cuda"``, and the training on the
  data mesh (host and device L-BFGS);
mode "cli": ``python -m gp_dla_detection_tpu_torch.pipeline`` as under
  torchrun (WORLD_SIZE, RANK), on the synthetic release at
  ``base_directory``, with the test-sized parameters.
"""

import dataclasses
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

PER_RANK_BATCH = 4


def port_problem():
    """tests/synthetic_problem.make_problem's inputs with the port's
    classes: (params, model, spectra, offsets, nhis, prior_z, prior_f)."""
    from gp_dla_detection_tpu_torch.inference import PaddedSpectra
    from gp_dla_detection_tpu_torch.models.qso_model import GPModel
    from gp_dla_detection_tpu_torch.params import NullModelParams, Parameters

    rng = np.random.default_rng(3)
    params = Parameters(null_model=NullModelParams(k=4))
    grid = params.null_model.rest_wavelengths()
    model = GPModel.from_numpy(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, 4)) * 0.08,
        log_omega=np.log(0.2 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
        device="cpu",
        dtype=torch.float64,
    )
    B, P, S = 11, 384, 64
    z = rng.uniform(2.5, 3.4, B)
    lam = np.stack([10 ** (np.log10(911.9 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z])
    mask = rng.uniform(size=(B, P)) > 0.05
    spectra = PaddedSpectra(lam, rng.normal(1, 0.3, (B, P)), rng.uniform(0.05, 0.2, (B, P)), mask, z)
    offsets = rng.uniform(size=S)
    nhis = 10 ** rng.uniform(20, 22, S)
    prior_z = rng.uniform(2.2, 3.6, 200)
    prior_f = rng.uniform(size=200) < 0.1
    return params, model, spectra, offsets, nhis, prior_z, prior_f


def prior_num():
    return np.random.default_rng(7).choice([0, 0, 0, 0, 0, 1, 1, 2], 200)


def samples_320():
    """320 samples, wider than the 256-column tile R > 1 lays its draws on
    (tests/test_torch_cddf.py's set): (offsets, nhis)."""
    rng = np.random.default_rng(17)
    return rng.uniform(size=320), 10 ** rng.uniform(20, 22, 320)


def plain_path_halves(device, stage, n, pixels, k, num_samples, chunk):
    """The float32 plain path's ``stage`` ("single" or "pair") evidences
    of ``utils.synthetic_workload``'s n spectra on ``device``: (the two
    halves of the sample axis evaluated apart and joined, the whole axis),
    both (n, num_samples) numpy arrays.  The pair's base axis is a seeded
    permutation of the samples per spectrum."""
    from gp_dla_detection_tpu_torch.inference import batch_log_likelihoods
    from gp_dla_detection_tpu_torch.multi_dla import batch_dla2_log_likelihoods
    from gp_dla_detection_tpu_torch.params import kms_to_z
    from gp_dla_detection_tpu_torch.utils import synthetic_workload

    w = synthetic_workload(n, num_samples, pixels=pixels, k=k, seed=0, dtype=np.float64)
    f32 = lambda a: torch.as_tensor(np.asarray(a), device=device).to(torch.float32)
    spectrum = (f32(w["wavelengths"]), f32(w["flux"]), f32(w["noise_variance"]),
                torch.as_tensor(w["mask"], device=device), f32(w["z_qso"]))
    model = (f32(w["grid"]), f32(w["mu"]), f32(w["M"]), f32(w["log_omega"]),
             w["log_c_0"], w["log_tau_0"], w["log_beta"])
    off, nhi = w["offsets"], w["nhis"]
    base = np.stack([np.random.default_rng(i).permutation(num_samples) for i in range(n)])

    def run(cols):
        if stage == "single":
            out = batch_log_likelihoods(
                *spectrum, *model, f32(off[cols]), f32(nhi[cols]), params=w["params"],
                sample_chunk=chunk, backend="torch",
            )["sample_log_likelihoods_dla"]
        else:
            out = batch_dla2_log_likelihoods(
                *spectrum, *model, f32(off[cols]), f32(nhi[cols]), f32(off[base[:, cols]]),
                f32(nhi[base[:, cols]]), params=w["params"], min_sep_z=kms_to_z(3000.0),
                backend="torch", sample_chunk=chunk,
            )
        return out.cpu().numpy()

    half = num_samples // 2
    halves = np.concatenate([run(np.arange(half)), run(np.arange(half, num_samples))], axis=1)
    return halves, run(np.arange(num_samples))


def training_problem(N=41, R=32, k=2, seed=5):
    """tests/test_parallel.py::test_data_parallel_training's data, with
    an odd row count (the padding): (TrainingData fields, params kwargs)."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(N, R)) > 0.2
    fields = dict(
        centered_flux=np.where(mask, rng.normal(0, 0.4, (N, R)), 0.0),
        lya_1pzs=np.where(mask, 1 + rng.uniform(1.5, 3, (N, R)), 1.0),
        noise_variance=np.where(mask, rng.uniform(0.02, 0.3, (N, R)), 0.0),
        mask=mask,
        mu=np.zeros(R),
    )
    return fields, dict(min_lambda=1000.0, max_lambda=1000.0 + 0.25 * (R - 1), k=k)


def training_params(null_kw, iterations=10, evals=20):
    from gp_dla_detection_tpu_torch.params import NullModelParams, OptimizationParams, Parameters

    return Parameters(
        null_model=NullModelParams(**null_kw),
        optimization=OptimizationParams(max_iterations=iterations, max_fun_evals=evals),
    )


def small_parameters(**kw):
    """tests/test_torch_pipeline.py's test-sized parameter set."""
    from gp_dla_detection_tpu_torch.params import (
        DLASamplingParams,
        NullModelParams,
        OptimizationParams,
        Parameters,
    )

    return dataclasses.replace(
        Parameters(**kw),
        null_model=NullModelParams(k=3),
        optimization=OptimizationParams(max_iterations=15, max_fun_evals=30),
        dla_sampling=DLASamplingParams(num_dla_samples=100),
    )


def cli_argv(workdir, base_directory, per_device_batch):
    return [
        "--workdir", str(workdir), "--base-directory", str(base_directory),
        "--device", "cpu", "--dtype", "float64", "--per-device-batch", str(per_device_batch),
        "--lean", "--multi-dla", "--cddf-inputs",
    ]


def multi_fields(multi) -> dict:
    out = {
        "log_likelihoods_no_dla": multi.single.log_likelihoods_no_dla,
        "log_likelihoods_dla": multi.single.log_likelihoods_dla,
        "p_dlas": multi.single.p_dlas,
        "log_likelihoods_dla2": multi.log_likelihoods_dla2,
        "model_posteriors": multi.model_posteriors,
    }
    for name in ("map_sample_inds2", "map_base_sample_inds", "sample_log_likelihoods_dla2",
                 "base_sample_inds"):
        if getattr(multi, name) is not None:
            out[name] = getattr(multi, name)
    if multi.single.map_sample_inds is not None:
        out["map_sample_inds"] = multi.single.map_sample_inds
    if multi.single.sample_log_likelihoods_dla is not None:
        out["sample_log_likelihoods_dla"] = multi.single.sample_log_likelihoods_dla
    if multi.cddf_inputs is not None:
        out["cddf_hist"], out["cddf_ex"] = multi.cddf_inputs.hist, multi.cddf_inputs.ex
    return out


def single_fields(res) -> dict:
    return {
        k: v for k, v in dataclasses.asdict(res).items() if isinstance(v, np.ndarray)
    }


def run_drivers(rank: int, out_dir: Path) -> None:
    from gp_dla_detection_tpu_torch.models.training import TrainingData, learn_gp_model
    from gp_dla_detection_tpu_torch.parallel import batches
    from gp_dla_detection_tpu_torch.parallel.mesh import make_mesh
    from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
        ShardedRunConfig,
        process_spectra_sharded,
    )
    from gp_dla_detection_tpu_torch.parallel.sharded_multi import (
        process_spectra_multi_lean,
        process_spectra_multi_sharded,
    )

    # count this rank's checkpoint writes (only the coordinator writes)
    writes = {"npz": 0, "json": 0}
    savez, write_json = batches.atomic_savez, batches.atomic_write_json

    def counted_savez(*a, **kw):
        writes["npz"] += 1
        return savez(*a, **kw)

    def counted_json(*a, **kw):
        writes["json"] += 1
        return write_json(*a, **kw)

    batches.atomic_savez = counted_savez
    batches.atomic_write_json = counted_json

    params, model, spectra, offsets, nhis, prior_z, prior_f = port_problem()
    data_mesh = make_mesh()
    sample_mesh = make_mesh(sample_parallelism=2)
    assert (data_mesh.shape, sample_mesh.shape) == (
        {"data": 2, "sample": 1}, {"data": 1, "sample": 2}
    )
    # the pipelined loop at the JAX package's defaults, stated
    config = lambda **kw: ShardedRunConfig(
        per_device_batch=PER_RANK_BATCH, sample_chunk=32, dtype="float64", device="cpu",
        backend="torch", pipeline_depth=4, **kw,
    )
    save = lambda name, fields: np.savez(out_dir / f"{name}_p{rank}.npz", **fields)
    single = lambda mesh, **kw: process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f, params=params, mesh=mesh, config=config(**kw)
    )

    save("single_full", single_fields(single(data_mesh, checkpoint_dir=str(out_dir / "ckpt_full"))))
    save("single_lean", single_fields(single(data_mesh, store_sample_likelihoods=False,
                                             checkpoint_dir=str(out_dir / "ckpt_lean"))))
    save("sample_full", single_fields(single(sample_mesh)))
    save("sample_lean", single_fields(single(sample_mesh, store_sample_likelihoods=False)))

    multi = lambda mesh, **kw: process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num(), params=params, mesh=mesh,
        config=config(**kw),
    )
    save("fused", multi_fields(multi(
        data_mesh, store_sample_likelihoods=False, store_cddf_inputs=True,
        checkpoint_dir=str(out_dir / "ckpt_fused"),
    )))
    save("classic", multi_fields(multi(data_mesh, checkpoint_dir=str(out_dir / "ckpt_classic"))))
    # the fused chain on the sample axis, at R = 1, at R = 4 on 320
    # samples, and resuming the data mesh's checkpoints at its
    # super-batch (it writes none)
    lean = dict(store_sample_likelihoods=False, store_cddf_inputs=True)
    save("fused_sample", multi_fields(multi(sample_mesh, **lean)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # R > 1 under "torch"
        save("fused_sample_r4", multi_fields(process_spectra_multi_sharded(
            model, *samples_320(), spectra, prior_z, prior_num(), params=params,
            mesh=sample_mesh, config=config(base_replicates=4, **lean),
        )))
    save("fused_sample_resumed", multi_fields(process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num(), params=params, mesh=sample_mesh,
        config=dataclasses.replace(config(**lean), per_device_batch=2 * PER_RANK_BATCH,
                                   checkpoint_dir=str(out_dir / "ckpt_fused")),
    )))
    try:
        process_spectra_multi_lean(model, offsets, nhis, spectra, prior_z, prior_num(),
                                   params=params, device="cuda", mesh=sample_mesh)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    save("writes", {"npz": writes["npz"], "json": writes["json"], "refused": refused})

    fields, null_kw = training_problem()
    data = TrainingData(**fields)
    for optimizer in ("host", "device"):
        m, r = learn_gp_model(
            data, training_params(null_kw), mesh=data_mesh, device="cpu", optimizer=optimizer
        )
        save(f"train_{optimizer}", {
            "M": m.M.numpy(), "log_omega": m.log_omega.numpy(), "x": r.x, "f": r.f,
            "iterations": r.iterations, "fun_evals": r.fun_evals, "message": r.message,
        })


def run_cli(rank: int, world: int, out_dir: Path, base_directory: str) -> None:
    import gp_dla_detection_tpu_torch.pipeline as pipeline

    os.environ["WORLD_SIZE"], os.environ["RANK"] = str(world), str(rank)
    pipeline.Parameters = small_parameters
    pipeline.main(cli_argv(out_dir / "cli", base_directory, 2))


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    addr, out_dir, mode = sys.argv[3], Path(sys.argv[4]), sys.argv[5]
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here.parent))  # the repo root, if not installed
    torch.set_num_threads(1)

    from gp_dla_detection_tpu_torch.parallel.mesh import initialize_distributed, shutdown

    initialize_distributed(addr, world, rank, backend="gloo")
    try:
        if mode == "drivers":
            run_drivers(rank, out_dir)
        else:
            run_cli(rank, world, out_dir, sys.argv[6])
    finally:
        shutdown()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gp_dla_detection_tpu")]
    assert not bad, bad


if __name__ == "__main__":
    main()
