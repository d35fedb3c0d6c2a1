"""Full-convergence GP training at survey training scale, on the card.

The counterpart of ``validation/training_convergence.py``, on the
PyTorch port (``models.training.learn_gp_model``), on the card by
default:

Part A (``part-a``): survey scale, the device optimizer, kill and
  resume.  ``learn_gp_model(optimizer="device")`` from scratch at N =
  25,000 x 1,217 (k = 20, 25,560 parameters) with the reference's full
  budget (MaxIter 2000 / MaxFunEvals 4000, set_parameters.m:43-45) in a
  worker process (``run-device``), SIGKILLed once its first optimizer
  checkpoint exists (and 5 s more), then resumed
  from the checkpoint to termination.  A leg 1 that crashes is an error.
Part B (``compare``): the host strong-Wolfe L-BFGS and the device
  L-BFGS from one init on the same data (N = 4,096); both converged, their
  final NLLs agree to 1e-5 (5e-3 when the budget cut them).

Each worker prints its wall time, iterations, evaluations and
termination, the final NLL and the gradient's inf-norm, seconds and
scalar reads from the card per evaluation, the peak device memory, and
whether the objective and its gradient give the same bits when evaluated
twice at the final point (``torch.autograd``'s backward may use atomics).
Where the run has a record in ``validation/RESULTS_TRAINING.md`` (the JAX
package's float64 runs: Part A at N = 25,000, Part B at N = 4,096 with
budget 2000), its NLL is printed beside the port's with their relative
difference.  The data are ``make_training_data``'s, bit for bit the JAX
harness's.  The port's report goes to stdout only, with a ``PART A
{json}`` / ``PART B {json}`` / ``TRAINING COMPLETE {json}`` line.

Usage:
  python scripts/torch_training_convergence.py [part-a] [--n-quasars 25000]
      [--dtype float64] [--workdir runs/torch_training]
  python scripts/torch_training_convergence.py compare [--n-quasars 4096]
      [--budget 400]
  python scripts/torch_training_convergence.py run-device --workdir W ...
The card by default; a default run that finds no card raises.
``--device cpu`` (with a toy ``--n-quasars`` and ``--budget``) is for
the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DEFAULT_WORKDIR = "runs/torch_training"
# validation/RESULTS_TRAINING.md: the JAX package's float64 records
RECORDED = {
    "part_a": {"n_quasars": 25000, "dtype": "float64", "nll": -2.180264e06,
               "iterations": 843, "fun_evals": 980, "termination": "progTol_f"},
    "part_b": {"n_quasars": 4096, "dtype": "float64", "budget": 2000, "nll": -3.79862352e05},
}
KILL_SETTLE_S = 5.0       # part A: the SIGKILL this long after the first checkpoint
                          # (the JAX harness's: a later checkpoint lands mid-descent)
KILL_POLL_S = 0.5         # part A: how often the parent looks for that checkpoint
CONVERGED_RTOL = 1e-5     # host vs device NLL when both converged (the JAX harness's)
TRAJECTORY_RTOL = 5e-3    # ... when the budget cut either


def make_training_data(n_quasars: int, seed: int = 5):
    """Synthetic training matrices from a known generating model, with
    per-quasar rest-coverage windows and noisy-pixel holes: the JAX
    harness's arrays, bit for bit (the same numpy draws in the same
    order)."""
    from gp_dla_detection_tpu_torch.models.training import TrainingData
    from gp_dla_detection_tpu_torch.params import LYA_WAVELENGTH, NullModelParams, Parameters

    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=20))
    grid = params.null_model.rest_wavelengths()
    R, k = grid.size, 20

    mu_true = 1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2)
    M_true = rng.normal(size=(R, k)) * 0.04
    omega_true = 0.1 + 0.05 * np.exp(-((grid - 1100) / 150.0) ** 2)

    z_qso = rng.uniform(2.2, 4.0, n_quasars)
    # observed-frame noise level varies per quasar
    sigma = rng.uniform(0.08, 0.25, n_quasars)

    flux = (
        mu_true[None, :]
        + rng.normal(size=(n_quasars, k)) @ M_true.T
        + rng.normal(size=(n_quasars, R)) * omega_true[None, :]
        + rng.normal(size=(n_quasars, R)) * sigma[:, None]
    )
    noise = np.broadcast_to(sigma[:, None] ** 2, (n_quasars, R)).copy()
    lya_1pzs = (1.0 + z_qso)[:, None] * grid[None, :] / LYA_WAVELENGTH

    # coverage: blue end observable only for high-z quasars (rough BOSS
    # 3650 A blue limit), plus random masked holes
    obs_blue = 3650.0
    mask = grid[None, :] * (1.0 + z_qso)[:, None] >= obs_blue
    mask &= rng.uniform(size=(n_quasars, R)) > 0.01

    with np.errstate(invalid="ignore"):
        masked_flux = np.where(mask, flux, np.nan)
        mu_emp = np.nanmean(masked_flux, axis=0)
    centered = np.where(mask, flux - mu_emp[None, :], 0.0)
    return params, TrainingData(
        centered_flux=centered,
        lya_1pzs=np.where(mask, lya_1pzs, 1.0),
        noise_variance=np.where(mask, noise, 0.0),
        mask=mask,
        mu=mu_emp,
    )


def with_budget(params, budget: int | None):
    """``params`` with the L-BFGS budget cut to ``budget`` iterations and
    twice as many evaluations (None: as it is)."""
    from gp_dla_detection_tpu_torch.params import OptimizationParams

    if budget is None:
        return params
    return dataclasses.replace(params, optimization=OptimizationParams(
        max_iterations=budget, max_fun_evals=2 * budget))


def torch_dtype(name: str):
    import torch

    return {"float32": torch.float32, "float64": torch.float64}[name]


def same_bits_twice(data, params, x, dtype, device) -> dict:
    """The objective and its gradient (``learn_gp_model``'s, through
    ``torch.autograd``) evaluated twice at ``x`` on ``device``: whether
    the value's and the gradient's bits are equal, and how many gradient
    entries differ."""
    import torch

    from gp_dla_detection_tpu_torch.models.training import flat_layout, objective, unravel

    R, k = data.centered_flux.shape[1], params.null_model.k
    layout = flat_layout({"M": np.zeros((R, k)), "log_omega": np.zeros(R), "log_c_0": 0.0,
                          "log_tau_0": 0.0, "log_beta": 0.0})
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    args = (put(data.centered_flux).to(dtype), put(data.lya_1pzs).to(dtype),
            put(data.noise_variance).to(dtype), put(data.mask))
    x = put(x).to(dtype)

    def value_and_grad():
        flat = x.detach().requires_grad_(True)
        f = objective(unravel(flat, layout), *args)
        (g,) = torch.autograd.grad(f, flat)
        return f.detach(), g

    (f1, g1), (f2, g2) = value_and_grad(), value_and_grad()
    return {"value_equal": bool(torch.equal(f1, f2)), "grad_equal": bool(torch.equal(g1, g2)),
            "grad_entries_differing": int((g1 != g2).sum())}


def device_label(device) -> str:
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def fit(data, params, dtype: str, optimizer: str, device, checkpoint_path=None) -> dict:
    """One ``learn_gp_model`` run on ``device`` and what it cost: the
    result, the wall seconds, the evaluations this process made, scalar
    reads from the card per evaluation (the device optimizer's reads;
    the host optimizer brings the value and the whole gradient to the
    host at every evaluation) and the peak device memory."""
    import torch

    from gp_dla_detection_tpu_torch.models.training import learn_gp_model
    from gp_dla_detection_tpu_torch.ops import lbfgs_device

    device = torch.device(device)
    on_card = device.type == "cuda"
    start_evals = 0
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        with np.load(checkpoint_path) as ck:
            start_evals = int(ck["evals"])
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    syncs0 = lbfgs_device.host_syncs
    t0 = time.perf_counter()
    _, result = learn_gp_model(data, params=params, dtype=torch_dtype(dtype), optimizer=optimizer,
                               checkpoint_path=checkpoint_path, device=device)
    wall = time.perf_counter() - t0
    evals = result.fun_evals - start_evals
    return {
        "result": result,
        "wall_s": wall,
        "evals_this_process": evals,
        "s_per_eval": wall / max(evals, 1),
        "scalar_reads_per_eval": ((lbfgs_device.host_syncs - syncs0) / max(evals, 1)
                                  if optimizer == "device" else None),
        "peak_device_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                  if on_card else None),
    }


def summary(run: dict) -> dict:
    r = run["result"]
    return {
        "wall_s": run["wall_s"], "final_nll": float(r.f), "iterations": int(r.iterations),
        "fun_evals": int(r.fun_evals), "termination": r.message, "converged": r.converged,
        "grad_inf_norm": float(np.max(np.abs(r.g))), "s_per_eval": run["s_per_eval"],
        "evals_this_process": run["evals_this_process"],
        "scalar_reads_per_eval": run["scalar_reads_per_eval"],
        "peak_device_memory_gb": run["peak_device_memory_gb"],
    }


def run_device(workdir: Path, n_quasars: int, dtype: str, seed: int = 5, device=None,
               budget: int | None = None) -> dict:
    """Worker: a from-scratch (or checkpoint-resumed) device L-BFGS fit;
    writes ``result.json`` and ``result.npz`` (the final x, f and g) to
    ``workdir`` and prints ``TRAINING COMPLETE {json}``."""
    from gp_dla_detection_tpu_torch.runtime import default_device

    device = default_device(device)
    params, data = make_training_data(n_quasars, seed)
    params = with_budget(params, budget)
    workdir.mkdir(parents=True, exist_ok=True)
    ckpt = workdir / "lbfgs_ckpt.npz"
    resumed_at = None
    if ckpt.exists():
        with np.load(ckpt) as f:
            resumed_at = int(f["it"])
    run = fit(data, params, dtype, "device", device, checkpoint_path=ckpt)
    r = run["result"]
    out = {**summary(run), "n_quasars": n_quasars, "dtype": dtype, "device": device_label(device),
           "resumed_from_iteration": resumed_at,
           "bits_twice": same_bits_twice(data, params, r.x, torch_dtype(dtype), device)}
    (workdir / "result.json").write_text(json.dumps(out))
    np.savez(workdir / "result.npz", x=r.x, f=np.float64(r.f), g=r.g)
    print(f"TRAINING COMPLETE {json.dumps(out)}", flush=True)
    return out


def device_args(device) -> list[str]:
    return [] if device is None else ["--device", str(device)]


def part_a(workdir: Path, n_quasars: int = 25000, dtype: str = "float32",
           kill_after_s: float = 3600.0, device=None, budget: int | None = None) -> dict:
    """Survey-scale device fit in a worker process, SIGKILLed
    KILL_SETTLE_S after the first optimizer checkpoint exists (killing
    before any checkpoint would restart from scratch and show nothing of
    the optimizer state's resume), then resumed to completion."""
    from gp_dla_detection_tpu_torch.runtime import default_device

    default_device(device)   # no card and no device named: raise here, not in a worker
    workdir.mkdir(parents=True, exist_ok=True)
    ckpt = workdir / "lbfgs_ckpt.npz"
    for stale in (ckpt, workdir / "result.json", workdir / "result.npz"):
        stale.unlink(missing_ok=True)

    def launch(tag):
        log = workdir / f"worker_{tag}.log"
        with open(log, "w") as fh:  # the child keeps its own descriptor
            return subprocess.Popen(
                [sys.executable, str(HERE / "torch_training_convergence.py"), "run-device",
                 "--workdir", str(workdir), "--n-quasars", str(n_quasars), "--dtype", dtype,
                 *device_args(device), *([] if budget is None else ["--budget", str(budget)])],
                stdout=fh, stderr=subprocess.STDOUT, cwd=REPO,
            )

    t_all = time.perf_counter()
    proc = launch("leg1")
    t0 = time.perf_counter()
    killed = met_running = False
    try:
        while time.perf_counter() - t0 < kill_after_s:
            if ckpt.exists():
                time.sleep(KILL_SETTLE_S)
                met_running = proc.poll() is None
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                killed = True
                break
            if proc.poll() is not None:
                if proc.returncode != 0:
                    # a crashed leg 1 must not pass for fast convergence: the
                    # kill and resume would go unexercised and leg 2 redo it all
                    raise RuntimeError(
                        f"leg 1 crashed (rc={proc.returncode}): "
                        f"{(workdir / 'worker_leg1.log').read_text()[-2000:]}")
                break  # finished cleanly before the kill point
            time.sleep(KILL_POLL_S)
        else:
            raise TimeoutError(f"no optimizer checkpoint appeared within {kill_after_s}s: "
                               "cannot exercise the kill and resume")
    finally:
        if proc.poll() is None:   # never leave a worker holding the card
            proc.kill()
            proc.wait()
    leg1_s = time.perf_counter() - t_all
    iters_at_kill = None
    if ckpt.exists():
        with np.load(ckpt) as f:
            iters_at_kill = int(f["it"])

    proc = launch("leg2")
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"resumed training failed: "
                           f"{(workdir / 'worker_leg2.log').read_text()[-2000:]}")
    wall_total = time.perf_counter() - t_all
    res = json.loads((workdir / "result.json").read_text())
    rec = RECORDED["part_a"]
    recorded = n_quasars == rec["n_quasars"] and dtype == rec["dtype"] and budget is None
    rel = abs(res["final_nll"] - rec["nll"]) / abs(rec["nll"]) if recorded else None
    out = {**res, "killed": killed, "kill_met_running_worker": met_running,
           "checkpoint_iteration_at_kill": iters_at_kill, "leg1_wall_s": leg1_s,
           "wall_total_s": wall_total,
           "jax_recorded_nll": rec["nll"] if recorded else None, "rel_diff_vs_jax": rel}
    budget_text = ("the reference budget (MaxIter 2000 / MaxFunEvals 4000)" if budget is None
                   else f"budget {budget} iterations / {2 * budget} evaluations")
    lines = [
        "## Part A: survey-scale device L-BFGS with a kill and a resume",
        "",
        f"- N = {n_quasars} x 1217 rest pixels, k = 20, dtype {dtype}, {budget_text}, "
        f"on {res['device']}",
        f"- SIGKILL {'delivered' if killed else 'NOT needed (finished first)'}"
        + (f" after the optimizer checkpoint at iteration {iters_at_kill}"
           if iters_at_kill is not None else "")
        + (f"; the worker was {'running' if met_running else 'already done'} when it landed"
           if killed else ""),
        f"- resumed and ran to termination '{res['termination']}' at iteration "
        f"{res['iterations']} ({res['fun_evals']} evaluations)",
        f"- final NLL {res['final_nll']:.9e}, grad inf-norm {res['grad_inf_norm']:.3e}",
        f"- wall time: {res['wall_s']:.1f} s for the resumed leg ({res['s_per_eval'] * 1e3:.2f} ms "
        f"an evaluation, {res['scalar_reads_per_eval']:.2f} scalar reads an evaluation, peak "
        f"device memory {res['peak_device_memory_gb'] or 0:.2f} GB); leg 1 {leg1_s:.1f} s; "
        f"{wall_total:.1f} s in all",
        f"- the objective twice at the final point: value bits equal "
        f"{res['bits_twice']['value_equal']}, gradient bits equal "
        f"{res['bits_twice']['grad_equal']} ({res['bits_twice']['grad_entries_differing']} "
        "entries differ)",
    ]
    if recorded:
        lines.append(f"- the JAX package's recorded run (validation/RESULTS_TRAINING.md): NLL "
                     f"{rec['nll']:.6e} at iteration {rec['iterations']} ({rec['fun_evals']} "
                     f"evaluations, {rec['termination']}); relative difference {rel:.3e}")
    print("\n".join(lines), flush=True)
    print(f"PART A {json.dumps(out)}", flush=True)
    return out


def part_b(n_quasars: int = 4096, budget: int = 400, dtype: str = "float64", seed: int = 9,
           device=None) -> dict:
    """The host and the device optimizer from one init on the same data."""
    from gp_dla_detection_tpu_torch.runtime import default_device

    device = default_device(device)
    params, data = make_training_data(n_quasars, seed)
    params = with_budget(params, budget)
    runs = {opt: fit(data, params, dtype, opt, device) for opt in ("device", "host")}
    for opt, run in runs.items():
        r = run["result"]
        print(f"{opt}: NLL {r.f:.8e} after {r.iterations} iters, {r.fun_evals} evaluations "
              f"({r.message}) in {run['wall_s']:.1f} s", flush=True)
    rd, rh = runs["device"]["result"], runs["host"]["result"]
    rel = abs(rd.f - rh.f) / abs(rh.f)
    both = rd.converged and rh.converged
    rec = RECORDED["part_b"]
    recorded = (n_quasars, budget, dtype) == (rec["n_quasars"], rec["budget"], rec["dtype"])
    vs_jax = ({opt: abs(run["result"].f - rec["nll"]) / abs(rec["nll"])
               for opt, run in runs.items()} if recorded else None)
    bits = same_bits_twice(data, params, rh.x, torch_dtype(dtype), device)
    fmt = lambda run: (f"{run['wall_s']:.1f} s, {run['s_per_eval'] * 1e3:.2f} ms an evaluation"
                       + (f", {run['scalar_reads_per_eval']:.2f} scalar reads an evaluation"
                          if run["scalar_reads_per_eval"] is not None else "")
                       + (f", peak device memory {run['peak_device_memory_gb']:.2f} GB"
                          if run["peak_device_memory_gb"] is not None else ""))
    lines = [
        f"## Part B: host and device optimizers (N = {n_quasars}, budget {budget}, {dtype}, "
        f"{device_label(device)})",
        "",
        f"- host (strong-Wolfe): NLL {rh.f:.10e}, {rh.iterations} iters, {rh.fun_evals} "
        f"evaluations, {fmt(runs['host'])} ({rh.message})",
        f"- device (on-card state): NLL {rd.f:.10e}, {rd.iterations} iters, {rd.fun_evals} "
        f"evaluations, {fmt(runs['device'])} ({rd.message})",
        f"- relative NLL difference: {rel:.3e} "
        + ("(both converged)" if both else "(budget-limited: trajectories compared "
           "mid-descent, not at the optimum)"),
        f"- the objective twice at the host's final point: value bits equal "
        f"{bits['value_equal']}, gradient bits equal {bits['grad_equal']} "
        f"({bits['grad_entries_differing']} entries differ)",
    ]
    if recorded:
        lines.append(f"- the JAX package's recorded NLL {rec['nll']:.8e} "
                     f"(validation/RESULTS_TRAINING.md): relative difference host "
                     f"{vs_jax['host']:.3e}, device {vs_jax['device']:.3e}")
    print("\n".join(lines), flush=True)
    out = {opt: {**summary(run), "device": device_label(device)} for opt, run in runs.items()}
    out.update(rel_diff=rel, both_converged=both, bits_twice=bits, n_quasars=n_quasars,
               budget=budget, dtype=dtype, jax_recorded_nll=rec["nll"] if recorded else None,
               rel_diff_vs_jax=vs_jax)
    print(f"PART B {json.dumps(out)}", flush=True)
    # the equivalence is of the CONVERGED optimum: other line-search
    # arithmetic takes other paths, so NLLs cut mid-descent agree loosely
    limit = CONVERGED_RTOL if both else TRAJECTORY_RTOL
    if not rel < limit:
        raise SystemExit(f"host and device NLLs differ by {rel:.3e} (limit {limit:.0e})")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cmd", nargs="?", default="part-a", choices=["part-a", "compare", "run-device"])
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--n-quasars", type=int, default=None,
                   help="default: 25000 for part-a and run-device, 4096 for compare")
    p.add_argument("--dtype", default=None,
                   help="default: float32 for part-a and run-device, float64 for compare "
                        "(the JAX harness's; its recorded runs are float64)")
    p.add_argument("--budget", type=int, default=None,
                   help="L-BFGS iterations (evaluations twice that); default: 400 for compare, "
                        "the reference's 2000 / 4000 for part-a and run-device")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the tests)")
    a = p.parse_args(argv)
    if a.cmd == "run-device":
        run_device(Path(a.workdir), a.n_quasars or 25000, a.dtype or "float32", seed=5,
                   device=a.device, budget=a.budget)
    elif a.cmd == "compare":
        part_b(a.n_quasars or 4096, a.budget or 400, a.dtype or "float64", device=a.device)
    else:
        part_a(Path(a.workdir), a.n_quasars or 25000, a.dtype or "float32", device=a.device,
               budget=a.budget)


if __name__ == "__main__":
    main()
