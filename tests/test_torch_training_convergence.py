"""scripts/torch_training_convergence.py against
validation/training_convergence.py, on the CPU at toy size, in float64.

The port's ``make_training_data`` gives the JAX harness's arrays bit for
bit; ``compare`` (part B) reaches the JAX ``part_b``'s host and device
NLLs within 1e-9; ``part-a``, run in processes where jax and the JAX
package cannot be imported, SIGKILLs a real worker after its first
optimizer checkpoint and resumes it, and the resumed run's final
parameters are bit for bit an uninterrupted worker's.
"""

import json

import numpy as np
import pytest
import torch

import gp_dla_detection_tpu.models.training as jax_training
from torch_harness_support import finish, jax_harness, marked_json, port_script, start_without_jax

torch.set_num_threads(1)

TC = port_script("torch_training_convergence")
TOY_N, TOY_BUDGET = 48, 15          # part B: 15 iterations of each optimizer
KILL_N, KILL_BUDGET = 48, 300       # part A: the checkpoint at 50, 250 iterations after it


@pytest.mark.parametrize("n,seed", [(64, 5), (37, 9)])
def test_make_training_data_equals_jax(n, seed):
    jparams, jdata = jax_harness("training_convergence")["make_training_data"](n, seed)
    params, data = TC["make_training_data"](n, seed)
    for name in ("centered_flux", "lya_1pzs", "noise_variance", "mask", "mu"):
        np.testing.assert_array_equal(getattr(data, name), getattr(jdata, name), strict=True)
    assert params.null_model.k == jparams.null_model.k == 20
    np.testing.assert_array_equal(params.null_model.rest_wavelengths(),
                                  jparams.null_model.rest_wavelengths())


def test_compare_matches_jax_part_b(monkeypatch, capsys):
    """Both optimizers' final NLLs against the JAX harness's ``part_b``
    on the same data and budget (its results kept from
    ``learn_gp_model``'s returns)."""
    kept = {}
    real = jax_training.learn_gp_model

    def keep(data, params=None, **kw):
        model, result = real(data, params=params, **kw)
        kept[kw["optimizer"]] = result
        return model, result

    monkeypatch.setattr(jax_training, "learn_gp_model", keep)
    jax_harness("training_convergence")["part_b"](TOY_N, TOY_BUDGET, "float64")
    ours = TC["part_b"](TOY_N, TOY_BUDGET, "float64", device="cpu")
    out = capsys.readouterr().out
    assert marked_json(out, "PART B")["n_quasars"] == TOY_N
    for opt in ("host", "device"):
        assert ours[opt]["iterations"] == kept[opt].iterations
        assert ours[opt]["fun_evals"] == kept[opt].fun_evals
        assert ours[opt]["final_nll"] == pytest.approx(float(kept[opt].f), rel=1e-9)
        assert ours[opt]["termination"] == kept[opt].message
    assert ours["bits_twice"]["value_equal"] and ours["bits_twice"]["grad_equal"]
    assert ours["rel_diff_vs_jax"] is None   # no record at this size


def test_part_a_kill_and_resume_is_bit_identical(tmp_path):
    """part-a kills a real worker after its checkpoint and resumes it;
    the final x, f and g are those of one uninterrupted worker."""
    toy = ["--n-quasars", str(KILL_N), "--budget", str(KILL_BUDGET), "--dtype", "float64",
           "--device", "cpu"]
    killed = start_without_jax(["scripts/torch_training_convergence.py", "part-a",
                                "--workdir", str(tmp_path / "a"), *toy],
                               tmp_path / "block")
    straight = start_without_jax(["scripts/torch_training_convergence.py", "run-device",
                                  "--workdir", str(tmp_path / "b"), *toy], tmp_path / "block")
    a = marked_json(finish(killed, timeout=300), "PART A")
    b = marked_json(finish(straight, timeout=300), "TRAINING COMPLETE")
    print(f"part-a's SIGKILL met a running worker: {a['kill_met_running_worker']}")
    assert a["killed"] and a["checkpoint_iteration_at_kill"] >= 50
    assert a["resumed_from_iteration"] >= 50 and b["resumed_from_iteration"] is None
    with np.load(tmp_path / "a" / "result.npz") as ra, np.load(tmp_path / "b" / "result.npz") as rb:
        for key in ("x", "f", "g"):
            np.testing.assert_array_equal(ra[key], rb[key], strict=True)
    assert (a["iterations"], a["fun_evals"]) == (b["iterations"], b["fun_evals"])
    assert json.loads((tmp_path / "a" / "result.json").read_text())["final_nll"] == a["final_nll"]


def test_without_a_card_the_default_run_raises(tmp_path):
    proc = start_without_jax(["scripts/torch_training_convergence.py", "compare",
                              "--n-quasars", "8", "--budget", "2"], tmp_path / "block")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "PART B" not in out and "no CUDA device" in err
