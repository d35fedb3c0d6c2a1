"""A run's comparison comes out false when the timed path is broken
underneath: the harness's look for a chip skipped, a whole run driven at
a size the CPU holds, once for each fault the cells can have.  (The
exchange between chips does not exist on one chip.)"""

import numpy as np
import pytest
import torch

from gpbench import harness
from gpbench.tests import _tiny

CELLS = ["multi_b1024", "single_b1024", "multi_calls128"]
MULTI = ["multi_b1024", "multi_calls128"]


@pytest.fixture(autouse=True)
def _no_jax_look(monkeypatch):
    # the test process may hold a pytest plugin's jax; run.py's look is
    # tested on its own
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, checks = _tiny.run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


def _perturbed(fn):
    """``batch_log_likelihoods`` whose sample log likelihoods come out
    altered where they are produced: every other sample moved 0.5 nats."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sll = out["sample_log_likelihoods_dla"]
        bump = 0.5 * (torch.arange(sll.shape[1], device=sll.device) % 2).to(sll.dtype)
        out["sample_log_likelihoods_dla"] = sll + bump
        return out
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from gp_dla_detection_tpu_torch.parallel import sharded_inference, sharded_multi

    for mod in (sharded_inference, sharded_multi):
        monkeypatch.setattr(mod, "batch_log_likelihoods", _perturbed(mod.batch_log_likelihoods))
    result, checks = _tiny.run(cell)
    assert not result["correct"], checks


def _pairs_moved(fn):
    """The pair stage's log likelihoods altered where they are produced:
    every other pair column moved 0.5 nats."""
    def wrapped(*args, **kwargs):
        ll2 = fn(*args, **kwargs)
        return ll2 + 0.5 * (torch.arange(ll2.shape[1], device=ll2.device) % 2).to(ll2.dtype)
    return wrapped


def _pairs_nan(fn):
    """The pair stage returning NaN for every pair."""
    def wrapped(*args, **kwargs):
        return torch.full_like(fn(*args, **kwargs), float("nan"))
    return wrapped


@pytest.mark.parametrize("cell", MULTI)
@pytest.mark.parametrize("fault", [_pairs_moved, _pairs_nan])
def test_a_pair_answer_altered_where_it_is_produced(cell, fault, monkeypatch):
    from gp_dla_detection_tpu_torch.parallel import sharded_multi

    monkeypatch.setattr(sharded_multi, "batch_dla2_log_likelihoods",
                        fault(sharded_multi.batch_dla2_log_likelihoods))
    result, checks = _tiny.run(cell)
    assert not result["correct"], checks
    if fault is _pairs_moved:
        # the single stage is untouched: a pair-stage number fails
        failing = {c["name"] for c in checks if c["value"] > c["limit"]}
        assert failing and all(n.startswith(("shape2", "hist_c6", "hist_c7", "pair_"))
                               for n in failing), checks


def _half_batch(call):
    """Half of each call's spectra left out: the other half's answers
    stand in for them."""
    def wrapped(run, rows, ckpt):
        half = max(len(rows) // 2, 1)
        out = call(run, rows[:half], ckpt)
        take = np.arange(len(rows)) % half
        return {k: np.asarray(v)[take] for k, v in out.items()}
    return wrapped


def _unchanged(call):
    """A step that returns its state unchanged: every call hands back the
    first call's answers (the warm-up's, whose spectra differ)."""
    first = {}

    def wrapped(run, rows, ckpt):
        if not first:
            first.update(call(run, rows, ckpt))
        n = len(next(iter(first.values())))
        return {k: np.asarray(v)[np.arange(len(rows)) % n] for k, v in first.items()}
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _unchanged])
def test_a_broken_call_is_not_correct(cell, fault):
    # the warm-up takes the first batch x depth = 4 of the 8 spectra
    result, checks = _tiny.run(cell, call_hook=fault, pool_size=8,
                               driver={"per_device_batch": 2, "pipeline_depth": 2})
    assert not result["correct"], checks
