"""Device-resident L-BFGS: the optimizer state stays on the device.

Counterpart of ``gp_dla_detection_tpu/ops/lbfgs_device.py``.  The host
two-loop L-BFGS (:mod:`lbfgs`) brings the value and the whole gradient
to the host at every evaluation.  This variant keeps x, g and the
curvature history (S, Y, rho) on the device and runs the JAX package's
algorithm step for step: the two-loop recursion over fixed circular
(m, n) buffers in which empty slots carry rho = 0, a backtracking-Armijo
line search with ``c1`` and ``max_ls``, curvature pairs stored only
when y's > 1e-10, the same termination tests, status codes and messages.

PyTorch runs eagerly, so the loop is a host loop that issues device
work; it reads only scalars from the device: per line-search trial the
Armijo decision (one evaluation per trial, counted as ``fun_evals``),
and per iteration the termination tests.  ``host_syncs`` counts those
reads.  The iterate reaches the host only between segments, for the
callback and the checkpoint (the JAX package's keys, so either
package's state file resumes in the other).

As in the JAX package the line search does not enforce the curvature
condition (the host optimizer's strong-Wolfe search does); storing
pairs only when y's > 1e-10 keeps the inverse-Hessian approximation
positive definite.  One deliberate difference: a non-finite gradient
ends the run with the host optimizer's "NonFinite" (the JAX package's
loop never returns then).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .lbfgs import LBFGSResult

__all__ = ["minimize_lbfgs_device", "host_syncs"]

_RUNNING, _OPT_TOL, _PROG_STEP, _PROG_F, _LS_FAILED = 0, 1, 2, 3, 4
_MESSAGES = {
    _RUNNING: "MaxIter",
    _OPT_TOL: "optTol",
    _PROG_STEP: "progTol_step",
    _PROG_F: "progTol_f",
    _LS_FAILED: "LineSearchFailed",
}
_STATE_KEYS = ("x", "f", "g", "S", "Y", "rho", "count", "it", "evals", "status")

host_syncs = 0   # scalar reads from the device (each a synchronization)


def _read(*scalars) -> list:
    """The values of 0-d device tensors, in one transfer."""
    global host_syncs
    host_syncs += 1
    return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


def _two_loop(g, S, Y, rho, count: int):
    """H·(-g) via the two-loop recursion over circular buffers.

    Slots with rho == 0 (never filled, or cleared on reset) contribute
    exactly zero in both passes, so no validity masks are needed."""
    m = rho.shape[0]
    q = -g
    alphas = []
    for i in range(m):
        idx = (count - 1 - i) % m
        a = rho[idx] * torch.dot(S[idx], q)
        q = q - a * Y[idx]
        alphas.append(a)
    last = (count - 1) % m
    ynorm2 = torch.dot(Y[last], Y[last])
    if count > 0:
        q = q * (torch.dot(S[last], Y[last]) / torch.where(ynorm2 > 0.0, ynorm2, 1.0))
    for j in range(m):
        i = m - 1 - j
        idx = (count - 1 - i) % m
        b = rho[idx] * torch.dot(Y[idx], q)
        q = q + (alphas[i] - b) * S[idx]
    return q


def minimize_lbfgs_device(
    value_and_grad_fn,
    x0,
    *args,
    max_iterations: int = 2000,
    max_fun_evals: int = 4000,
    history: int = 10,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    max_ls: int = 25,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 50,
    segment: int | None = None,
    write_checkpoints: bool = True,
) -> LBFGSResult:
    """Device-resident counterpart of :func:`lbfgs.minimize_lbfgs`.

    ``value_and_grad_fn(x, *args) -> (f, g)``: a 0-d tensor and a tensor
    like ``x``, on x's device; ``x0`` is a tensor (its device and dtype
    are the run's) or an array (then the CPU, float64).  The loop runs
    in segments of ``segment`` iterations (default: checkpoint_every
    when checkpointing or a callback is set, else the full budget);
    between segments the callback gets host copies and the state is
    checkpointed.  ``write_checkpoints=False`` resumes from
    ``checkpoint_path`` without writing it (the non-coordinator ranks of
    a data-parallel run).
    """
    if segment is None:
        segment = (
            checkpoint_every
            if (checkpoint_path is not None or callback is not None)
            else max_iterations
        )
    x0 = torch.as_tensor(x0)
    dtype, device = x0.dtype, x0.device
    m = history

    def fg(x):
        f, g = value_and_grad_fn(x, *args)
        return f.detach(), g.detach()

    state = None
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        with np.load(checkpoint_path) as ck:
            if "S" in ck and ck["x"].shape == tuple(x0.shape) and ck["S"].shape[0] == history:
                state = {k: ck[k] for k in _STATE_KEYS}
    if state is None:
        f0, g0 = fg(x0)
        x, f, g = x0, f0, g0
        S = torch.zeros((m,) + tuple(x0.shape), dtype=dtype, device=device)
        Y = torch.zeros_like(S)
        rho = torch.zeros((m,), dtype=dtype, device=device)
        count, it, evals, status = 0, 0, 1, _RUNNING
    else:
        put = lambda k: torch.as_tensor(state[k], device=device).to(dtype)
        x, f, g, S, Y, rho = (put(k) for k in ("x", "f", "g", "S", "Y", "rho"))
        count, it, evals, status = (int(state[k]) for k in ("count", "it", "evals", "status"))

    def save_checkpoint():
        if checkpoint_path is None or not write_checkpoints:
            return
        host = lambda t: t.detach().cpu().numpy()
        payload = {
            "x": host(x), "f": host(f), "g": host(g), "S": host(S), "Y": host(Y),
            "rho": host(rho), "count": np.int32(count), "it": np.int32(it),
            "evals": np.int32(evals), "status": np.int32(status),
        }
        tmp = str(checkpoint_path) + ".tmp.npz"
        np.savez(tmp, **payload)
        Path(tmp).replace(checkpoint_path)

    # the gradient test of the loop condition, in the run dtype
    (g_large,) = _read(torch.max(torch.abs(g)) > opt_tol)
    while not (status != _RUNNING or it >= max_iterations or evals >= max_fun_evals or not g_large):
        target = min(it + segment, max_iterations)
        while status == _RUNNING and it < target and evals < max_fun_evals and g_large:
            p = _two_loop(g, S, Y, rho, count)
            d0 = torch.dot(g, p)
            # safeguard: non-descent direction -> steepest descent + reset
            bad = d0 >= 0.0
            p = torch.where(bad, -g, p)
            d0 = torch.where(bad, -torch.dot(g, g), d0)
            rho = torch.where(bad, torch.zeros_like(rho), rho)
            fresh = bad | (count == 0)
            t = torch.where(
                fresh, torch.clamp(1.0 / torch.sum(torch.abs(g)), max=1.0), torch.ones_like(d0)
            ).to(dtype)

            accepted, ls_evals, first = False, 0, True
            f_t, g_t = f, g
            while not accepted and ls_evals < max_ls and evals + ls_evals < max_fun_evals:
                f_t, g_t = fg(x + t * p)
                ls_evals += 1
                ok = torch.isfinite(f_t) & (f_t <= f + c1 * t * d0)
                if first:
                    ok_v, bad_v = _read(ok, bad)
                    if bad_v:
                        count = 0
                    first = False
                else:
                    (ok_v,) = _read(ok)
                accepted = bool(ok_v)
                if not accepted:
                    t = 0.5 * t
            if first:
                # no trial ran: the search was stopped by the budget
                if _read(bad)[0]:
                    count = 0

            step = t * p
            f_old = f
            y_vec = g_t - g
            ys = torch.dot(y_vec, step)
            if accepted:
                x, f, g = x + step, f_t, g_t
            small_step, small_f, store_v, g_big = _read(
                torch.max(torch.abs(step)) <= prog_tol,
                torch.abs(f_old - f) < prog_tol,
                ys > 1e-10,
                torch.max(torch.abs(g)) > opt_tol,
            )
            g_large = bool(g_big)
            if accepted and store_v:
                idx = count % m
                S[idx] = step
                Y[idx] = y_vec
                rho[idx] = 1.0 / ys
                count += 1

            # a search stopped by the eval budget is not a line-search
            # FAILURE: status stays _RUNNING so the driver terminates
            # with the MaxFunEvals message instead
            budget_stop = not accepted and evals + ls_evals >= max_fun_evals
            if budget_stop:
                status = _RUNNING
            elif not accepted:
                status = _LS_FAILED
            elif small_step:
                status = _PROG_STEP
            elif small_f:
                status = _PROG_F
            else:
                status = _RUNNING
            it += 1
            evals += ls_evals
        if callback is not None:
            callback(it - 1, x.cpu().numpy(), float(f), g.cpu().numpy())
        save_checkpoint()

    g_host = g.detach().cpu().numpy().astype(np.float64)
    if status != _RUNNING:
        message = _MESSAGES[status]
    elif not np.isfinite(g_host).all():
        # the host optimizer's message; the JAX package's device loop
        # never returns here (its host test max|g| <= opt_tol is False
        # for NaN while its device loop refuses to step)
        message = "NonFinite"
    elif np.max(np.abs(g_host)) <= opt_tol:
        message = "optTol"
    elif evals >= max_fun_evals:
        message = "MaxFunEvals"
    else:
        message = "MaxIter"
    return LBFGSResult(
        x=x.detach().cpu().numpy().astype(np.float64),
        f=float(f),
        g=g_host,
        iterations=it,
        fun_evals=evals,
        message=message,
    )
