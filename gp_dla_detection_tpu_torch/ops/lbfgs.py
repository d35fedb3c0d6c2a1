"""L-BFGS with strong-Wolfe line search (minFunc replacement).

A copy of ``gp_dla_detection_tpu/ops/lbfgs.py`` (numpy only; the JAX
package's ``ops`` cannot be imported without jax), with one addition:
``write_checkpoints``.  The reference trains
its GP with Mark Schmidt's minFunc MATLAB toolbox
(learn_qso_model.m:100-101); this is a host-side two-loop-recursion
L-BFGS driving a value_and_grad callable that runs on the device.

Termination criteria mirror minFunc's defaults: optimality tolerance on
the gradient infinity norm (optTol 1e-5), progress tolerance on step /
function change (progTol 1e-9), MaxIter, and MaxFunEvals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LBFGSResult", "minimize_lbfgs"]


@dataclass
class LBFGSResult:
    x: np.ndarray
    f: float
    g: np.ndarray
    iterations: int
    fun_evals: int
    message: str

    @property
    def converged(self) -> bool:
        return self.message in ("optTol", "progTol_step", "progTol_f")


def _strong_wolfe(fg, x, f0, g0, p, t0, c1, c2, max_evals):
    """Strong-Wolfe line search: bracket + zoom with cubic/bisection steps.

    Returns (t, f_t, g_t, evals).
    """
    d0 = float(np.dot(g0, p))
    # the caller guarantees a descent direction (steepest-descent reset
    # + non-finite termination in minimize_lbfgs)
    assert d0 < 0, "search direction must be a descent direction"

    def phi(t):
        f, g = fg(x + t * p)
        return float(f), g, float(np.dot(g, p))

    t_prev, f_prev, d_prev = 0.0, f0, d0
    g_prev = g0
    t = t0
    evals = 0
    bracket = None
    max_t = 1e10

    for _ in range(12):
        f_t, g_t, d_t = phi(t)
        evals += 1
        if not np.isfinite(f_t):
            bracket = (t_prev, f_prev, g_prev, d_prev, t, f_t, g_t, d_t)
            break
        if f_t > f0 + c1 * t * d0 or (evals > 1 and f_t >= f_prev):
            bracket = (t_prev, f_prev, g_prev, d_prev, t, f_t, g_t, d_t)
            break
        if abs(d_t) <= -c2 * d0:
            return t, f_t, g_t, evals
        if d_t >= 0:
            bracket = (t, f_t, g_t, d_t, t_prev, f_prev, g_prev, d_prev)
            break
        t_prev, f_prev, g_prev, d_prev = t, f_t, g_t, d_t
        t = min(2.0 * t, max_t)
        if evals >= max_evals:
            return t_prev, f_prev, g_prev, evals
    else:
        # bracketing exhausted without a bracket (nearly-linear descent):
        # accept the best point found rather than crashing
        return t_prev, f_prev, g_prev, evals

    # zoom phase
    lo_t, lo_f, lo_g, lo_d, hi_t, hi_f, hi_g, hi_d = bracket
    for _ in range(20):
        if evals >= max_evals:
            break
        # cubic-style interpolation guarded toward bisection
        if np.isfinite(hi_f):
            denom = hi_f - lo_f - lo_d * (hi_t - lo_t)
            if abs(denom) > 1e-300:
                t = lo_t - 0.5 * lo_d * (hi_t - lo_t) ** 2 / denom
            else:
                t = 0.5 * (lo_t + hi_t)
        else:
            t = 0.5 * (lo_t + hi_t)
        lo, hi = min(lo_t, hi_t), max(lo_t, hi_t)
        span = hi - lo
        if not np.isfinite(t) or t <= lo + 0.1 * span or t >= hi - 0.1 * span:
            t = 0.5 * (lo_t + hi_t)

        f_t, g_t, d_t = phi(t)
        evals += 1
        if not np.isfinite(f_t) or f_t > f0 + c1 * t * d0 or f_t >= lo_f:
            hi_t, hi_f, hi_g, hi_d = t, f_t, g_t, d_t
        else:
            if abs(d_t) <= -c2 * d0:
                return t, f_t, g_t, evals
            if d_t * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g, hi_d = lo_t, lo_f, lo_g, lo_d
            lo_t, lo_f, lo_g, lo_d = t, f_t, g_t, d_t
        if abs(hi_t - lo_t) * max(abs(lo_d), 1.0) < 1e-12:
            break
    return lo_t, lo_f, lo_g, evals


def minimize_lbfgs(
    value_and_grad_fn,
    x0,
    max_iterations: int = 2000,
    max_fun_evals: int = 4000,
    history: int = 10,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 50,
    write_checkpoints: bool = True,
) -> LBFGSResult:
    """Minimize f(x) with L-BFGS.

    value_and_grad_fn: x (np.float64 (n,)) -> (f, g); typically wraps a
    torch autograd evaluation (arrays converted at the boundary).

    checkpoint_path: optional .npz path; the optimizer state (iterate +
    curvature history + counters) is saved every ``checkpoint_every``
    iterations and restored automatically when the file exists — the
    reference has no intra-training checkpointing at all (a crash loses
    the whole minFunc run, learn_qso_model.m:100).
    ``write_checkpoints=False`` resumes from ``checkpoint_path`` without
    writing it (the non-coordinator ranks of a data-parallel run).
    """

    def fg(x):
        f, g = value_and_grad_fn(x)
        return float(f), np.asarray(g, np.float64)

    x = np.asarray(x0, np.float64).copy()
    s_hist: list[np.ndarray] = []
    y_hist: list[np.ndarray] = []
    rho_hist: list[float] = []
    start_iter = 0
    evals = 0
    message = "MaxIter"

    from pathlib import Path

    if checkpoint_path is not None and Path(checkpoint_path).exists():
        with np.load(checkpoint_path) as ck:
            # "iteration" distinguishes this host-loop format from the
            # device-resident optimizer's state file (lbfgs_device.py)
            if "iteration" in ck and ck["x"].shape == x.shape:
                x = ck["x"]
                start_iter = int(ck["iteration"])
                evals = int(ck["fun_evals"])
                n_hist = int(ck["n_hist"])
                s_hist = [ck[f"s{i}"] for i in range(n_hist)]
                y_hist = [ck[f"y{i}"] for i in range(n_hist)]
                rho_hist = list(ck["rho"][:n_hist])
                # a checkpoint from a larger-history run: keep the most
                # recent `history` pairs — exactly the state a history-
                # sized run would hold (the device optimizer's fixed
                # shapes force it to reject instead, lbfgs_device.py)
                while len(s_hist) > history:
                    s_hist.pop(0), y_hist.pop(0), rho_hist.pop(0)

    def save_checkpoint(it):
        if checkpoint_path is None or not write_checkpoints:
            return
        payload = {
            "x": x,
            "iteration": it,
            "fun_evals": evals,
            "n_hist": len(s_hist),
            "rho": np.asarray(rho_hist),
        }
        for i, (s, yv) in enumerate(zip(s_hist, y_hist)):
            payload[f"s{i}"] = s
            payload[f"y{i}"] = yv
        tmp = str(checkpoint_path) + ".tmp.npz"
        np.savez(tmp, **payload)
        Path(tmp).replace(checkpoint_path)

    f, g = fg(x)
    evals += 1

    for it in range(start_iter, max_iterations):
        if checkpoint_path is not None and it > start_iter and (
            it % checkpoint_every == 0
        ):
            save_checkpoint(it)
        gnorm = np.max(np.abs(g))
        if not (np.isfinite(f) and np.isfinite(gnorm)):
            # a NaN/inf value or gradient (exp overflow on bad data)
            # would otherwise sail through every comparison below and
            # die in the line search's descent assertion — terminate
            # with a status instead, like the device optimizer's
            # isfinite line-search guard (lbfgs_device.py)
            message = "NonFinite"
            break
        if gnorm <= opt_tol:
            message = "optTol"
            break
        if evals >= max_fun_evals:
            message = "MaxFunEvals"
            break

        # two-loop recursion
        q = -g.copy()
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
            a = rho * np.dot(s, q)
            alphas.append(a)
            q -= a * y
        if y_hist:
            gamma = np.dot(s_hist[-1], y_hist[-1]) / np.dot(y_hist[-1], y_hist[-1])
            q *= gamma
        for (s, y, rho), a in zip(
            zip(s_hist, y_hist, rho_hist), reversed(alphas)
        ):
            b = rho * np.dot(y, q)
            q += (a - b) * s

        p = q
        d0 = float(np.dot(g, p))
        if not (d0 < 0):  # safeguard (also catches NaN): steepest descent
            p = -g
            d0 = float(np.dot(g, p))
            s_hist.clear(), y_hist.clear(), rho_hist.clear()
            if not (d0 < 0):
                # -|g|^2 can only fail to be negative through a
                # non-finite intermediate; g itself was finite above
                message = "NonFinite"
                break

        t0 = 1.0 if y_hist else min(1.0, 1.0 / np.sum(np.abs(g)))
        t, f_new, g_new, ls_evals = _strong_wolfe(
            fg, x, f, g, p, t0, c1, c2, max_fun_evals - evals
        )
        evals += ls_evals

        step = t * p
        x_new = x + step
        if t == 0.0:
            # a search stopped by the eval budget is not a line-search
            # FAILURE (same classification as lbfgs_device.py) — report
            # the budget stop so training logs show the true reason
            message = (
                "MaxFunEvals" if evals >= max_fun_evals
                else "LineSearchFailed"
            )
            break
        if np.max(np.abs(step)) <= prog_tol:
            x, f, g = x_new, f_new, g_new
            message = "progTol_step"
            break
        if abs(f - f_new) < prog_tol:
            x, f, g = x_new, f_new, g_new
            message = "progTol_f"
            break

        y_vec = g_new - g
        ys = float(np.dot(y_vec, step))
        if ys > 1e-10:
            s_hist.append(step)
            y_hist.append(y_vec)
            rho_hist.append(1.0 / ys)
            if len(s_hist) > history:
                s_hist.pop(0), y_hist.pop(0), rho_hist.pop(0)

        x, f, g = x_new, f_new, g_new
        if callback is not None:
            callback(it, x, f, g)
    else:
        it = max_iterations - 1

    return LBFGSResult(
        x=x, f=f, g=g, iterations=it + 1, fun_evals=evals, message=message
    )
