"""Learned low-rank GP null model of quasar emission.

Counterpart of ``gp_dla_detection_tpu/models/qso_model.py``: a mean
vector mu, low-rank factor M (rank k) and log pixel noise log_omega on
the fixed rest-frame grid, plus the three scalar Lyα-forest parameters
(learn_qso_model.m:113-123).  The arrays are torch tensors on one device
in one dtype; the artifact format on disk is the JAX package's npz, so
either package loads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops.interp import interp_stack_uniform
from ..runtime import default_device

__all__ = ["GPModel"]


def check_uniform_grid(rest_wavelengths: np.ndarray) -> None:
    """Reject a rest grid that is not uniformly spaced and increasing:
    inference interpolates the model with arithmetic (uniform-grid)
    bracketing.  The tolerance scales with the stored dtype's ulp at the
    grid magnitude, as in the JAX package."""
    stored = np.asarray(rest_wavelengths)
    grid = stored.astype(np.float64)
    if grid.ndim != 1 or grid.size < 2:
        raise ValueError("rest_wavelengths must be a 1-D grid")
    spacing = np.diff(grid)
    dx = (grid[-1] - grid[0]) / (grid.size - 1)
    eps = (
        np.finfo(stored.dtype).eps
        if np.issubdtype(stored.dtype, np.floating)
        else np.finfo(np.float64).eps
    )
    tol = max(1e-3 * abs(dx), 4.0 * eps * float(np.max(np.abs(grid))))
    if dx <= 0 or np.max(np.abs(spacing - dx)) > tol:
        raise ValueError(
            "rest_wavelengths must be uniformly spaced and increasing "
            "(the engine uses uniform-grid model interpolation; got "
            f"spacing range [{spacing.min():.6g}, {spacing.max():.6g}])"
        )


@dataclass(frozen=True)
class GPModel:
    """Trained null-model parameters on the rest-frame grid (tensors)."""

    rest_wavelengths: torch.Tensor  # (R,)
    mu: torch.Tensor                # (R,)
    M: torch.Tensor                 # (R, k)
    log_omega: torch.Tensor         # (R,)
    log_c_0: float
    log_tau_0: float
    log_beta: float
    metadata: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        check_uniform_grid(self.rest_wavelengths.detach().cpu().numpy())

    @classmethod
    def from_numpy(
        cls,
        rest_wavelengths,
        mu,
        M,
        log_omega,
        log_c_0,
        log_tau_0,
        log_beta,
        metadata: dict | None = None,
        *,
        device=None,
        dtype=torch.float32,
    ) -> "GPModel":
        """The port's model from the JAX ``GPModel``'s fields (numpy
        arrays and floats), on ``device`` (default: the CUDA device;
        raises without a card) in ``dtype``."""
        check_uniform_grid(rest_wavelengths)  # before any dtype cast
        device = default_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
        return cls(
            rest_wavelengths=t(rest_wavelengths),
            mu=t(mu),
            M=t(M),
            log_omega=t(log_omega),
            log_c_0=float(log_c_0),
            log_tau_0=float(log_tau_0),
            log_beta=float(log_beta),
            metadata=dict(metadata or {}),
        )

    def to(self, device=None, dtype=None) -> "GPModel":
        """This model with its tensors moved to ``device``/``dtype``."""
        move = lambda a: a.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self,
            rest_wavelengths=move(self.rest_wavelengths),
            mu=move(self.mu),
            M=move(self.M),
            log_omega=move(self.log_omega),
        )

    def evidence_args(self, device, dtype) -> tuple:
        """The model as the evidence functions take it: the grid, mu, M
        and log_omega on ``device`` in ``dtype``, then log_c_0, log_tau_0
        and log_beta."""
        move = lambda a: a.to(device=device, dtype=dtype)
        return (move(self.rest_wavelengths), move(self.mu), move(self.M),
                move(self.log_omega), self.log_c_0, self.log_tau_0, self.log_beta)

    @property
    def k(self) -> int:
        return self.M.shape[1]

    @property
    def c_0(self) -> float:
        return float(np.exp(self.log_c_0))

    @property
    def tau_0(self) -> float:
        return float(np.exp(self.log_tau_0))

    @property
    def beta(self) -> float:
        return float(np.exp(self.log_beta))

    def interpolate(self, rest_wavelengths):
        """(mu, M, log_omega) on a spectrum's rest grid (..., m), the
        three griddedInterpolants of process_qsos.m:65-71 + :138-143."""
        mu, log_omega, M = interp_stack_uniform(
            self.rest_wavelengths, (self.mu, self.log_omega, self.M),
            rest_wavelengths,
        )
        return mu, M, log_omega

    # --- stage artifact I/O: the JAX package's npz + JSON metadata ---

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        host = lambda a: a.detach().cpu().numpy().astype(np.float64)
        np.savez_compressed(
            path,
            rest_wavelengths=host(self.rest_wavelengths),
            mu=host(self.mu),
            M=host(self.M),
            log_omega=host(self.log_omega),
            log_c_0=self.log_c_0,
            log_tau_0=self.log_tau_0,
            log_beta=self.log_beta,
            metadata=json.dumps(self.metadata),
        )

    @classmethod
    def load(cls, path: str | Path, *, device=None, dtype=torch.float32) -> "GPModel":
        """The model artifact at ``path``, on ``device`` (default: the
        CUDA device) in ``dtype``."""
        with np.load(Path(path), allow_pickle=False) as f:
            return cls.from_numpy(
                rest_wavelengths=f["rest_wavelengths"],
                mu=f["mu"],
                M=f["M"],
                log_omega=f["log_omega"],
                log_c_0=float(f["log_c_0"]),
                log_tau_0=float(f["log_tau_0"]),
                log_beta=float(f["log_beta"]),
                metadata=json.loads(str(f["metadata"])),
                device=device,
                dtype=dtype,
            )
