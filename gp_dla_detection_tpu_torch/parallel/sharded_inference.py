"""Checkpoint fingerprints.

Counterpart of ``gp_dla_detection_tpu/parallel/sharded_inference.py``;
only :func:`run_fingerprint` is ported so far.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["run_fingerprint"]

# Hashed first, so that a checkpoint written by the JAX package never
# resumes into this one or the other way round: the two agree to float32
# rounding, not bit for bit.  Bump the version when the float32 numerics
# of a backend change.
PORT_TOKEN = "gp_dla_detection_tpu_torch|numerics:v1"


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float64))


def run_fingerprint(dtype, backend, params, model, offsets, nhis, extra=()):
    """Hash of everything that determines the checkpointed values: the
    port token, the run dtype, the backend ("torch" and "cuda" agree to
    float32 rounding, not bit for bit), the physical parameters, the
    model arrays, the QMC samples and any ``extra`` arrays.  Stored in a
    checkpoint manifest, so that a resume trusts only checkpoints whose
    numerics match."""
    h = hashlib.md5()
    h.update(f"{PORT_TOKEN}|{dtype}|{backend}".encode())
    h.update(params.to_json().encode())
    for a in (
        model.rest_wavelengths, model.mu, model.M, model.log_omega,
        [model.log_c_0, model.log_tau_0, model.log_beta],
        offsets, nhis, *extra,
    ):
        a = _host(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
