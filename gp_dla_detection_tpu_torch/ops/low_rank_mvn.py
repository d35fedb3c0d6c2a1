"""Masked low-rank multivariate-normal log-density (Woodbury/Cholesky).

Counterpart of ``gp_dla_detection_tpu/ops/low_rank_mvn.py``:

    log N(y; mu, M M' + diag(d))

by the Woodbury identity with a k x k Cholesky factorisation of
B = I + M' D^-1 M (log_mvnpdf_low_rank.m:5-33).  All functions take any
leading batch axes; the JAX package's vmap over spectra is a batch axis
here.  Float32 matrix products must run in full float32 on the card
(no TF32): :func:`full_fp32_matmul` sets that.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "LOG_2PI",
    "batched_dla_log_likelihoods",
    "batched_spd_quad_logdet",
    "full_fp32_matmul",
    "log_mvnpdf_low_rank",
    "pair_products",
    "woodbury_log_p",
]

LOG_2PI = 1.8378770664093454836  # log(2*pi)


def full_fp32_matmul() -> None:
    """Keep float32 matrix products in full float32 on the card.

    TF32 keeps about three decimal digits, far below what the evidence
    differences between samples need.  PyTorch's default is already
    False; this states it where the products run.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pair_products(M):
    """Upper-triangle pair products P[..., t] = M[..., i_t] * M[..., j_t].

    (..., n, k) -> (..., n, k*(k+1)/2).
    """
    k = M.shape[-1]
    iu, ju = np.triu_indices(k)
    return M[..., iu] * M[..., ju]


def _symmetrize_indices(k: int) -> np.ndarray:
    """Flat index map from packed upper triangle to full (k, k) matrix."""
    tri = np.zeros((k, k), dtype=np.int64)
    iu, ju = np.triu_indices(k)
    tri[iu, ju] = np.arange(iu.size)
    tri[ju, iu] = tri[iu, ju]
    return tri.reshape(-1)


def batched_spd_quad_logdet(B, b):
    """(b' B^-1 b, log det B) for batches of small SPD matrices.

    The unrolled lazy column-Crout Cholesky with fused forward
    substitution of the JAX package, in the same operation order as the
    CUDA evidence kernel.  B = I + M'D^-1 M has all eigenvalues >= 1,
    so no pivoting is needed.
    """
    k = B.shape[-1]
    cols: list = []   # computed Cholesky columns, each (..., k)
    ys: list = []     # forward-substitution solution components
    quad = torch.zeros(B.shape[:-2], dtype=B.dtype, device=B.device)
    logdet = torch.zeros(B.shape[:-2], dtype=B.dtype, device=B.device)
    for j in range(k):
        # lazy column update: c_j = B[:, j] - sum_{m<j} L_m * L_m[j]
        c = B[..., :, j]
        y_j = b[..., j]
        for m in range(j):
            c = c - cols[m] * cols[m][..., j, None]
            y_j = y_j - cols[m][..., j] * ys[m]
        djj = c[..., j]
        inv_sqrt = torch.rsqrt(djj)
        cols.append(c * inv_sqrt[..., None])
        y_j = y_j * inv_sqrt
        ys.append(y_j)
        quad = quad + y_j * y_j
        logdet = logdet + torch.log(djj)
    return quad, logdet


def woodbury_log_p(M, P, w, u, quad0, logdet_d, n_eff):
    """Batched Woodbury log-density core.

    Args:
      M: (..., n, k) low-rank factor (unscaled).
      P: (..., n, t) pair products of M (:func:`pair_products`).
      w: (..., S, n) per-sample diagonal weights a_s^2 / d_s (masked: 0).
      u: (..., S, n) per-sample rhs a_s * yc_s / d_s (masked: 0).
      quad0: (..., S) masked sum of yc^2 / d.
      logdet_d: (..., S) masked sum of log d.
      n_eff: (...,) or (..., S) number of unmasked pixels.

    Returns:
      (..., S) log N(y; mu_s, (M a_s)(M a_s)' + D_s).
    """
    k = M.shape[-1]
    b = torch.matmul(u, M)                       # (..., S, k)
    B_tri = torch.matmul(w, P)                   # (..., S, t)
    sym = torch.as_tensor(_symmetrize_indices(k), device=M.device)
    B = B_tri[..., sym].reshape(*B_tri.shape[:-1], k, k)
    B = B + torch.eye(k, dtype=M.dtype, device=M.device)

    bBb, logdet_B = batched_spd_quad_logdet(B, b)
    return -0.5 * (quad0 - bBb + logdet_d + logdet_B + n_eff * LOG_2PI)


def log_mvnpdf_low_rank(y, mu, M, d, mask=None):
    """log N(y; mu, M M' + diag(d)) with optional pixel mask.

    ``y``, ``mu``, ``d``, ``mask``: (..., n); ``M``: (..., n, k).
    Masked-out (False) pixels are excluded from the density exactly as
    the reference's index slicing excludes them.
    """
    dtype = y.dtype
    M = M.to(dtype)
    d = d.to(dtype)
    mu = mu.to(dtype)
    yc = y - mu
    if mask is None:
        valid = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    else:
        valid = mask.to(torch.bool)

    one = torch.ones((), dtype=dtype, device=y.device)
    zero = torch.zeros((), dtype=dtype, device=y.device)
    d_safe = torch.where(valid, d, one)
    inv_d = torch.where(valid, 1.0 / d_safe, zero)
    yc = torch.where(valid, yc, zero)

    u = yc * inv_d
    quad0 = torch.sum(yc * u, dim=-1)
    logdet_d = torch.sum(torch.where(valid, torch.log(d_safe), zero), dim=-1)
    n_eff = torch.sum(valid, dim=-1).to(dtype)

    # one weight vector per call: B = M' diag(w) M as a direct product
    k = M.shape[-1]
    B = torch.matmul(
        torch.transpose(M, -1, -2), M * inv_d[..., None]
    ) + torch.eye(k, dtype=dtype, device=y.device)
    b = torch.matmul(u[..., None, :], M)[..., 0, :]
    bBb, logdet_B = batched_spd_quad_logdet(B, b)
    return -0.5 * (quad0 - bBb + logdet_d + logdet_B + n_eff * LOG_2PI)


def batched_dla_log_likelihoods(y, mu, M, omega2, noise_variance, mask, absorption):
    """Per-sample DLA-model log likelihoods (process_qsos.m:184-198).

    For every sample s with absorption profile a_s:

        log N(y; mu * a_s, (M a_s)(M a_s)' + diag(omega2 a_s^2 + sigma^2))

    Args:
      y, mu, omega2, noise_variance: (..., n) padded spectrum tensors.
      M: (..., n, k) low-rank factor on the spectrum's grid.
      mask: (..., n) bool, True = valid pixel.
      absorption: (..., S, n) per-sample absorption profiles.

    Returns:
      (..., S) log likelihoods.
    """
    dtype = y.dtype
    a = absorption.to(dtype)
    valid = mask.to(torch.bool)[..., None, :]
    one = torch.ones((), dtype=dtype, device=y.device)
    zero = torch.zeros((), dtype=dtype, device=y.device)

    d = omega2[..., None, :] * a * a + noise_variance[..., None, :]
    d_safe = torch.where(valid, d, one)
    inv_d = torch.where(valid, 1.0 / d_safe, zero)

    yc = torch.where(valid, y[..., None, :] - mu[..., None, :] * a, zero)
    w = a * a * inv_d
    u = a * yc * inv_d
    quad0 = torch.sum(yc * yc * inv_d, dim=-1)
    logdet_d = torch.sum(torch.where(valid, torch.log(d_safe), zero), dim=-1)
    n_eff = torch.sum(mask.to(torch.bool), dim=-1).to(dtype)[..., None]

    P = pair_products(M)
    return woodbury_log_p(M, P, w, u, quad0, logdet_d, n_eff)
