"""Pairwise-complete PCA for the factor-loading initialization.

A copy of ``gp_dla_detection_tpu/ops/pca.py`` (numpy only; the JAX
package's ``ops`` cannot be imported without jax).

The reference initializes M with MATLAB ``pca(centered_rest_fluxes,
'numcomponents', k, 'rows', 'pairwise')`` (learn_qso_model.m:74-84):
PCA of data with missing values, where each covariance entry is
estimated from the rows where *both* variables are observed.  Host-side
numpy (float64) — this is a one-off initialization, not a hot path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pairwise_pca"]


def pairwise_pca(X: np.ndarray, k: int):
    """Top-k principal components of X (n_obs, n_var) with NaNs.

    Returns (coefficients (n_var, k), latent (k,)): unit-norm
    eigenvectors of the pairwise-complete covariance and their
    eigenvalues, eigenvalue-descending, with MATLAB's sign convention
    (largest-magnitude coefficient positive).
    """
    X = np.asarray(X, np.float64)
    valid = np.isfinite(X)
    Xz = np.where(valid, X, 0.0)

    # column means over observed entries (pca centers internally)
    counts = valid.sum(axis=0)
    means = Xz.sum(axis=0) / np.maximum(counts, 1)
    Xc = np.where(valid, X - means, 0.0)

    # pairwise-complete covariance: C_ij = sum_r x_ri x_rj / (n_ij - 1).
    # Reference quirk intentionally not replicated: MATLAB's
    # pca(...,'Rows','pairwise') yields NaN entries for variable pairs
    # with n_ij <= 1 observations, poisoning eigh; the clamped divisor
    # gives those pairs a finite (zero-cross) covariance instead.  Real
    # training grids (>= 200-pixel spectra) never hit n_ij <= 1.
    cross = Xc.T @ Xc
    n_pair = valid.astype(np.float64).T @ valid.astype(np.float64)
    cov = cross / np.maximum(n_pair - 1.0, 1.0)

    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1][:k]
    latent = eigvals[order]
    coeff = eigvecs[:, order]

    # MATLAB sign convention: flip so the max-|coeff| element is positive
    flip = coeff[np.argmax(np.abs(coeff), axis=0), np.arange(k)] < 0
    coeff[:, flip] *= -1.0
    return coeff, latent
