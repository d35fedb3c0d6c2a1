"""Lyβ-alias suspect flag for 2-DLA catalog calls.

Counterpart of ``gp_dla_detection_tpu/alias_flag.py``, a copy that reads
the port's ``ops.lyman_series`` (the JAX package's ``ops`` imports jax).

Survey-scale forensics (validation/oversplit_forensics.py,
validation/RESULTS_SURVEY.md "Over-split forensics") established a
deterministic signature for the dominant false-double mode: the 2-DLA
model re-fits a strong absorber's own Lyβ (or Lyγ) trough as a weak
interloping Lyα.  The spurious component then sits

  - within ~500 km/s of the STRONGER component's higher-order alias
    velocity, (1 + z_weak) ≈ (λ_n / λ_Lyα)(1 + z_strong) for
    n ∈ {Lyβ, Lyγ}  (51.3% of the 162k survey's over-splits at Lyβ;
    median |Δv| to the nearest alias 251 km/s), and
  - at the column prior's low floor: median spurious log N_HI 20.06,
    90th percentile 20.23 — vs the survey's true doubles at ≥ 20.4.

This module turns that diagnosis into a catalog flag.  The flag is a
*suspicion* marker, not a verdict: a physical proximate absorber can
legitimately sit at an alias velocity, so flagged calls stay in the
catalog with the flag exposed (ASCII multi results + .mat export),
extending the reference's column contract
(generate_ascii_catalog.m:48-83).
"""

from __future__ import annotations

import numpy as np

from .ops.lyman_series import TRANSITION_WAVELENGTHS

__all__ = ["lyb_alias_suspect", "map_pair_params"]

C_KMS = 299792.458
# ln wavelength ratios of the Lyβ and Lyγ aliases to Lyα
_ALIAS_LOG_RATIOS = tuple(
    float(np.log(TRANSITION_WAVELENGTHS[n] / TRANSITION_WAVELENGTHS[0]))
    for n in (1, 2)
)


def map_pair_params(multi, offset_samples, log_nhi_samples):
    """MAP 2-DLA component parameters (z1, lnhi1, z2, lnhi2) per
    spectrum, from a MultiDLAResults (lean or full).

    Component 1 is the fresh-axis MAP sample, component 2 the resampled
    base absorber at that sample.  Rows with no valid pair return NaN.
    """
    single = multi.single
    offsets = np.asarray(offset_samples, np.float64)
    lnhis = np.asarray(log_nhi_samples, np.float64)
    if multi.map_sample_inds2 is not None:
        i1 = np.asarray(multi.map_sample_inds2, np.int64)
        i2 = np.asarray(multi.map_base_sample_inds, np.int64)
    else:
        # classic full-matrix result: argmax over valid pairs
        sll2 = multi.sample_log_likelihoods_dla2
        finite = np.isfinite(sll2)
        any_valid = finite.any(axis=1)
        i1 = np.where(
            any_valid,
            np.nanargmax(np.where(finite, sll2, -np.inf), axis=1),
            -1,
        )
        i2 = np.where(
            any_valid,
            np.take_along_axis(
                np.asarray(multi.base_sample_inds, np.int64),
                np.maximum(i1, 0)[:, None], axis=1,
            )[:, 0],
            -1,
        )
    valid = (i1 >= 0) & (i2 >= 0)
    safe1, safe2 = np.maximum(i1, 0), np.maximum(i2, 0)
    span = np.asarray(single.max_z_dlas) - np.asarray(single.min_z_dlas)
    z1 = np.asarray(single.min_z_dlas) + span * offsets[safe1]
    z2 = np.asarray(single.min_z_dlas) + span * offsets[safe2]
    nan = np.where(valid, 0.0, np.nan)
    return z1 + nan, lnhis[safe1] + nan, z2 + nan, lnhis[safe2] + nan


def lyb_alias_suspect(
    multi,
    offset_samples,
    log_nhi_samples,
    dv_max_kms: float = 500.0,
    lnhi_floor_max: float = 20.3,
) -> np.ndarray:
    """Per-spectrum boolean: the MAP 2-DLA call matches the Lyβ/Lyγ
    re-fit signature.

    True when BOTH hold for the MAP pair (regardless of the model
    posterior — callers typically AND it with multiplicity == 2):

      1. the weaker component's log N_HI ≤ ``lnhi_floor_max`` (the
         forensics' spurious population: median 20.06, 90th pct 20.23);
      2. the weaker component sits within ``dv_max_kms`` of the
         stronger component's Lyβ or Lyγ alias velocity.

    Thresholds are the forensics-tuned defaults; both are exposed for
    sensitivity analysis.  Rows with no valid MAP pair return False.
    """
    z1, l1, z2, l2 = map_pair_params(multi, offset_samples, log_nhi_samples)
    first_stronger = l1 >= l2
    z_s = np.where(first_stronger, z1, z2)
    z_w = np.where(first_stronger, z2, z1)
    l_w = np.where(first_stronger, l2, l1)
    with np.errstate(invalid="ignore"):
        dlog = np.log1p(z_w) - np.log1p(z_s)
        dv = np.min(
            [C_KMS * np.abs(dlog - r) for r in _ALIAS_LOG_RATIOS], axis=0
        )
        out = (l_w <= lnhi_floor_max) & (dv < dv_max_kms)
    return np.where(np.isfinite(dv), out, False)
