"""ASCII catalog output (generate_ascii_catalog.m).

Counterpart of ``gp_dla_detection_tpu/ascii_catalog.py``.  The
single-DLA writer, :func:`write_ascii_catalog`, is the JAX package's,
which is jax-free.  :func:`write_ascii_multi_results` is ported: the JAX
one imports the JAX package's ``alias_flag`` when it runs, whose import
chain reaches jax; this one uses the port's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gp_dla_detection_tpu.ascii_catalog import _three_digit_exponent, write_ascii_catalog

from .alias_flag import lyb_alias_suspect, map_pair_params

__all__ = ["write_ascii_catalog", "write_ascii_multi_results"]


def write_ascii_multi_results(
    output_dir: str | Path,
    test_set_name: str,
    catalog,
    samples,
    multi,
    test_mask,
) -> Path:
    """Write ``<set>_multi_results.dat`` — the {0, 1, 2}-DLA extension
    of the reference's results contract (generate_ascii_catalog.m:48-83
    has no multi-DLA analogue; column set documented here).

    Columns: thing_id, sdss_name, P(no DLA), P(1 DLA), P(2 DLAs),
    MAP multiplicity, MAP pair (z_1, log N_HI 1, z_2, log N_HI 2; the
    single-DLA MAP repeated with NaN second component when no valid
    pair exists), and ``lyb_alias_suspect`` — the deterministic
    Lyβ/Lyγ re-fit signature flag (alias_flag.py).  Flagged calls stay
    in the catalog: the flag marks suspicion, not exclusion.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    searched = np.flatnonzero(test_mask)
    z1, l1, z2, l2 = map_pair_params(
        multi, samples.offset_samples, samples.log_nhi_samples
    )
    suspect = lyb_alias_suspect(
        multi, samples.offset_samples, samples.log_nhi_samples
    )
    mult = np.argmax(multi.model_posteriors, axis=1)
    p = output_dir / f"{test_set_name}_multi_results.dat"
    with open(p, "w") as fid:
        for i, catalog_ind in enumerate(searched):
            name = catalog.sdss_names[catalog_ind]
            if isinstance(name, bytes):
                name = name.decode()
            fid.write(
                "%09i %-18s %s %s %s %i "
                "%06.4f %07.4f %06.4f %07.4f %i\n"
                % (
                    catalog.thing_ids[catalog_ind],
                    name.strip(),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 0]
                    ),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 1]
                    ),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 2]
                    ),
                    int(mult[i]),
                    z1[i], l1[i], z2[i], l2[i],
                    int(suspect[i]),
                )
            )
    return p
