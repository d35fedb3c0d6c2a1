"""The whole Lyman series for the plain reference: the 31 transitions of
voigt.c's tables (sbird/gp_dla_detection, voigt.c:31-220; its
``num_lines`` defaults to all 31, voigt.c:266), as the port states them.

``physics`` holds the first three members, which is what Garnett et al.
2017 use (set_parameters.m:63: ``num_lines = 3``).  :func:`install`
widens ``physics``'s tables to the whole series in place of them; their
first three entries stay the same numbers bit for bit, so a
configuration of 3 lines reads exactly what it read before, and one of
up to 31 lines reads the rest.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from . import physics

# vacuum wavelengths of H I 1s -> np [cm]
TRANSITION_WAVELENGTHS = np.array([
    1.2156701e-05, 1.0257223e-05, 9.725368e-06, 9.497431e-06, 9.378035e-06,
    9.307483e-06, 9.262257e-06, 9.231504e-06, 9.209631e-06, 9.193514e-06,
    9.181294e-06, 9.171806e-06, 9.16429e-06, 9.15824e-06, 9.15329e-06,
    9.14919e-06, 9.14576e-06, 9.14286e-06, 9.14039e-06, 9.13826e-06,
    9.13641e-06, 9.13480e-06, 9.13339e-06, 9.13215e-06, 9.13104e-06,
    9.13006e-06, 9.12918e-06, 9.12839e-06, 9.12768e-06, 9.12703e-06,
    9.12645e-06,
])

# oscillator strengths
OSCILLATOR_STRENGTHS = np.array([
    0.416400, 0.079120, 0.029000, 0.013940, 0.007799, 0.004814, 0.003183,
    0.002216, 0.001605, 0.00120, 0.000921, 0.0007226, 0.000577, 0.000469,
    0.000386, 0.000321, 0.000270, 0.000230, 0.000197, 0.000170, 0.000148,
    0.000129, 0.000114, 0.000101, 0.000089, 0.000080, 0.000071, 0.000064,
    0.000058, 0.000053, 0.000048,
])

# transition rates [1/s]
TRANSITION_RATES = np.array([
    6.265e+08, 1.897e+08, 8.127e+07, 4.204e+07, 2.450e+07, 1.236e+07,
    8.255e+06, 5.785e+06, 4.210e+06, 3.160e+06, 2.432e+06, 1.911e+06,
    1.529e+06, 1.243e+06, 1.024e+06, 8.533e+05, 7.186e+05, 6.109e+05,
    5.237e+05, 4.523e+05, 3.933e+05, 3.443e+05, 3.030e+05, 2.679e+05,
    2.382e+05, 2.127e+05, 1.907e+05, 1.716e+05, 1.550e+05, 1.405e+05,
    1.277e+05,
])

NUM_LINES = len(TRANSITION_WAVELENGTHS)

# the same derivations as physics's (voigt.c:148-220), elementwise, so the
# first three entries are physics's to the bit
LEADING_CONSTANTS = (
    np.pi * physics.E_CHARGE**2 * OSCILLATOR_STRENGTHS * TRANSITION_WAVELENGTHS
    / (physics.M_E * physics.C_CGS)
)
LORENTZIAN_WIDTHS = TRANSITION_RATES * TRANSITION_WAVELENGTHS / (4.0 * np.pi)

_TABLES = ("TRANSITION_WAVELENGTHS", "OSCILLATOR_STRENGTHS", "TRANSITION_RATES",
           "LEADING_CONSTANTS", "LORENTZIAN_WIDTHS")


def install() -> None:
    """Widen ``physics``'s line tables to the whole series.  Raises if
    their first entries are not the series' own, bit for bit."""
    for name in _TABLES:
        have, whole = getattr(physics, name), globals()[name]
        if not np.array_equal(have, whole[: len(have)]):
            raise ValueError(f"physics.{name} is not the head of the Lyman series' {name}")
    for name in _TABLES:
        setattr(physics, name, globals()[name])
