"""Atomic data for the hydrogen Lyman series (31 transitions).

Counterpart of ``gp_dla_detection_tpu/ops/lyman_series.py``: the same
primary published atomic data (vacuum transition wavelengths, oscillator
strengths, damping rates; standard H I values, e.g. Morton 2003) and the
same derived Voigt-profile constants (voigt.c:136-151, 186):

    leading_constants[i] = pi e^2 f_i lambda_i / (m_e c)        [cm^2]
    gammas[i]            = Gamma_i lambda_i / (4 pi)            [cm/s]
    sigma                = sqrt(k_B T / m_p),  T = 10^4 K       [cm/s]

All units CGS.  Wavelengths are stored in cm.  The tables are copied,
not imported, because the JAX package's ``ops`` imports jax; a test
holds them equal to the JAX package's arrays.
"""

from __future__ import annotations

import numpy as np

NUM_LINES = 31

# CGS physical constants (voigt.c:22-28)
C_CGS = 2.99792458e10          # speed of light [cm/s]
K_B = 1.38064852e-16           # Boltzmann constant [erg/K]
M_P = 1.672621898e-24          # proton mass [g]
M_E = 9.10938356e-28           # electron mass [g]
E_CHARGE = 1.6021766208e-19 * C_CGS / 10.0  # elementary charge [statC]

GAS_TEMPERATURE = 1.0e4        # assumed constant [K] (voigt.c:137)

# Vacuum transition wavelengths of H I Lyman series, 1s -> np [cm]
TRANSITION_WAVELENGTHS = np.array([
    1.2156701e-05, 1.0257223e-05, 9.725368e-06, 9.497431e-06, 9.378035e-06,
    9.307483e-06, 9.262257e-06, 9.231504e-06, 9.209631e-06, 9.193514e-06,
    9.181294e-06, 9.171806e-06, 9.16429e-06, 9.15824e-06, 9.15329e-06,
    9.14919e-06, 9.14576e-06, 9.14286e-06, 9.14039e-06, 9.13826e-06,
    9.13641e-06, 9.13480e-06, 9.13339e-06, 9.13215e-06, 9.13104e-06,
    9.13006e-06, 9.12918e-06, 9.12839e-06, 9.12768e-06, 9.12703e-06,
    9.12645e-06,
])

# Oscillator strengths f_i [dimensionless]
OSCILLATOR_STRENGTHS = np.array([
    0.416400, 0.079120, 0.029000, 0.013940, 0.007799, 0.004814, 0.003183,
    0.002216, 0.001605, 0.00120, 0.000921, 0.0007226, 0.000577, 0.000469,
    0.000386, 0.000321, 0.000270, 0.000230, 0.000197, 0.000170, 0.000148,
    0.000129, 0.000114, 0.000101, 0.000089, 0.000080, 0.000071, 0.000064,
    0.000058, 0.000053, 0.000048,
])

# Spontaneous transition rates Gamma_i [1/s]
TRANSITION_RATES = np.array([
    6.265e+08, 1.897e+08, 8.127e+07, 4.204e+07, 2.450e+07, 1.236e+07,
    8.255e+06, 5.785e+06, 4.210e+06, 3.160e+06, 2.432e+06, 1.911e+06,
    1.529e+06, 1.243e+06, 1.024e+06, 8.533e+05, 7.186e+05, 6.109e+05,
    5.237e+05, 4.523e+05, 3.933e+05, 3.443e+05, 3.030e+05, 2.679e+05,
    2.382e+05, 2.127e+05, 1.907e+05, 1.716e+05, 1.550e+05, 1.405e+05,
    1.277e+05,
])

# Derived Voigt constants (voigt.c:148-220 document the same derivations)
LEADING_CONSTANTS = (
    np.pi * E_CHARGE**2 * OSCILLATOR_STRENGTHS * TRANSITION_WAVELENGTHS
    / (M_E * C_CGS)
)  # absorption cross-section leading factor [cm^2]

LORENTZIAN_WIDTHS = TRANSITION_RATES * TRANSITION_WAVELENGTHS / (4.0 * np.pi)
# Lorentzian HWHM in velocity units [cm/s]

DOPPLER_SIGMA = float(np.sqrt(K_B * GAS_TEMPERATURE / M_P))
# Gaussian width b/sqrt(2) = sqrt(k_B T / m_p) [cm/s] (voigt.c:139-146)
