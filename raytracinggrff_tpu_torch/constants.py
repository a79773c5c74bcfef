"""Physical constants and unit conversions (CGS unless noted).

The same numbers and conversions as raytracinggrff_tpu/constants.py; a test
holds the two copies equal. The copy exists because importing the JAX
package imports jax.
"""

import numpy as np

# --- Solar / geometric ---
R_SUN_CM = 6.957e10          # solar radius, cm
R_SUN_M = 6.957e8            # solar radius, m
AU_CM = 1.49599e13           # astronomical unit, cm

# --- Fundamental (CGS) ---
C_CGS = 2.998e10             # speed of light, cm/s
KB_CGS = 1.38065e-16         # Boltzmann constant, erg/K
E_ESU = 4.8032e-10           # electron charge, esu
M_E_G = 9.1094e-28           # electron mass, g
H_ERG_S = 6.6261e-27         # Planck constant, erg s

# Light speed in R_sun per second: the ray ODE uses positions in R_sun and
# time in seconds, with the reference's R_S = 6.96e10 cm (build_rays.py:29-32).
R_S_REF_CM = 6.96e10
C_R = C_CGS / R_S_REF_CM     # ~0.43075 R_sun / s

# --- Radio / plasma ---
SFU2CGS = 1e-19              # 1 SFU = 1e-19 erg/s/cm^2/Hz
FPE_COEF = 8.93e3            # f_pe [Hz] = FPE_COEF * sqrt(n_e [cm^-3])
FB_COEF = 2.7992e6           # f_B [Hz] = FB_COEF * B [G]

# --- Grid / geometry guards ---
R_MIN = 0.9999999            # minimum r (R_sun) for valid model interpolation
PHI0_OFFSET_DEFAULT = 0.0    # default longitude offset, deg

# --- MAS normalization units: code units -> physical ---
MAS_UNITS = {
    "rho": 1.0e8,            # -> cm^-3 (number density)
    "t": 2.807067e7,         # -> K
    "te": 2.807067e7,        # -> K
    "tp": 2.807067e7,        # -> K
    "br": 2.2068908,         # -> G
    "bt": 2.2068908,         # -> G
    "bp": 2.2068908,         # -> G
    "vr": 481.3711,          # -> km/s
    "vt": 481.3711,          # -> km/s
    "vp": 481.3711,          # -> km/s
    "p": 0.03875717,         # -> dyn/cm^2
    "jr": 2.267e4,           # -> statA/cm^2
    "jt": 2.267e4,
    "jp": 2.267e4,
}

# --- Ray sampling fill values outside the cube (gpu_raytrace.py:724-726) ---
FILL_NE = 0.0
FILL_TE = 1e4
FILL_B = 0.0


def freq_to_omega(freq_hz):
    """Angular frequency [rad/s] from frequency [Hz] (numpy in and out)."""
    return 2.0 * np.pi * freq_hz


def ne_to_omega_pe(ne_cm3):
    """Plasma angular frequency [rad/s] from electron density [cm^-3]
    (numpy in and out)."""
    return FPE_COEF * np.sqrt(ne_cm3) * 2.0 * np.pi
