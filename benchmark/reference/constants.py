"""Physical constants and unit conversions (CGS unless noted): a frozen
copy of the numbers in raytracinggrff_tpu_torch/constants.py and
grff/physics.py that the reference uses."""

import math

R_SUN_CM = 6.957e10          # solar radius, cm
R_SUN_M = 6.957e8            # solar radius, m
AU_CM = 1.49599e13           # astronomical unit, cm
C_CGS = 2.998e10             # speed of light, cm/s
KB_CGS = 1.38065e-16         # Boltzmann constant, erg/K
M_E_G = 9.1094e-28           # electron mass, g
# light speed in R_sun per second, with the reference's R_S = 6.96e10 cm
C_R = C_CGS / 6.96e10
SFU2CGS = 1e-19              # 1 SFU = 1e-19 erg/s/cm^2/Hz
FPE_COEF = 8.93e3            # f_pe [Hz] = FPE_COEF * sqrt(n_e [cm^-3])
FB_COEF = 2.7992e6           # f_B [Hz] = FB_COEF * B [G]
R_MIN = 0.9999999            # minimum r (R_sun) of a valid model sample
# fill values of a record sampled outside the cube
FILL_NE = 0.0
FILL_TE = 1e4
FILL_B = 0.0
# MAS code units -> physical
MAS_UNITS = {"rho": 1.0e8, "t": 2.807067e7, "te": 2.807067e7,
             "br": 2.2068908, "bt": 2.2068908, "bp": 2.2068908}

KAPPA_FF_COEF = 9.786e-3      # Dulk 1985, cm^-1 with nu in Hz, T in K
SAHA_COEF = 2.4147e15         # n_e n_p / n_H = SAHA_COEF T^1.5 exp(-CHI/T)
CHI_H_OVER_K = 1.5789e5       # 13.6 eV / k_B, K
SIGMA_EH_CM2 = 3.5e-15        # low-energy elastic e-H cross-section, cm^2
PI = math.pi
