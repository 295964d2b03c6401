"""Internal unit system of the engine (the port's copy of
``aztotmd_tpu/units.py``).

The engine works in the same internal units as the reference azTotMD
(reference: src/const.h:17-50): length in angstrom (A), time in picosecond
(ps), energy in electron-volt (eV), charge in proton charges (e).  Mass is a
*derived* unit (E*t^2/r^2), so atomic masses read from decks in amu are
rescaled by ``M_SCALE``.

All constants below are computed from the same SI values the reference uses,
so numeric parity is exact to double precision.
"""

import math

PI = 3.14159265359                      # const.h:11 (reference truncates pi)
TWOPI = 2.0 * PI
SQRTPI = math.sqrt(PI)
SPHERA = 4.0 * PI / 3.0                 # factor before r^3 in sphere volume

# internal units in SI (const.h:17-24)
R_SI = 1.0e-10                          # length unit: angstrom
T_SI = 1.0e-12                          # time unit: picosecond
E_SI = 1.60217733e-19                   # energy unit: electron-volt
Q_SI = 1.60217657e-19                   # charge unit: proton charge

KB_SI = 1.3806488e-23                   # Boltzmann constant, J/K
E0_SI = 8.854187817e-12                 # vacuum permittivity, F/m

# derived units in SI (const.h:27-30)
M_SI = E_SI * T_SI * T_SI / R_SI / R_SI     # mass unit in kg
F_SI = E_SI / R_SI                          # force unit in N
FCOUL_SI = 0.25 / PI / E0_SI * Q_SI * Q_SI / R_SI / R_SI

# traditional units (const.h:33-38)
EV_SI = 1.60217733e-19
ANG_SI = 1.0e-10
PS_SI = 1.0e-12
AMU_SI = 1.6605402e-27

# input -> internal unit scale factors (const.h:41-47)
R_SCALE = ANG_SI / R_SI                 # = 1.0
T_SCALE = 1.0
E_SCALE = 1.0
Q_SCALE = 1.0
M_SCALE = AMU_SI / M_SI                 # amu -> internal mass
FCOUL_SCALE = FCOUL_SI / F_SI           # Coulomb prefactor ~14.3996 eV*A/e^2

# fundamental constants in internal units (const.h:50-52)
KB = KB_SI / (E_SCALE * EV_SI)          # Boltzmann constant, eV/K
RKB = 1.0 / KB

# the CUDA engine hard-codes the Coulomb prefactor as a float32 literal
# (main.cu:40: d_Fcoul_scale = 14.3996f); we keep the double-precision value
# and expose the f32 one for bit-parity experiments.
FCOUL_SCALE_F32 = 14.3996

# radiative-thermostat constants (cuTemp.cu:449-452)
LIGHT = 2.9979e4                        # speed of light, A/ps
REV_LIGHT = 3.33567e-5                  # 1/c
REV_PLANK = 241.55                      # 1/h, with h = 4.14 eV*ps
