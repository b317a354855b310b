"""Physical constants and unit systems.

A copy of ``fdtd_tpu.constants`` (the port cannot import the JAX package)
and the counterpart of the reference's ``PhysicalConstants``
(cem-solver/src/material.rs:21-64): two built-in unit systems (SI and
REDUCED with eps0 = mu0 = 1) plus derived quantities (speed of light,
wavelength <-> frequency conversion).

All constant math is done in float64 on the host; the solver casts the
derived per-cell coefficients to float32 (or bfloat16) only at the very
end, which keeps the f32 fidelity gate tractable.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["PhysicalConstants", "SI", "REDUCED"]


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """Vacuum permittivity/permeability defining the unit system.

    Mirrors cem-solver/src/material.rs:21-64.
    """

    vacuum_permittivity: float = 8.8541878188e-12  # eps_0
    vacuum_permeability: float = 1.25663706127e-6  # mu_0

    @property
    def speed_of_light(self) -> float:
        return (self.vacuum_permittivity * self.vacuum_permeability) ** -0.5

    @property
    def vacuum_impedance(self) -> float:
        """Impedance of free space sqrt(mu0/eps0)."""
        return math.sqrt(self.vacuum_permeability / self.vacuum_permittivity)

    def frequency_to_wavelength(self, frequency: float) -> float:
        return self.speed_of_light / frequency

    def wavelength_to_frequency(self, wavelength: float) -> float:
        return self.speed_of_light / wavelength


#: SI units (default), cem-solver/src/material.rs:43-46.
SI = PhysicalConstants()

#: Reduced units with eps0 = mu0 = c = 1, cem-solver/src/material.rs:48-51.
REDUCED = PhysicalConstants(vacuum_permittivity=1.0, vacuum_permeability=1.0)
