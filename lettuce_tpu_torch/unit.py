"""Unit system: lattice units (lu) <-> physical units (pu).

Same converters as ``lettuce_tpu.unit``: every quantity converts through
ONE rule, ``x_pu = x_lu * L^a * V^b * R^c``, where L/V/R are the base
scale factors (physical length, velocity and density per lattice unit) and
(a, b, c) are the quantity's dimensions. Pressure keeps its special
treatment: lattice pressure is the deviation ``(rho_lu - rho0) * cs^2`` of
an ideal-gas equation of state.

Everything is scalar arithmetic over floats, numpy arrays or torch tensors;
the factors are python floats, so they never promote a float32 tensor.
"""

from __future__ import annotations

import numpy as np

__all__ = ["UnitConversion"]

# (length, velocity, density) exponents per physical quantity
_DIMENSIONS = {
    "length": (1, 0, 0),
    "velocity": (0, 1, 0),
    "density": (0, 0, 1),
    "time": (1, -1, 0),                  # L / V
    "acceleration": (-1, 2, 0),          # V^2 / L
    "pressure": (0, 2, 1),               # R V^2
    "energy": (0, 2, 1),                 # here: units of density * V^2
    "incompressible_energy": (0, 2, 0),  # here: units of V^2
}


class UnitConversion:
    """Re/Ma-parameterised unit system.

    The simulation is fixed by the Reynolds and Mach numbers plus the
    characteristic scales; the lattice velocity scale follows from the
    Mach number (``u_char_lu = Ma * cs``) and the lattice viscosity (and
    hence the BGK relaxation time) from the Reynolds number.
    """

    def __init__(self, reynolds_number, mach_number=0.05,
                 characteristic_length_pu=1, characteristic_velocity_pu=1,
                 characteristic_length_lu=1, characteristic_density_lu=1,
                 characteristic_density_pu=1, cs=float(1 / np.sqrt(3.0))):
        self.reynolds_number = reynolds_number
        self.mach_number = mach_number
        self.cs = float(cs)
        self.characteristic_length_pu = characteristic_length_pu
        self.characteristic_velocity_pu = characteristic_velocity_pu
        self.characteristic_length_lu = characteristic_length_lu
        self.characteristic_density_pu = characteristic_density_pu
        self.characteristic_density_lu = characteristic_density_lu

    # -------------------- base scale factors --------------------
    def _factor(self, quantity: str):
        """Physical units per lattice unit for the named quantity."""
        a, b, c = _DIMENSIONS[quantity]
        fac = 1.0
        if a:
            fac = fac * (self.characteristic_length_pu
                         / self.characteristic_length_lu) ** a
        if b:
            fac = fac * (self.characteristic_velocity_pu
                         / self.characteristic_velocity_lu) ** b
        if c:
            fac = fac * (self.characteristic_density_pu
                         / self.characteristic_density_lu) ** c
        # a python float: it scales tensors in their own dtype
        return float(fac)

    def _to_pu(self, value, quantity: str):
        return value * self._factor(quantity)

    def _to_lu(self, value, quantity: str):
        return value / self._factor(quantity)

    # -------------------- derived characteristics --------------------
    @property
    def characteristic_velocity_lu(self):
        # the Mach number picks the lattice velocity scale
        return self.mach_number * self.cs

    @property
    def characteristic_pressure_pu(self):
        return self._factor("pressure") * self.characteristic_pressure_lu

    @property
    def characteristic_pressure_lu(self):
        return (self.characteristic_density_lu
                * self.characteristic_velocity_lu ** 2)

    @property
    def viscosity_lu(self):
        # Re = u_char L_char / nu, evaluated in lattice units
        return (self.characteristic_velocity_lu
                * self.characteristic_length_lu / self.reynolds_number)

    @property
    def viscosity_pu(self):
        return (self.characteristic_velocity_pu
                * self.characteristic_length_pu / self.reynolds_number)

    @property
    def relaxation_parameter_lu(self):
        # Chapman-Enskog: nu_lu = cs^2 (tau - 1/2)
        return 0.5 + self.viscosity_lu / self.cs ** 2

    # -------------------- conversions --------------------
    def convert_length_to_pu(self, length_lu):
        return self._to_pu(length_lu, "length")

    def convert_length_to_lu(self, length_pu):
        return self._to_lu(length_pu, "length")

    def convert_velocity_to_pu(self, velocity_lu):
        return self._to_pu(velocity_lu, "velocity")

    def convert_velocity_to_lu(self, velocity_pu):
        return self._to_lu(velocity_pu, "velocity")

    def convert_density_to_pu(self, density_lu):
        return self._to_pu(density_lu, "density")

    def convert_density_to_lu(self, density_pu):
        return self._to_lu(density_pu, "density")

    def convert_time_to_pu(self, time_lu):
        return self._to_pu(time_lu, "time")

    def convert_time_to_lu(self, time_pu):
        return self._to_lu(time_pu, "time")

    def convert_acceleration_to_pu(self, acceleration_lu):
        return self._to_pu(acceleration_lu, "acceleration")

    def convert_acceleration_to_lu(self, acceleration_pu):
        return self._to_lu(acceleration_pu, "acceleration")

    def convert_pressure_to_pu(self, pressure_lu):
        return self._to_pu(pressure_lu, "pressure")

    def convert_pressure_to_lu(self, pressure_pu):
        return self._to_lu(pressure_pu, "pressure")

    def convert_energy_to_pu(self, energy_lu):
        return self._to_pu(energy_lu, "energy")

    def convert_energy_to_lu(self, energy_pu):
        return self._to_lu(energy_pu, "energy")

    def convert_incompressible_energy_to_pu(self, energy_lu):
        return self._to_pu(energy_lu, "incompressible_energy")

    def convert_incompressible_energy_to_lu(self, energy_pu):
        return self._to_lu(energy_pu, "incompressible_energy")

    # ideal-gas EOS: lattice pressure is the density deviation times cs^2
    def convert_density_lu_to_pressure_pu(self, density_lu):
        dev = density_lu - self.characteristic_density_lu
        return self.convert_pressure_to_pu(dev * self.cs ** 2)

    def convert_pressure_pu_to_density_lu(self, pressure_pu):
        dev = self.convert_pressure_to_lu(pressure_pu) / self.cs ** 2
        return dev + self.characteristic_density_lu
