"""Body-force-driven plane Poiseuille flow.

As in ``lettuce_tpu``: bounce-back plates on both y faces and a constant
x-acceleration, consumed by a ``Guo`` or ``ShanChen`` force attached to
the collision (the CLI wires this up when the flow exposes
``acceleration``). The steady state is the parabola
``u_x(y) = a /(2 nu) * y (1 - y)`` evaluated at the half-link-shifted wall
positions of full-way bounce back.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..ops.boundary import BounceBackBoundary
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, closed_grid, expand_resolution, face_mask

__all__ = ["PoiseuilleFlow2D"]


class PoiseuilleFlow2D(ExtFlow):
    """Channel flow driven by a uniform body force between two no-slip
    plates. ``initialize_with_zeros`` starts from rest (default) instead
    of the analytic parabola."""

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None,
                 initialize_with_zeros=True):
        self.initialize_with_zeros = initialize_with_zeros
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    @property
    def acceleration(self):
        return self.context.convert_to_tensor([0.001, 0])

    @property
    def grid(self):
        return closed_grid(self.resolution, 1.0, self.context.dtype,
                           self.context.device)

    @property
    def boundaries(self):
        plates = (face_mask(self.resolution, axis=1, end=0)
                  | face_mask(self.resolution, axis=1, end=-1))
        return [BounceBackBoundary(mask=plates)]

    def initial_pu(self):
        if not self.initialize_with_zeros:
            return self.analytic_solution()
        rest = self.context.zero_tensor(self.resolution)
        return rest[None], torch.stack([rest, rest])

    def analytic_solution(self, t=0):
        """Steady parabola; full-way bounce back places the effective
        walls half a lattice spacing outside the boundary nodes."""
        h = 0.5 / self.resolution[0]
        y = self.grid[1]
        nu = self.units.viscosity_pu
        rho = 1
        ux = (self.acceleration[0] / (2 * rho * nu)
              * (y - h) * (1 - h - y))
        u = torch.stack([ux, torch.zeros_like(ux)])
        p = (torch.zeros_like(ux)
             + self.units.convert_density_lu_to_pressure_pu(rho))
        return p, u

    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        d = stencil.d if stencil is not None else 2
        return expand_resolution(resolution, d)

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0] - 1,
                              characteristic_length_pu=1,
                              characteristic_velocity_pu=1)
