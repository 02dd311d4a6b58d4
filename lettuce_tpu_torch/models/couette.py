"""Plane Couette flow: fluid sheared between a sliding lid and a fixed
plate.

As in ``lettuce_tpu``: the characteristic velocity is the wall velocity,
and the moving wall sits on the y=1 face, so the steady state is the
linear profile ``u_x(y) = u_wall * y``.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.boundary import BounceBackBoundary, EquilibriumBoundaryPU
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, closed_grid, expand_resolution, face_mask

__all__ = ["CouetteFlow2D"]


class CouetteFlow2D(ExtFlow):
    """Wall-bounded shear: y=0 is a bounce-back plate, y=1 an equilibrium
    wall moving at ``u_wall`` in x. Starts from rest."""

    u_wall = 1.0
    u0 = 0  # background velocity

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None):
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    @property
    def grid(self):
        return closed_grid(self.resolution, 1.0, self.context.dtype,
                           self.context.device)

    @property
    def boundaries(self):
        return [
            EquilibriumBoundaryPU(
                self.context, mask=face_mask(self.resolution, axis=1, end=-1),
                velocity=np.array([self.u_wall, 0.0])),
            BounceBackBoundary(face_mask(self.resolution, axis=1, end=0)),
        ]

    def initial_pu(self):
        rest = self.context.zero_tensor(self.resolution)
        return rest[None], torch.stack([rest, rest])

    def analytic_solution(self, t=0):
        """Steady state: linear shear profile, uniform pressure."""
        y = self.grid[1]
        u = torch.stack([self.u_wall * y + self.u0, torch.zeros_like(y)])
        return torch.zeros_like(y)[None], u

    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        return expand_resolution(resolution, 2)

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0],
                              characteristic_length_pu=1,
                              characteristic_velocity_pu=self.u_wall)
