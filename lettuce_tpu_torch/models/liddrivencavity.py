"""Lid-driven cavity: the standard closed-box benchmark.

Three bounce-back walls and a sliding equilibrium lid on the top face. The
lid owns the two top corners (they are excluded from the wall mask).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.boundary import BounceBackBoundary, EquilibriumBoundaryPU
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution, periodic_grid

__all__ = ["Cavity2D"]


class Cavity2D(ExtFlow):
    """Square cavity with a lid sliding at the characteristic velocity."""

    def __init__(self, context: "Context", resolution, reynolds_number,
                 mach_number):
        super().__init__(context, resolution, reynolds_number, mach_number)

    @property
    def grid(self):
        return periodic_grid(self.resolution, 1.0, self.context.dtype,
                             self.context.device)

    @property
    def boundaries(self):
        shape = tuple(self.resolution)
        walls = np.zeros(shape, dtype=bool)
        walls[0, 1:] = walls[-1, 1:] = True  # side walls (lid owns corners)
        walls[:, 0] = True                   # floor
        lid = np.zeros(shape, dtype=bool)
        lid[:, -1] = True
        u_lid = [float(self.units.characteristic_velocity_pu), 0.0]
        return [BounceBackBoundary(walls),
                EquilibriumBoundaryPU(self.context, lid, u_lid)]

    def initial_pu(self):
        rest = self.context.zero_tensor(self.resolution)
        return rest[None], torch.stack([rest, rest])

    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        return expand_resolution(resolution, 2, allowed=(2,))

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0],
                              characteristic_length_pu=1,
                              characteristic_velocity_pu=1)
