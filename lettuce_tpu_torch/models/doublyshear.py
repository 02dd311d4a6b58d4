"""Doubly periodic shear layer (Minion & Brown 1997).

As in ``lettuce_tpu``: two tanh shear layers at y=0.25 and y=0.75 plus a
small sinusoidal cross-flow perturbation that triggers the roll-up. Fully
periodic; a standard benchmark for under-resolved stability (the classic
showcase for KBC and regularized collisions).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution, periodic_grid

__all__ = ["DoublyPeriodicShear2D"]


class DoublyPeriodicShear2D(ExtFlow):
    """Perturbed double shear layer on the unit torus."""

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None,
                 shear_layer_width=80,
                 initial_perturbation_magnitude=0.05,
                 initialize_fneq: bool = True):
        self.shear_layer_width = shear_layer_width
        self.initial_perturbation_magnitude = initial_perturbation_magnitude
        self.initialize_fneq = initialize_fneq
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    @property
    def grid(self):
        return periodic_grid(self.resolution, 1.0, self.context.dtype,
                             self.context.device)

    @property
    def boundaries(self):
        return []  # fully periodic

    def initial_pu(self):
        x, y = self.grid
        k = self.shear_layer_width
        ux = torch.where(y > 0.5,
                         torch.tanh(k * (y - 0.25)),
                         torch.tanh(k * (0.75 - y)))
        uy = (self.initial_perturbation_magnitude
              * torch.sin(2 * np.pi * (x + 0.25)))
        return torch.zeros_like(ux)[None], torch.stack([ux, uy])

    def analytic_solution(self, t=0):
        raise NotImplementedError  # no closed-form solution exists

    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        return expand_resolution(resolution, 2, allowed=(2,))

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0],
                              characteristic_length_pu=1,
                              characteristic_velocity_pu=1)
