"""Flow past an arbitrary obstacle: inflow, outflow, and a user mask.

Uniform equilibrium inflow on the x=0 face, anti-bounce-back outflow
through the x=max face, and full-way bounce back on a user-settable boolean
mask (cylinder, square, airfoil...). The free stream starts impulsively at
the characteristic velocity with the masked region at rest.

Example
-------
>>> flow = Obstacle(context, [101, 51], reynolds_number=100,
...                 mach_number=0.1, domain_length_x=10.1)
>>> x, y = flow.grid
>>> flow.mask = ((x - 2.5) ** 2 + (y - 2.5) ** 2 < 1.).cpu().numpy()
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.boundary import (AntiBounceBackOutlet, BounceBackBoundary,
                            EquilibriumBoundaryPU)
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution

__all__ = ["Obstacle", "Obstacle2D", "Obstacle3D"]


class Obstacle(ExtFlow):
    """Channel with an immersed obstacle given by ``flow.mask``.

    ``domain_length_x`` fixes the physical extent of the x axis;
    ``char_length`` / ``char_velocity`` set the characteristic scales (the
    obstacle diameter and free-stream speed for the usual drag/Strouhal
    normalisations).
    """

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number, domain_length_x,
                 char_length=1, char_velocity=1,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None):
        self.resolution = self.make_resolution(resolution, stencil)
        self.char_length = char_length
        self.char_length_lu = (self.resolution[0] * char_length
                               / domain_length_x)
        self.char_velocity = char_velocity
        self._mask = np.zeros(tuple(self.resolution), dtype=bool)
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    # -------------------- obstacle geometry --------------------
    @property
    def mask(self) -> np.ndarray:
        return self._mask

    @mask.setter
    def mask(self, m):
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        m = np.asarray(m, dtype=bool)
        if m.shape != tuple(self.resolution):
            raise ValueError(f"mask shape {m.shape} != resolution "
                             f"{tuple(self.resolution)}")
        self._mask = m

    @property
    def grid(self):
        axes = [self.units.convert_length_to_pu(
            torch.arange(n, dtype=self.context.dtype,
                         device=self.context.device))
            for n in self.resolution]
        return torch.meshgrid(*axes, indexing="ij")

    def _flow_direction(self):
        """Free-stream unit vector (+x)."""
        return np.eye(self.stencil.d)[0]

    # kept under the reference's name for API compatibility
    _unit_vector = _flow_direction

    # -------------------- physics --------------------
    def initial_pu(self):
        u_inf = (self.units.characteristic_velocity_pu
                 * self._flow_direction())
        u = (~self._mask
             * u_inf.reshape((-1,) + (1,) * self.stencil.d))
        return np.zeros((1,) + tuple(self.resolution)), u

    @property
    def boundaries(self):
        inflow = (self.grid[0].abs() < 1e-6).cpu().numpy()
        u_inflow = np.asarray(self.units.characteristic_velocity_pu
                              * self._flow_direction())
        return [
            EquilibriumBoundaryPU(context=self.context, mask=inflow,
                                  velocity=u_inflow),
            AntiBounceBackOutlet(
                self._flow_direction().astype(int).tolist(), self),
            BounceBackBoundary(self._mask),
        ]

    # -------------------- configuration hooks --------------------
    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        d = stencil.d if stencil is not None else None
        if d is None and isinstance(resolution, int):
            raise ValueError("int resolution needs a stencil to fix the "
                             "dimension")
        return expand_resolution(resolution, d or len(resolution))

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=self.char_length_lu,
                              characteristic_length_pu=self.char_length,
                              characteristic_velocity_pu=self.char_velocity)


def _deprecated_obstacle(name, context, resolution, reynolds_number,
                         mach_number, stencil, char_length_lu):
    warnings.warn(f"{name} is deprecated. Use Obstacle instead",
                  DeprecationWarning)
    nx = resolution[0] if isinstance(resolution, list) else resolution
    return Obstacle(context, resolution, reynolds_number, mach_number,
                    domain_length_x=nx / char_length_lu, stencil=stencil)


def Obstacle2D(context, resolution, reynolds_number, mach_number, stencil,
               char_length_lu):
    return _deprecated_obstacle("Obstacle2D", context, resolution,
                                reynolds_number, mach_number, stencil,
                                char_length_lu)


def Obstacle3D(context, resolution, reynolds_number, mach_number, stencil,
               char_length_lu):
    return _deprecated_obstacle("Obstacle3D", context, resolution,
                                reynolds_number, mach_number, stencil,
                                char_length_lu)
