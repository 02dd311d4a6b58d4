"""Taylor-Green vortex (2D/3D): the classic periodic decay benchmark.

In 2D the Navier-Stokes solution is known in closed form (the vortex sheet
decays as ``exp(-2 nu t)``), which makes it the convergence gate. In 3D
only the t=0 field is analytic; the flow then develops the vortex-stretching
cascade of the Re=1600 dissipation-peak benchmark.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Union

import numpy as np
import torch

from ..stencil import D2Q9
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution, periodic_grid

__all__ = ["TaylorGreenVortex"]


class TaylorGreenVortex(ExtFlow):
    """Periodic vortex decay on [0, 2 pi)^d at unit characteristic
    velocity. ``initialize_fneq`` adds the first-order non-equilibrium
    part to the initial populations (default on)."""

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None,
                 initialize_fneq: bool = True):
        self.initialize_fneq = initialize_fneq
        if stencil is None and isinstance(resolution, int):
            warnings.warn("Requiring information about dimensionality! "
                          "Either via stencil or resolution. Setting "
                          "dimension to 2.", UserWarning)
            stencil = D2Q9()
        self.stencil = stencil() if callable(stencil) else stencil
        super().__init__(context, resolution, reynolds_number, mach_number,
                         self.stencil, equilibrium)

    # -------------------- geometry --------------------
    @property
    def grid(self):
        return periodic_grid(self.resolution, 2 * np.pi, self.context.dtype,
                             self.context.device)

    @property
    def boundaries(self) -> List["Boundary"]:
        return []  # fully periodic

    # -------------------- physics --------------------
    def initial_pu(self):
        return self.analytic_solution(t=0)

    def analytic_solution(self, t: float = 0):
        if self.stencil.d > 2 and not isinstance(t, torch.Tensor) and t > 0:
            warnings.warn("The analytic solution is only true for the "
                          "2D TGV!")
        x = self.grid
        if self.stencil.d == 2:
            # a 0-dim CPU tensor enters device arithmetic as a scalar: no
            # host-to-device copy per call
            decay = -2 * self.units.viscosity_pu * t
            amp = torch.exp(torch.as_tensor(decay, dtype=self.context.dtype))
            ux = torch.cos(x[0]) * torch.sin(x[1]) * amp
            uy = -torch.sin(x[0]) * torch.cos(x[1]) * amp
            p = (-0.25 * amp * amp
                 * (torch.cos(2 * x[0]) + torch.cos(2 * x[1])))[None]
            return p, torch.stack([ux, uy])
        ux = torch.sin(x[0]) * torch.cos(x[1]) * torch.cos(x[2])
        uy = -torch.cos(x[0]) * torch.sin(x[1]) * torch.cos(x[2])
        uz = torch.zeros_like(ux)
        p = ((torch.cos(2 * x[0]) + torch.cos(2 * x[1]))
             * (torch.cos(2 * x[2]) + 2) / 16.)[None]
        return p, torch.stack([ux, uy, uz])

    # -------------------- configuration hooks --------------------
    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        d = self.stencil.d if self.stencil is not None else len(resolution)
        return expand_resolution(resolution, d, allowed=(2, 3))

    def make_units(self, reynolds_number, mach_number,
                   resolution) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0],
                              characteristic_length_pu=2 * np.pi,
                              characteristic_velocity_pu=1)
