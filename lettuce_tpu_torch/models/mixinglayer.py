"""Temporal mixing layer: two counter-flowing free streams joined by a
tanh shear profile, seeded with confined random noise.

As in ``lettuce_tpu``: x (and, in 3D, z) are periodic; the cross-stream
(y) faces are equilibrium free-stream planes moving at +/- the free-stream
velocity. The initial condition is ``u_x = tanh(y / (2 delta))`` with
zero-mean uniform noise on the cross-stream components from
``np.random.default_rng(randseed)`` (so both packages draw the same
noise), enveloped by ``exp(-(y / (2 delta))^2)`` so the perturbation lives
inside the shear layer and the Kelvin-Helmholtz roll-up starts there.
Units are physical: the characteristic velocity is the free stream and the
characteristic length the domain height.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.boundary import EquilibriumBoundaryPU
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution, face_mask

__all__ = ["MixingLayer"]


class MixingLayer(ExtFlow):
    """Free shear layer between streams at u_x = +1 (top) and -1
    (bottom), on [0,2) x [-1,1] (x 2D) or [0,2) x [-1,1] x [0,2) (3D).

    Parameters
    ----------
    shear_layer_thickness : half-thickness delta of the tanh profile
        (physical units; domain height is 2).
    noise_amplitude : cross-stream perturbation amplitude as a fraction
        of the free-stream velocity.
    randseed : seed for the noise realisation (None draws fresh).
    """

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None,
                 shear_layer_thickness: float = 0.093,
                 noise_amplitude: float = 0.05,
                 randseed: Optional[int] = None,
                 initialize_fneq: bool = True):
        self.shear_layer_thickness = shear_layer_thickness
        self.noise_amplitude = noise_amplitude
        self.randseed = randseed
        self.initialize_fneq = initialize_fneq
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    # -------------------- geometry --------------------
    @property
    def grid(self):
        # x (and z) periodic over [0, 2); y wall-to-wall over [-1, 1]
        dtype, device = self.context.dtype, self.context.device
        axes = []
        for a, n in enumerate(self.resolution):
            if a == 1:
                axes.append(torch.linspace(-1.0, 1.0, n, dtype=dtype,
                                           device=device))
            else:
                axes.append(torch.arange(n, dtype=dtype, device=device)
                            * (2.0 / n))
        return torch.meshgrid(*axes, indexing="ij")

    @property
    def boundaries(self):
        d = len(self.resolution)
        downstream = np.zeros(d)
        downstream[0] = 1.0
        return [
            EquilibriumBoundaryPU(
                self.context, mask=face_mask(self.resolution, axis=1, end=-1),
                velocity=downstream),
            EquilibriumBoundaryPU(
                self.context, mask=face_mask(self.resolution, axis=1, end=0),
                velocity=-downstream),
        ]

    # -------------------- physics --------------------
    def initial_pu(self):
        grid = self.grid
        y = grid[1]
        s = y / (2.0 * self.shear_layer_thickness)
        envelope = torch.exp(-(s ** 2)) * self.noise_amplitude
        rng = np.random.default_rng(self.randseed)
        u = [torch.tanh(s)]
        for _ in range(1, len(grid)):
            noise = rng.uniform(-1.0, 1.0, size=tuple(y.shape))
            u.append(self.context.convert_to_tensor(noise) * envelope)
        p = torch.zeros_like(y)[None]
        return p, torch.stack(u)

    def analytic_solution(self, t=0):
        raise NotImplementedError  # free shear layers have no closed form

    # -------------------- template hooks --------------------
    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        if stencil is None:
            d = 2
        else:
            if isinstance(stencil, type):
                stencil = stencil()
            d = stencil.d
        return expand_resolution(resolution, d, allowed=(2, 3))

    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        # Re based on the domain height (2) and the free-stream speed (1)
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[1],
                              characteristic_length_pu=2.0,
                              characteristic_velocity_pu=1.0)
