"""Flow past a cylinder in a channel (lettuce's ``Obstacle``; the 2D
cylinder of Schaefer & Turek 1996): an equilibrium velocity inlet on the
first plane along x, the configuration's outlet on the last (a pressure
outlet, or lettuce's anti-bounce-back one), full-way bounce back on the
cylinder, periodic across the channel.

The Reynolds number is put on the cylinder's diameter, which is what the
program's ``Obstacle`` calls ``char_length``: the domain is
``nx / diameter`` diameters long. The benchmark makes the initial state
itself: the free stream at equilibrium (at rest inside the cylinder), each
population scaled by 1 + ``init_noise`` times a normal deviate from the
seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from torch_bench.flows import seeded_equilibrium
from torch_bench.reference import lbm


# the program's outlet class of each of the configuration's outlets
OUTLETS = {"pressure": "EquilibriumOutletP",
           "anti_bounce_back": "AntiBounceBackOutlet"}


def diameter(config) -> float:
    """The cylinder's diameter in cells."""
    return config["cylinder"]["diameter"] * config["resolution"][1]


def lattice(config) -> dict:
    """The characteristic velocity (Ma cs), the viscosity (U D / Re) and
    the BGK relaxation time."""
    u = config["mach_number"] * math.sqrt(lbm.CS2)
    nu = u * diameter(config) / config["reynolds_number"]
    return {"u": u, "tau": 0.5 + nu / lbm.CS2}


def solid(config) -> np.ndarray:
    """The cylinder's cells: (i - cx nx)^2 + (j - cy ny)^2 < r^2, r in
    cells."""
    nx, ny = config["resolution"]
    cx, cy = config["cylinder"]["center"]
    r = diameter(config) / 2
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    return (i - cx * nx) ** 2 + (j - cy * ny) ** 2 < r ** 2


def initial(config, device, dtype, generator, out=None) -> torch.Tensor:
    """The seeded initial populations, [q, *grid] in ``dtype``, written
    population by population into ``out`` when it is given."""
    st = lbm.Stencil(config["stencil"])
    fluid = ~torch.as_tensor(solid(config), device=device)
    u = torch.zeros((st.d, *config["resolution"]), device=device,
                    dtype=dtype)
    u[0] = fluid.to(dtype) * lattice(config)["u"]
    return seeded_equilibrium(config, st, torch.ones_like(u[0]), u, generator,
                              out)


def reference(config, device):
    """(stencil, tau, channel) of the reference step."""
    st = lbm.Stencil(config["stencil"])
    channel = lbm.Channel(torch.as_tensor(solid(config), device=device),
                          [lattice(config)["u"]] + [0.0] * (st.d - 1),
                          config["outlet"])
    return st, lattice(config)["tau"], channel


def horizon_steps(config):
    """None: the channel runs on from its seeded state."""
    return None


def program(lt, config, device, dtype, half_storage=False, *, collision):
    """The program's simulation of this flow: its ``Obstacle`` with the
    configuration's outlet in place of the anti-bounce-back one, and the
    collision that ``collision(flow)`` builds (the configuration's, found
    by name)."""
    outlet = OUTLETS[config["outlet"]]

    class Channel(lt.Obstacle):
        @property
        def boundaries(self):
            inlet, _, cylinder = lt.Obstacle.boundaries.fget(self)
            return [inlet, getattr(lt, outlet)([1, 0], self), cylinder]

    context = lt.Context(device=device, dtype=dtype, use_native=True)
    nx = config["resolution"][0]
    flow = Channel(context, list(config["resolution"]),
                   config["reynolds_number"], config["mach_number"],
                   domain_length_x=nx / diameter(config), char_length=1,
                   stencil=getattr(lt, config["stencil"])())
    flow.mask = solid(config)
    return lt.Simulation(flow, collision(flow), [], half_storage=half_storage)
