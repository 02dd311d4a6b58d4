"""Taylor-Green vortex in a periodic cube (Brachet et al. 1983; the Re 1600
case of the 1st International Workshop on High-Order CFD Methods).

The benchmark makes the initial state itself: the analytic t = 0 field at
equilibrium, each population scaled by 1 + ``init_noise`` times a normal
deviate from the seed. The program gets that state and builds its own
flow, units and collision from the configuration's numbers.
"""

from __future__ import annotations

import math

import torch

from torch_bench.flows import seeded_equilibrium
from torch_bench.reference import lbm


def lattice(config) -> dict:
    """The lattice numbers the configuration implies: the characteristic
    velocity (Ma cs), the viscosity (U L / Re), the BGK relaxation time,
    and the time step in the flow's units (length 2 pi, velocity 1)."""
    n = config["resolution"][0]
    u = config["mach_number"] * math.sqrt(lbm.CS2)
    nu = u * n / config["reynolds_number"]
    return {"u": u, "tau": 0.5 + nu / lbm.CS2, "dt": 2 * math.pi / n * u}


def initial(config, device, dtype, generator, out=None) -> torch.Tensor:
    """The seeded initial populations, [q, *grid] in ``dtype``, written
    population by population into ``out`` when it is given."""
    st = lbm.Stencil(config["stencil"])
    shape = tuple(config["resolution"])
    u0 = lattice(config)["u"]
    axes = [torch.arange(n, device=device, dtype=dtype) * (2 * math.pi / n)
            for n in shape]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    u = u0 * torch.stack([torch.sin(x) * torch.cos(y) * torch.cos(z),
                          -torch.cos(x) * torch.sin(y) * torch.cos(z),
                          torch.zeros_like(x)])
    rho = 1 + ((torch.cos(2 * x) + torch.cos(2 * y)) * (torch.cos(2 * z) + 2)
               / 16 * (u0 * u0 / lbm.CS2))
    del x, y, z
    return seeded_equilibrium(config, st, rho, u, generator, out)


def reference(config, device):
    """(stencil, tau, channel) of the reference step: a periodic grid."""
    return lbm.Stencil(config["stencil"]), lattice(config)["tau"], None


def horizon_steps(config):
    """Steps to the end of the case (t = ``horizon_time``), after which
    the rollout starts again from the seeded state."""
    return round(config["horizon_time"] / lattice(config)["dt"])


def program(lt, config, device, dtype, half_storage=False, *, collision):
    """The program's simulation of this flow, with the collision that
    ``collision(flow)`` builds (the configuration's, found by name)."""
    context = lt.Context(device=device, dtype=dtype, use_native=True)
    flow = lt.TaylorGreenVortex(
        context, list(config["resolution"]), config["reynolds_number"],
        config["mach_number"], stencil=getattr(lt, config["stencil"])(),
        initialize_fneq=config["initialize_fneq"])
    return lt.Simulation(flow, collision(flow), [], half_storage=half_storage)
