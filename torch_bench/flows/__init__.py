"""The flows of the benchmark's configurations, one module each
(``<flow>.py``, named by a configuration's ``flow``): the seeded initial
state, the program's simulation and the reference step. The program's
collision is a module of its own, ``collisions/<name>.py``, named by the
configuration's ``collision``: ``program(lt, flow, params)`` returns the
port's ``Collision`` for the built flow; the harness finds it and hands
it to the flow's ``program``."""

from __future__ import annotations

import torch

from torch_bench.reference import lbm


def seeded_equilibrium(config, st, rho, u, generator, out):
    """The equilibrium of (rho, u), each population scaled by 1 +
    ``init_noise`` times a normal deviate from ``generator``."""
    if out is None:
        out = torch.empty((st.q, *rho.shape), device=rho.device,
                          dtype=rho.dtype)
    uu = (u * u).sum(0)
    for i in range(st.q):
        noise = torch.randn(rho.shape, generator=generator,
                            device=rho.device, dtype=rho.dtype)
        out[i] = lbm.equilibrium_q(rho, u, uu, st, i) * (
            1 + config["init_noise"] * noise)
    return out
