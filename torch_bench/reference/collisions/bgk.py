"""BGK with the quadratic equilibrium: the reference's own ``lbm.bgk``.
It takes no parameters."""

from torch_bench.reference import lbm


def collide(f, st, tau, params):
    return lbm.bgk(f, st, tau)
