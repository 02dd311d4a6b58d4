"""Plain PyTorch lattice Boltzmann: the benchmark's reference.

It imports torch alone and takes no kernel, table, weight or state that the
program made. Its stencils are lettuce's published tables in lettuce's
population order, which the program's state layout follows too; the
comparison checks the program's velocity table against these before it
compares any state.

One step is collide, then boundaries, then stream, as lettuce's plain step
(``compose_step``): the configuration's collision where the cell is fluid
(BGK with the quadratic equilibrium by default; any other is a module
``reference/collisions/<name>.py`` that the harness finds by name and
passes as ``collide``); on a bounded channel the outlet on the last plane
along x (a pressure outlet, or anti-bounce-back), full-way bounce back on
the solid cells and the velocity inlet's equilibrium on the first plane;
then periodic streaming, in which the outlet plane keeps the populations
it replaced. Every operation is differentiable by autograd, so the same
step is the gradient cells' reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["STENCILS", "Stencil", "Channel", "velocity", "equilibrium_q",
           "equilibrium", "bgk", "stream", "step", "run", "adam_update"]

# lettuce's stencils: velocities and weights, in lettuce's order
STENCILS = {
    "D2Q9": ([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1],
              [1, 1], [-1, 1], [-1, -1], [1, -1]],
             [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4),
    "D3Q19": ([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
               [0, 0, 1], [0, 0, -1], [0, 1, 1], [0, -1, -1], [0, 1, -1],
               [0, -1, 1], [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
               [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0]],
              [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12),
    "D3Q27": ([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
               [0, 0, 1], [0, 0, -1], [0, 1, 1], [0, -1, -1], [0, 1, -1],
               [0, -1, 1], [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
               [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
               [1, 1, 1], [-1, -1, -1], [1, 1, -1], [-1, -1, 1],
               [1, -1, 1], [-1, 1, -1], [1, -1, -1], [-1, 1, 1]],
              [8 / 27] + [2 / 27] * 6 + [1 / 54] * 12 + [1 / 216] * 8),
}
CS2 = 1.0 / 3.0  # the squared lattice speed of sound


class Stencil:
    """Velocities ``e`` (a list of integer tuples), weights ``w`` and the
    index of each velocity's opposite."""

    def __init__(self, name: str):
        e, w = STENCILS[name]
        self.name = name
        self.e = [tuple(v) for v in e]
        self.w = list(w)
        self.q, self.d = len(e), len(e[0])
        self.opposite = [self.e.index(tuple(-c for c in v)) for v in self.e]


class Channel:
    """The boundaries of a channel along axis 0: a velocity inlet on the
    first plane (the equilibrium at density 1 and ``u_in``), an outlet on
    the last, and full-way bounce back on ``solid`` (a bool tensor over
    the grid). ``outlet`` is ``"pressure"`` (the equilibrium at density 1
    and the velocity of the plane before it) or ``"anti_bounce_back"``
    (Krueger et al. 2016, p. 195)."""

    def __init__(self, solid: torch.Tensor, u_in, outlet: str):
        if outlet not in ("pressure", "anti_bounce_back"):
            raise ValueError(f"unknown outlet {outlet!r}")
        self.solid = solid
        self.u_in = list(u_in)
        self.outlet = outlet


def velocity(f: torch.Tensor, st: Stencil) -> torch.Tensor:
    """u = sum_q e_q f_q / sum_q f_q, as a [d, *grid] tensor, summed
    population by population (no matrix product, so no TF32)."""
    rho = f.sum(0)
    j = []
    for a in range(st.d):
        terms = [c * f[i] for i, v in enumerate(st.e) for c in (v[a],) if c]
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        j.append(total)
    return torch.stack(j) / rho


def equilibrium_q(rho: torch.Tensor, u: torch.Tensor, uu: torch.Tensor,
                  st: Stencil, i: int) -> torch.Tensor:
    """Population ``i`` of the quadratic equilibrium:
    w_q rho (1 + e.u / cs^2 + (e.u)^2 / (2 cs^4) - u.u / (2 cs^2)), with
    ``uu`` = u.u."""
    eu = None
    for a, c in enumerate(st.e[i]):
        if c:
            eu = c * u[a] if eu is None else eu + c * u[a]
    w = st.w[i]
    if eu is None:
        return w * rho * (1 - uu / (2 * CS2))
    return w * rho * (1 + eu / CS2 + eu * eu / (2 * CS2 * CS2)
                      - uu / (2 * CS2))


def equilibrium(rho: torch.Tensor, u: torch.Tensor, st: Stencil
                ) -> torch.Tensor:
    """The quadratic equilibrium, [q, *grid]."""
    uu = (u * u).sum(0)
    return torch.stack([equilibrium_q(rho, u, uu, st, i)
                        for i in range(st.q)])


def bgk(f: torch.Tensor, st: Stencil, tau: float) -> torch.Tensor:
    """f + (f_eq(rho, u) - f) / tau."""
    rho = f.sum(0)
    return f + (equilibrium(rho, velocity(f, st), st) - f) / tau


def stream(f: torch.Tensor, st: Stencil) -> torch.Tensor:
    """Periodic streaming: f_q(x + e_q) <- f_q(x)."""
    dims = tuple(range(st.d))
    return torch.stack([f[i] if not any(v) else torch.roll(f[i], v, dims)
                        for i, v in enumerate(st.e)])


def _anti_bounce_back(f: torch.Tensor, st: Stencil) -> torch.Tensor:
    """The anti-bounce-back replacement of the last plane along axis 0:
    each population entering the domain (e_x = -1) becomes
    -f_out + w rho (2 + (e.u_w)^2 / cs^4 - u_w.u_w / cs^2) of its outgoing
    opposite, with u_w = 1.5 u(last) - 0.5 u(last - 1)."""
    last, before = f[:, -1], f[:, -2]
    u_w = 1.5 * velocity(last, st) - 0.5 * velocity(before, st)
    rho = last.sum(0)
    uu = (u_w * u_w).sum(0)
    planes = list(last.unbind(0))
    for i, v in enumerate(st.e):
        if v[0] != 1:
            continue
        eu = None
        for a, c in enumerate(v):
            if c:
                eu = c * u_w[a] if eu is None else eu + c * u_w[a]
        planes[st.opposite[i]] = (-last[i] + st.w[i] * rho
                                  * (2 + eu * eu / (CS2 * CS2) - uu / CS2))
    return torch.stack(planes)


def _pressure(f: torch.Tensor, st: Stencil) -> torch.Tensor:
    """The pressure outlet's last plane along axis 0: the equilibrium at
    density 1 and the velocity of the plane before it."""
    before = f[:, -2]
    return equilibrium(torch.ones_like(before[0]), velocity(before, st), st)


def step(f: torch.Tensor, st: Stencil, tau: float,
         channel: Channel = None, collide=bgk) -> torch.Tensor:
    """One collide-and-stream step of a periodic grid, or of ``channel``,
    with the collision ``collide(f, st, tau)``."""
    post = collide(f, st, tau)
    if channel is None:
        return stream(post, st)
    solid = channel.solid
    fluid = ~solid
    fluid[0] = False
    fluid[-1] = False
    post = torch.where(fluid, post, f)
    if channel.outlet == "pressure":
        replaced = _pressure(post, st)
        # every population that does not leave the domain stays on the
        # outlet plane
        kept = [i for i, v in enumerate(st.e) if v[0] != 1]
    else:
        replaced = _anti_bounce_back(post, st)
        kept = [i for i, v in enumerate(st.e) if v[0] == -1]
    post = torch.cat([post[:, :-1], replaced[:, None]], dim=1)
    post = torch.where(solid, post[st.opposite], post)
    u_in = torch.tensor(channel.u_in, dtype=f.dtype, device=f.device)
    u_in = u_in.reshape((st.d,) + (1,) * (st.d - 1)).expand(
        (st.d,) + tuple(f.shape[2:]))
    inlet = equilibrium(torch.ones_like(f[0, 0]), u_in, st)
    post = torch.cat([inlet[:, None], post[:, 1:]], dim=1)
    streamed = stream(post, st)
    keep = torch.zeros(st.q, dtype=torch.bool, device=f.device)
    keep[kept] = True
    keep = keep.reshape((st.q,) + (1,) * (st.d - 1))
    last = torch.where(keep, post[:, -1], streamed[:, -1])
    return torch.cat([streamed[:, :-1], last[:, None]], dim=1)


def run(f: torch.Tensor, steps: int, st: Stencil, tau: float,
        channel: Channel = None, checkpointed: bool = False, collide=bgk
        ) -> torch.Tensor:
    """``steps`` steps with the collision ``collide``; ``checkpointed``
    recomputes each step in the backward instead of keeping its
    intermediates."""
    for _ in range(steps):
        if checkpointed:
            f = checkpoint(step, f, st, tau, channel, collide,
                           use_reentrant=False)
        else:
            f = step(f, st, tau, channel, collide)
    return f


def adam_update(p, g, m, v, t: int, lr: float, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8):
    """Adam's step ``t`` (from 1), as Kingma & Ba (2015) write it: returns
    the new (p, m, v)."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    m_hat = m / (1 - beta1 ** t)
    v_hat = v / (1 - beta2 ** t)
    return p - lr * m_hat / (v_hat.sqrt() + eps), m, v
