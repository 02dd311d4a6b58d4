"""Boundary conditions: the six boundaries of ``lettuce_tpu.ops.boundary``.

A boundary's ``__call__(flow)`` returns a full replacement field; the
Simulation composes it pointwise with
``where(no_collision_mask == index, replacement, f)``. Every operator is
out of place, so the torch step stays differentiable by autograd.

On the kernel path (``ops/cuda``) bounce back and the equilibrium
boundaries run inside the fused kernel, and the outlets of
``HYBRID_OUTLET_TYPES`` ride it through the window replay of
``ops/cuda/hybrid_outlets.py``, which calls ``window_view`` on the
boundaries whose fields carry positions. ``PeriodicPressureBC`` has no
kernel form and runs the torch step.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from ..flow import Boundary

__all__ = ["BounceBackBoundary", "EquilibriumBoundaryPU",
           "AntiBounceBackOutlet", "EquilibriumOutletP", "SpongeOutlet",
           "PeriodicPressureBC", "combined_equilibrium_field",
           "HYBRID_OUTLET_TYPES"]


def _periodic_take(x: torch.Tensor, dim: int, lo: int, width: int,
                   n: int) -> torch.Tensor:
    """The planes ``[lo, lo + width)`` (mod n) of ``x`` along ``dim``."""
    index = torch.as_tensor([(lo + k) % n for k in range(width)],
                            device=x.device)
    return torch.index_select(x, dim, index)


def combined_equilibrium_field(flow: "Flow", boundaries, no_collision_mask):
    """Combine every *per-node* EquilibriumBoundaryPU into one replacement
    field selected by the index-coded mask.

    Returns ``(feq_field, pernode_indices)``: ``feq_field`` is a
    ``[q, *resolution]`` tensor on the flow's device in its dtype (None
    when no per-node boundary exists). Uniform values are left out: the
    kernel takes them as constants.
    """
    feq_field = None
    pernode = []
    for index, boundary in enumerate(boundaries[1:], start=1):
        if not isinstance(boundary, EquilibriumBoundaryPU):
            continue
        rho = flow.units.convert_pressure_pu_to_density_lu(boundary.pressure)
        if boundary.velocity.ndim <= 1 and rho.ndim == 0:
            continue
        u = flow.units.convert_velocity_to_lu(boundary.velocity)
        feq = flow.equilibrium(flow, rho=rho, u=u)
        full = torch.broadcast_to(
            feq.reshape(feq.shape + (1,) * (flow.f.ndim - feq.ndim)),
            flow.f.shape)
        if feq_field is None:
            feq_field = torch.zeros_like(flow.f)
        feq_field = torch.where(no_collision_mask == index, full, feq_field)
        pernode.append(index)
    return feq_field, tuple(pernode)


class BounceBackBoundary(Boundary):
    """Full-way bounce back: f -> f[opposite] on masked solid nodes."""

    def __init__(self, mask):
        self._mask = mask

    def __call__(self, flow: "Flow") -> torch.Tensor:
        return flow.f[flow.torch_stencil.opposite]

    def make_no_streaming_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        return None

    def make_no_collision_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        return context.convert_to_tensor(self._mask, dtype=torch.bool)

    def native_available(self) -> bool:
        return True


class EquilibriumBoundaryPU(Boundary):
    """Fix f to the equilibrium of a prescribed physical-units velocity and
    pressure (inflow / moving wall). Velocity and pressure may be scalars,
    ``[d]`` vectors, or per-node fields that broadcast against the grid."""

    def __init__(self, context: "Context", mask, velocity, pressure=0):
        velocity = [velocity] if not hasattr(velocity, "__len__") \
            else velocity
        self.velocity = context.convert_to_tensor(
            np.asarray(velocity, dtype=np.float64))
        self.pressure = context.convert_to_tensor(
            np.asarray(pressure, dtype=np.float64))
        self._mask = mask

    def __call__(self, flow: "Flow") -> torch.Tensor:
        rho = flow.units.convert_pressure_pu_to_density_lu(self.pressure)
        u = flow.units.convert_velocity_to_lu(self.velocity)
        feq = flow.equilibrium(flow, rho, u)
        return torch.broadcast_to(
            feq.reshape(feq.shape + (1,) * (flow.f.ndim - feq.ndim)),
            flow.f.shape)

    def make_no_collision_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        return context.convert_to_tensor(self._mask, dtype=torch.bool)

    def make_no_streaming_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        return None

    def native_available(self) -> bool:
        return True

    def window_view(self, axis: int, win_lo: int, width: int,
                    n: int) -> "EquilibriumBoundaryPU":
        """Copy valid on the periodic window ``[win_lo, win_lo + width)``
        of grid ``axis``: per-node velocity/pressure fields are re-sliced
        when they span that axis; uniform or broadcast (size-1) values
        pass through."""

        def cut(value, lead):  # lead: leading dims before the grid
            dim = lead + axis
            if value.ndim <= dim or value.shape[dim] != n:
                return value
            return _periodic_take(value, dim, win_lo, width, n)

        clone = copy.copy(self)
        clone.velocity = cut(self.velocity, 1)
        clone.pressure = cut(self.pressure, 1 if self.pressure.ndim
                             > len(np.shape(self._mask)) else 0)
        return clone


class AntiBounceBackOutlet(Boundary):
    """Open outlet by anti-bounce-back on one domain face (Krueger et al.
    2016, p.195).

    ``direction`` is a list like ``[1, 0]`` / ``[0, 0, -1]`` selecting the
    face. The wall velocity is extrapolated linearly from the neighbouring
    plane; the opposite incoming directions get a no-streaming mask so they
    are frozen before replacement.
    """

    def __init__(self, direction: List[int], flow: "Flow",
                 collision: "Collision" = None):
        # kept for API parity with lettuce_tpu; the update never calls it
        self.collision = collision
        if len(direction) not in (1, 2, 3):
            raise ValueError(f"Invalid direction parameter. Expected "
                             f"direction of length 1, 2 or 3 but got "
                             f"{len(direction)}.")
        if not (list(direction).count(0) == len(direction) - 1
                and ((1 in direction) ^ (-1 in direction))):
            raise ValueError(f"Invalid direction parameter. Expected "
                             f"direction with all entries 0 except one 1 "
                             f"or -1 but got {direction}.")
        self.stencil = flow.torch_stencil
        self.direction = list(direction)
        self.face_axis = int(np.flatnonzero(direction)[0])
        self.face_sign = int(direction[self.face_axis])

        e = np.asarray(flow.stencil.e)
        # velocities pointing out of the domain through this face
        self.velocities = np.where(e @ np.asarray(direction) > 1 - 1e-6)[0]
        self._opposite = np.asarray(flow.stencil.opposite)[self.velocities]

        # the face plane as an index tuple into the grid axes
        self.index = [slice(None) if i == 0 else (-1 if i == 1 else 0)
                      for i in direction]

        w = np.asarray(flow.stencil.w)[self.velocities]
        self.w = torch.as_tensor(w.reshape((-1,) + (1,) * len(direction)),
                                 dtype=flow.context.dtype,
                                 device=flow.context.device)

    def _u_neighbor(self, u: torch.Tensor) -> torch.Tensor:
        """``u`` at each node's inward neighbour along the face axis, as a
        full-field roll; on the face plane this is the neighbour plane's
        value, elsewhere the no-collision mask discards it."""
        return torch.roll(u, self.face_sign, dims=self.face_axis + 1)

    def __call__(self, flow: "Flow") -> torch.Tensor:
        u = flow.u()
        u_w = 1.5 * u - 0.5 * self._u_neighbor(u)  # extrapolated wall u
        e_sel = self.stencil.e[self.velocities]    # [k, d]
        eu = torch.tensordot(e_sel, u_w, dims=1)   # [k, *res]
        unorm2 = torch.sum(u_w * u_w, dim=0)       # [*res]
        cs = self.stencil.cs
        rho = flow.rho()
        replacement = (-flow.f[self.velocities]
                       + self.w * rho
                       * (2 + eu ** 2 / cs ** 4 - unorm2 / cs ** 2))
        index = torch.as_tensor(self._opposite, device=flow.f.device)
        return flow.f.index_put((index,), replacement)

    def make_no_streaming_mask(self, shape: List[int], context: "Context"):
        mask = np.zeros(tuple(shape), dtype=bool)
        mask[tuple([self._opposite] + self.index)] = True
        return context.convert_to_tensor(mask)

    def make_no_collision_mask(self, shape: List[int], context: "Context"):
        mask = np.zeros(tuple(shape), dtype=bool)
        mask[tuple(self.index)] = True
        return context.convert_to_tensor(mask)

    def native_available(self) -> bool:
        # runs with the fused kernel through the window replay; the exact
        # type check keeps subclasses whose __call__ the replay does not
        # know out, unless they join HYBRID_OUTLET_TYPES (which the kernel
        # gate reads too)
        return type(self) in HYBRID_OUTLET_TYPES


class EquilibriumOutletP(AntiBounceBackOutlet):
    """Constant-pressure equilibrium outlet: the face is set to
    feq(rho_outlet, u_neighbor); all non-outgoing directions get a
    no-streaming mask on the face."""

    def __init__(self, direction: List[int], flow: "Flow",
                 rho_outlet: float = 1.0):
        super().__init__(direction, flow)
        self.rho_outlet = flow.context.convert_to_tensor(rho_outlet)

    def __call__(self, flow: "Flow") -> torch.Tensor:
        rho = flow.rho()
        u = flow.u()
        rho_w = self.rho_outlet * torch.ones_like(rho)
        u_w = self._u_neighbor(u)
        return flow.equilibrium(flow, rho_w, u_w)

    def make_no_streaming_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        mask = np.zeros(tuple(shape), dtype=bool)
        complement = np.setdiff1d(np.arange(shape[0]), self.velocities)
        mask[tuple([complement] + self.index)] = True
        return context.convert_to_tensor(mask)


class PeriodicPressureBC(Boundary):
    """Pressure-difference driving across a periodic axis.

    Populations entering through the low face of ``axis`` gain
    ``+w_q * delta_rho_lu`` and those entering through the high face lose
    it, which imposes a body-force-free pressure drop
    ``delta_rho_lu * cs^2`` over the periodic domain length. The face
    nodes collide normally (pass the simulation's collision operator) and
    the jump is added on top. Nodes in ``exclude_mask`` are left to their
    own boundary. No kernel form: a simulation with it runs the torch
    step.
    """

    def __init__(self, flow: "Flow", delta_rho_lu: float,
                 collision: "Collision", axis: int = 0,
                 exclude_mask=None):
        self.collision = collision
        self.axis = int(axis)
        self.delta_rho_lu = float(delta_rho_lu)
        self.exclude_mask = (None if exclude_mask is None
                             else np.asarray(exclude_mask, dtype=bool))
        e = np.asarray(flow.stencil.e)
        w = np.asarray(flow.stencil.w)
        n = flow.resolution[self.axis]
        jump = np.zeros((flow.stencil.q, n))
        jump[e[:, self.axis] > 0, 0] = w[e[:, self.axis] > 0]
        jump[e[:, self.axis] < 0, -1] = -w[e[:, self.axis] < 0]
        shape = [flow.stencil.q] + [1] * len(flow.resolution)
        shape[self.axis + 1] = n
        self._jump = flow.context.convert_to_tensor(
            self.delta_rho_lu * jump.reshape(shape))

    def __call__(self, flow: "Flow") -> torch.Tensor:
        return self.collision(flow) + self._jump

    def make_no_collision_mask(self, shape: List[int], context: "Context"):
        mask = np.zeros(tuple(shape), dtype=bool)
        sel = [slice(None)] * len(shape)
        sel[self.axis] = 0
        mask[tuple(sel)] = True
        sel[self.axis] = -1
        mask[tuple(sel)] = True
        if self.exclude_mask is not None:
            mask &= ~self.exclude_mask
        return context.convert_to_tensor(mask)

    def make_no_streaming_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        return None


class SpongeOutlet(AntiBounceBackOutlet):
    """Anti-bounce-back outlet with an absorbing sponge layer: the face
    keeps the anti-bounce-back update, and the ``depth`` planes upstream
    of it relax toward feq(rho0, u_local) with a quadratically ramped
    strength, so pressure waves entering the layer are damped instead of
    reflected."""

    def __init__(self, direction: List[int], flow: "Flow",
                 depth: int = 8, strength: float = 0.3, rho0: float = 1.0):
        super().__init__(direction, flow)
        self.depth = int(depth)
        self.strength = float(strength)
        self.rho0 = float(rho0)
        # the ramp and the face selector as per-plane fields along the
        # face axis (what window_view re-slices)
        n = flow.resolution[self.face_axis]
        pos = np.arange(n, dtype=np.float64)
        dist = (n - 1 - pos) if self.face_sign == 1 else pos
        ramp = np.clip(1.0 - dist / max(1, self.depth), 0.0, 1.0) ** 2
        shape = [1] * len(flow.resolution)
        shape[self.face_axis] = n
        self._sigma = flow.context.convert_to_tensor(
            self.strength * ramp.reshape(shape))
        self._face_field = flow.context.convert_to_tensor(
            (dist == 0).reshape(shape))

    def __call__(self, flow: "Flow") -> torch.Tensor:
        rho_w = self.rho0 * torch.ones_like(flow.rho())
        feq = flow.equilibrium(flow, rho_w, flow.u())
        sponged = flow.f + self._sigma * (feq - flow.f)
        abb = super().__call__(flow)
        return torch.where(self._face_field, abb, sponged)

    def window_view(self, axis: int, win_lo: int, width: int,
                    n: int) -> "SpongeOutlet":
        """Shallow copy valid on the periodic window
        ``[win_lo, win_lo + width)`` of grid ``axis``: the ramp and the
        face selector are re-sliced when the window runs along the face
        axis."""
        if axis != self.face_axis:
            return self
        clone = copy.copy(self)
        clone._sigma = _periodic_take(self._sigma, axis, win_lo, width, n)
        clone._face_field = _periodic_take(self._face_field, axis, win_lo,
                                           width, n)
        return clone

    def make_no_collision_mask(self, shape: List[int], context: "Context"):
        mask = np.zeros(tuple(shape), dtype=bool)
        n = shape[self.face_axis]
        sel = [slice(None)] * len(shape)
        if self.face_sign == 1:
            sel[self.face_axis] = slice(n - 1 - self.depth, n)
        else:
            sel[self.face_axis] = slice(0, self.depth + 1)
        mask[tuple(sel)] = True
        return context.convert_to_tensor(mask)


# Outlet types that ride the fused kernel through the window replay
# (ops/cuda/hybrid_outlets.py). One tuple keeps ``native_available()`` and
# the kernel gate in agreement; subclasses opt in by being added here.
HYBRID_OUTLET_TYPES = (AntiBounceBackOutlet, EquilibriumOutletP,
                       SpongeOutlet)
