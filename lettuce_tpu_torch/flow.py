"""Flow: physical configuration + simulation state, and its observables.

A ``Flow`` holds its configuration plus the state tensor ``f`` (shape
``[q, *resolution]``, on the context's device) and the step counter ``i``.
Observables are functions of ``(config, f)``; :meth:`Flow.view` substitutes
another state without touching the flow, so collisions and reporters can
evaluate a state the flow does not hold.
"""

from __future__ import annotations

import copy
import pickle
from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np
import torch

from . import tracing
from .stencil import TorchStencil
from .utils.utility import torch_gradient, torch_jacobi

__all__ = ["Equilibrium", "Flow", "Boundary", "initialize_f_neq",
           "initialize_pressure_poisson", "pressure_poisson",
           "state_from_numpy"]


class Equilibrium(ABC):
    @abstractmethod
    def __call__(self, flow: "Flow", rho=None, u=None) -> torch.Tensor:
        ...

    def native_available(self) -> bool:
        """True if this equilibrium can run inside the CUDA kernel."""
        return False


class Boundary(ABC):
    """Boundary protocol.

    ``__call__`` returns a full-field replacement for ``f``; the Simulation
    applies it where ``no_collision_mask == boundary_index``. The two mask
    constructors return a node mask (-> no collision) and a per-(q, node)
    mask (-> no streaming), or ``None``.
    """

    @abstractmethod
    def __call__(self, flow: "Flow") -> torch.Tensor:
        ...

    @abstractmethod
    def make_no_collision_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        ...

    @abstractmethod
    def make_no_streaming_mask(self, shape: List[int], context: "Context"
                               ) -> Optional[torch.Tensor]:
        ...

    def native_available(self) -> bool:
        return False


class Flow(ABC):
    """Physical configuration and state of a simulation."""

    def __init__(self, context: "Context", resolution: List[int],
                 units: "UnitConversion", stencil: "Stencil",
                 equilibrium: "Equilibrium"):
        self.context = context
        self.resolution = list(resolution)
        self.units = units
        self.stencil = stencil
        self.torch_stencil = TorchStencil(stencil, context)
        self.equilibrium = equilibrium

        self.i = 0
        self.f = context.zero_tensor([stencil.q, *resolution])

        self.initialize()

    def view(self, f: torch.Tensor, i=None) -> "Flow":
        """Shallow copy with the state tensor replaced."""
        v = copy.copy(self)
        v.f = f
        if i is not None:
            v.i = i
        return v

    # ------------------------------------------------------------------
    # abstract configuration
    # ------------------------------------------------------------------
    @property
    @abstractmethod
    def boundaries(self) -> List["Boundary"]:
        return []

    @abstractmethod
    def initial_pu(self):
        """Initial (p, u) in physical units."""
        ...

    initialize_pressure: bool = False
    initialize_fneq: bool = False

    def initialize(self):
        """Initialise ``f`` at equilibrium from ``initial_pu``, with the
        optional pressure-Poisson density and the optional non-equilibrium
        (f^neq) part."""
        initial_p, initial_u = self.initial_pu()
        rho = self.context.convert_to_tensor(
            self.units.convert_pressure_pu_to_density_lu(
                self.context.convert_to_tensor(initial_p)))
        u = self.context.convert_to_tensor(
            self.units.convert_velocity_to_lu(
                self.context.convert_to_tensor(initial_u)))
        if self.initialize_pressure:
            rho = pressure_poisson(self.units, u, rho)
        f = self.equilibrium(self, rho=rho, u=u)
        if self.initialize_fneq:
            f = initialize_f_neq(self.view(f))
        self.f = f.contiguous()

    # ------------------------------------------------------------------
    # observables
    # ------------------------------------------------------------------
    def rho(self, f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Density, shape [1, *resolution]."""
        return torch.sum(self.f if f is None else f, dim=0, keepdim=True)

    @property
    def rho_pu(self) -> torch.Tensor:
        return self.units.convert_density_to_pu(self.rho())

    @property
    def p_pu(self) -> torch.Tensor:
        return self.units.convert_density_lu_to_pressure_pu(self.rho())

    @property
    def u_pu(self) -> torch.Tensor:
        return self.units.convert_velocity_to_pu(self.u())

    def j(self, f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Momentum, shape [d, *resolution]."""
        return torch.tensordot(self.torch_stencil.e.T,
                               self.f if f is None else f, dims=1)

    def u(self, f: Optional[torch.Tensor] = None, rho=None,
          acceleration=None) -> torch.Tensor:
        """Velocity, shape [d, *resolution]; with a forcing scheme,
        ``acceleration`` adds the Guo half-step correction a/(2 rho).

        A CUDA state the velocity kernel takes (:func:`.ops.cuda.moments.
        takes`), with neither ``rho`` nor ``acceleration`` given, runs one
        K5 launch (its adjoint under autograd); every other call runs the
        expression j / rho, counted as ``moments_torch`` on the card."""
        from .ops.cuda import moments  # the ops package imports this module
        state = self.f if f is None else f
        if rho is None and acceleration is None:
            name = moments.takes(state, self.stencil.e)
            if name is not None:
                return moments.velocity(state, self.stencil.e, name)
        if state.is_cuda:
            tracing.count("moments_torch")
        rho = self.rho(f=f) if rho is None else rho
        v = self.j(f=f) / rho
        if acceleration is None:
            return v
        acceleration = torch.as_tensor(acceleration, dtype=v.dtype,
                                       device=v.device)
        if acceleration.ndim == 1:
            acceleration = acceleration.reshape(
                acceleration.shape + (1,) * self.stencil.d)
        return v + acceleration / (2 * rho)

    @property
    def velocity(self) -> torch.Tensor:
        return self.j() / self.rho()

    def incompressible_energy(self, f: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """Pointwise incompressible kinetic energy 0.5 |u|^2."""
        u = self.u(f)
        return 0.5 * torch.sum(u * u, dim=0)

    def shear_tensor(self, f: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Pi_ab = sum_q f_q e_qa e_qb, shape [d, d, *resolution]."""
        from .ops.collision import shear_tensor
        return shear_tensor(self.torch_stencil.e, self.f if f is None else f)

    def einsum(self, equation, fields, *args) -> torch.Tensor:
        """Shape-polymorphic Einstein summation: trailing grid axes are
        auto-appended."""
        inputs, output = equation.split("->")
        inputs = inputs.split(",")
        for idx, inp in enumerate(inputs):
            if len(inp) == fields[idx].ndim:
                pass
            elif len(inp) == fields[idx].ndim - self.stencil.d:
                inputs[idx] += "..."
                if not output.endswith("..."):
                    output += "..."
            else:
                raise ValueError("Bad dimension.")
        equation = ",".join(inputs) + "->" + output
        return torch.einsum(equation, *fields, *args)

    # ------------------------------------------------------------------
    # checkpointing: the same pickle as lettuce_tpu's Flow.dump,
    # {"f": ndarray [q, *res], "i": int}; a 16-bit state is written as
    # float32 (exact), since numpy has no bfloat16
    # ------------------------------------------------------------------
    def dump(self, filename):
        with open(filename, "wb") as file:
            pickle.dump({"f": self.context.convert_to_ndarray(self.f),
                         "i": self.i}, file)

    def load(self, filename):
        """Read a state written by ``dump`` (of either package). The file is
        unpickled: load only files this program wrote."""
        with open(filename, "rb") as file:
            payload = pickle.load(file)
        if isinstance(payload, dict):
            state_from_numpy(self, payload["f"], int(payload.get("i", 0)))
        else:  # a bare state array
            state_from_numpy(self, payload)


def state_from_numpy(flow: "Flow", f: np.ndarray, i: int = 0) -> None:
    """Put a numpy ``[q, *resolution]`` state onto ``flow``, on the flow's
    device and in its dtype, and set its step counter to ``i``. An
    ``ml_dtypes.bfloat16`` array (lettuce_tpu's bfloat16 pickle), which
    torch cannot read, goes through float32, which holds it exactly."""
    f = np.asarray(f)
    if f.dtype.kind == "V":  # ml_dtypes' floats are numpy void types
        f = np.asarray(f, dtype=np.float32)
    expected = (flow.stencil.q, *flow.resolution)
    if f.shape != expected:
        raise ValueError(f"state has shape {f.shape}, the flow needs "
                         f"{expected}")
    # copy: the flow never shares memory with the caller's array
    flow.f = torch.as_tensor(f).to(device=flow.context.device,
                                   dtype=flow.context.dtype,
                                   copy=True).contiguous()
    flow.i = int(i)


# ----------------------------------------------------------------------
# initialisation helpers
# ----------------------------------------------------------------------
def pressure_poisson(units: "UnitConversion", u, rho0, tol_abs=1e-10,
                     max_num_steps=100000):
    """Density from the pressure Poisson equation, solved by Jacobi
    iteration: rhs = -d_i d_j (u_i u_j) by periodic finite differences."""
    dx = units.convert_length_to_pu(1.0)
    u = units.convert_velocity_to_pu(u)
    p = units.convert_density_lu_to_pressure_pu(rho0)

    dim = u.shape[0]
    u_mod = torch.zeros_like(u[0])
    for i in range(dim):
        for j in range(dim):
            derivative = torch_gradient(
                torch_gradient(u[i] * u[j], dx)[i], dx)[j]
            u_mod = u_mod - derivative

    p_mod = torch_jacobi(u_mod, p[0], dx, dim=dim, tol_abs=tol_abs,
                         max_num_steps=max_num_steps)[None, ...]
    return units.convert_pressure_pu_to_density_lu(p_mod)


def initialize_pressure_poisson(flow: "Flow", max_num_steps=100000,
                                tol_pressure=1e-6):
    """Re-equilibrate with the Jacobi-solved pressure (call before
    ``initialize_f_neq``)."""
    u = flow.u()
    rho = pressure_poisson(flow.units, u, flow.rho(), tol_abs=tol_pressure,
                           max_num_steps=max_num_steps)
    return flow.equilibrium(flow, rho=rho, u=u)


def initialize_f_neq(flow: "Flow"):
    """Add first-order (f^1) contributions approximated by 6th-order finite
    differences of the strain rate (Krueger et al. 2017)."""
    rho = flow.rho()
    u = flow.u()

    grads = [torch_gradient(u[i], dx=1, order=6)[None, ...]
             for i in range(flow.stencil.d)]
    S = torch.cat(grads)  # [d, d, *res]

    Pi_1 = (flow.units.relaxation_parameter_lu * rho * S
            / flow.torch_stencil.cs ** 2)
    e = flow.torch_stencil.e
    Q = (e[:, :, None] * e[:, None, :]
         - torch.eye(flow.stencil.d, dtype=e.dtype, device=e.device)
         * flow.stencil.cs ** 2)
    Pi_1_Q = flow.einsum("ab,iab->i", [Pi_1, Q])
    w = flow.torch_stencil.w.reshape((-1,) + (1,) * flow.stencil.d)
    fneq = w * Pi_1_Q

    feq = flow.equilibrium(flow, rho, u)
    return feq - fneq
