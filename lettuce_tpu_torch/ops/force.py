"""Forcing schemes: Guo and Shan-Chen.

A ``Force`` contributes a velocity shift ``u_eq`` (applied inside the
collision's equilibrium velocity) and an additive source term ``S_i``.
A uniform (per-axis constant) acceleration runs inside the CUDA kernel's
forced-BGK fragment; a per-node acceleration runs the torch step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from ..utils.utility import append_axes

__all__ = ["Force", "Guo", "ShanChen", "guo_source"]


def _per_node(acceleration: torch.Tensor, d: int) -> torch.Tensor:
    """A uniform ``[d]`` acceleration with ``d`` grid axes appended; a
    per-node ``[d, *grid]`` one as it is."""
    return (append_axes(acceleration, d) if acceleration.ndim == 1
            else acceleration)


def guo_source(e: torch.Tensor, w: torch.Tensor, cs: float, u: torch.Tensor,
               acceleration: torch.Tensor, prefactor: float) -> torch.Tensor:
    """S_i = prefactor w_i ((e_i - u)/cs^2 + (e_i.u) e_i / cs^4) . a, shape
    ``[q, *grid]``; ``e`` is ``[q, d]``, ``u`` ``[d, *grid]`` and
    ``acceleration`` ``[d]`` or ``[d, *grid]``."""
    grid = u.ndim - 1
    emu = append_axes(e, grid) - u                          # [q, d, *grid]
    eu = torch.tensordot(e, u, dims=1)                      # [q, *grid]
    eeu = append_axes(e, grid) * eu[:, None]                # [q, d, *grid]
    emu_eeu = emu / (cs ** 2) + eeu / (cs ** 4)
    a = _per_node(acceleration, grid)
    emu_eeu_a = torch.sum(emu_eeu * a[None], dim=1)         # [q, *grid]
    return prefactor * (append_axes(w, grid) * emu_eeu_a)


class Force(ABC):
    @abstractmethod
    def source_term(self, u):
        ...

    @abstractmethod
    def u_eq(self, flow: "Flow"):
        ...

    @property
    @abstractmethod
    def ueq_scaling_factor(self):
        ...

    def native_available(self) -> bool:
        """True when this force can run inside the CUDA kernel: a uniform
        (per-axis constant) acceleration."""
        accel = getattr(self, "acceleration", None)
        return accel is not None and accel.ndim == 1


class Guo(Force):
    """Guo forcing: S_i = (1 - 1/(2 tau)) w_i ((e_i - u)/cs^2
    + (e_i.u) e_i / cs^4) . a, with u_eq shift a/(2 rho)."""

    def __init__(self, flow: "Flow", tau, acceleration):
        self.flow = flow
        self.tau = tau
        self.acceleration = flow.context.convert_to_tensor(acceleration)

    def source_term(self, u) -> torch.Tensor:
        st = self.flow.torch_stencil
        return guo_source(st.e, st.w, st.cs, u, self.acceleration,
                          1 - 1 / (2 * self.tau))

    def u_eq(self, flow: "Flow" = None) -> torch.Tensor:
        flow = self.flow if flow is None else flow
        return (self.ueq_scaling_factor
                * _per_node(self.acceleration, flow.stencil.d)
                / flow.rho())

    @property
    def ueq_scaling_factor(self):
        return 0.5


class ShanChen(Force):
    """Shan-Chen velocity-shift forcing: u_eq = tau a / rho, no source
    term."""

    def __init__(self, flow: "Flow", tau, acceleration):
        self.flow = flow
        self.tau = tau
        self.acceleration = flow.context.convert_to_tensor(acceleration)

    def source_term(self, u):
        return 0

    def u_eq(self, flow: "Flow") -> torch.Tensor:
        return (self.ueq_scaling_factor
                * _per_node(self.acceleration, flow.stencil.d)
                / flow.rho())

    @property
    def ueq_scaling_factor(self):
        return self.tau * 1
