"""Collision operators: BGK (no force) and the identity.

Each operator is a ``flow -> f_post`` map on the flow's current state.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

__all__ = ["Collision", "BGKCollision", "NoCollision", "bgk_relax"]


class Collision(ABC):
    """Collision protocol."""

    @abstractmethod
    def __call__(self, flow: "Flow") -> torch.Tensor:
        ...

    def native_available(self) -> bool:
        """True if this op can run inside the CUDA kernel."""
        return False

    def name(self) -> str:
        return self.__class__.__name__


def bgk_relax(f, feq, tau_inv):
    """f - 1/tau (f - feq)."""
    return f - tau_inv * (f - feq)


class BGKCollision(Collision):
    """Single-relaxation-time BGK."""

    def __init__(self, tau):
        self.tau = tau

    def __call__(self, flow: "Flow") -> torch.Tensor:
        feq = flow.equilibrium(flow, u=flow.u())
        return bgk_relax(flow.f, feq, 1.0 / self.tau)

    def native_available(self) -> bool:
        return True


class NoCollision(Collision):
    """Identity collision, used for streaming-only tests. The CUDA kernel
    carries the BGK fragment only, so this runs the torch step."""

    def __call__(self, flow: "Flow") -> torch.Tensor:
        return flow.f
