"""Base class and shared grid/mask helpers for the concrete flow cases:
subclasses supply ``make_resolution`` / ``make_units`` / ``initial_pu`` /
``boundaries``."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Union

import numpy as np
import torch

from ..flow import Flow
from ..ops.equilibrium import QuadraticEquilibrium
from ..stencil import D1Q3, D2Q9, D3Q19

__all__ = ["ExtFlow", "periodic_grid", "closed_grid", "face_mask",
           "expand_resolution"]

_DEFAULT_STENCILS = (D1Q3, D2Q9, D3Q19)


def expand_resolution(resolution: Union[int, List[int]], d: int,
                      allowed=None) -> List[int]:
    """Normalise an int-or-list resolution to a d-long list."""
    if isinstance(resolution, int):
        return [resolution] * d
    if allowed is not None and len(resolution) not in allowed:
        raise ValueError(f"resolution must have {allowed} axes, "
                         f"got {len(resolution)}")
    return list(resolution)


def periodic_grid(resolution, extent: float, dtype, device):
    """Node coordinates of a periodic box [0, extent): the last node stops
    one spacing short of the extent (it wraps onto node 0)."""
    axes = [torch.arange(n, dtype=dtype, device=device) * (extent / n)
            for n in resolution]
    return torch.meshgrid(*axes, indexing="ij")


def closed_grid(resolution, extent: float, dtype, device):
    """Node coordinates of a wall-bounded box [0, extent], endpoints
    included (first/last nodes sit ON the walls)."""
    axes = [torch.linspace(0, extent, n, dtype=dtype, device=device)
            for n in resolution]
    return torch.meshgrid(*axes, indexing="ij")


def face_mask(resolution, axis: int, end: int, exclude_corners=()):
    """Boolean numpy mask of one domain face: ``end`` is 0 (low face) or
    -1 (high face). Axes listed in ``exclude_corners`` drop their first
    node from the face (used to give wall/lid corners a unique owner)."""
    m = np.zeros(tuple(resolution), dtype=bool)
    sel = [slice(None)] * len(resolution)
    sel[axis] = end
    m[tuple(sel)] = True
    for a in exclude_corners:
        sel2 = [slice(None)] * len(resolution)
        sel2[a] = 0
        m[tuple(sel2)] = False
    return m


class ExtFlow(Flow, ABC):
    """Template-method flow base: normalises the resolution, picks the
    default stencil for the dimension and the quadratic equilibrium, then
    defers the physics to the subclass hooks."""

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None):
        resolution = self.make_resolution(resolution, stencil)
        d = len(resolution)
        if not 1 <= d <= 3:
            raise ValueError(f"flows support 1-3 dimensions, got {d}")
        if stencil is None:
            stencil = _DEFAULT_STENCILS[d - 1]()
        elif callable(stencil):
            stencil = stencil()
        units = self.make_units(reynolds_number, mach_number, resolution)
        Flow.__init__(self, context, resolution, units, stencil,
                      equilibrium or QuadraticEquilibrium())

    @abstractmethod
    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        """Normalise the user-given resolution to a per-axis list."""

    @abstractmethod
    def make_units(self, reynolds_number, mach_number,
                   resolution: List[int]) -> "UnitConversion":
        """Build the unit system for this case's characteristic scales."""
