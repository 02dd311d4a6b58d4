from ._ext_flow import (ExtFlow, closed_grid, expand_resolution, face_mask,
                        periodic_grid)
from .taylorgreen import TaylorGreenVortex
from .couette import CouetteFlow2D
from .obstacle import Obstacle, Obstacle2D, Obstacle3D
from .liddrivencavity import Cavity2D

from ..stencil import D2Q9, D3Q19

# CLI registry: the flows ported so far
flow_by_name = {
    'taylor2d': (TaylorGreenVortex, D2Q9),
    'taylor3d': (TaylorGreenVortex, D3Q19),
    'couette2d': (CouetteFlow2D, D2Q9),
}

__all__ = ["ExtFlow", "TaylorGreenVortex", "CouetteFlow2D", "Obstacle",
           "Obstacle2D", "Obstacle3D", "Cavity2D", "closed_grid",
           "face_mask", "expand_resolution", "periodic_grid",
           "flow_by_name"]
