from ._ext_flow import ExtFlow, expand_resolution, periodic_grid
from .taylorgreen import TaylorGreenVortex

from ..stencil import D2Q9, D3Q19

# CLI registry: the flows of the main path
flow_by_name = {
    'taylor2d': (TaylorGreenVortex, D2Q9),
    'taylor3d': (TaylorGreenVortex, D3Q19),
}

__all__ = ["ExtFlow", "TaylorGreenVortex", "expand_resolution",
           "periodic_grid", "flow_by_name"]
