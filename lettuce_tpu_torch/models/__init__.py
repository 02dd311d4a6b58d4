from ._ext_flow import (ExtFlow, closed_grid, expand_resolution, face_mask,
                        periodic_grid)
from .taylorgreen import TaylorGreenVortex
from .couette import CouetteFlow2D
from .poiseuille import PoiseuilleFlow2D
from .doublyshear import DoublyPeriodicShear2D
from .decayingturbulence import DecayingTurbulence
from .mixinglayer import MixingLayer
from .obstacle import Obstacle, Obstacle2D, Obstacle3D
from .liddrivencavity import Cavity2D

from ..stencil import D2Q9, D3Q19

# CLI registry, as lettuce_tpu's
flow_by_name = {
    'taylor2d': (TaylorGreenVortex, D2Q9),
    'taylor3d': (TaylorGreenVortex, D3Q19),
    'poiseuille2d': (PoiseuilleFlow2D, D2Q9),
    'shear2d': (DoublyPeriodicShear2D, D2Q9),
    'couette2d': (CouetteFlow2D, D2Q9),
    'decay2d': (DecayingTurbulence, D2Q9),
    'mixing2d': (MixingLayer, D2Q9),
}

__all__ = ["ExtFlow", "TaylorGreenVortex", "CouetteFlow2D",
           "PoiseuilleFlow2D", "DoublyPeriodicShear2D", "DecayingTurbulence",
           "MixingLayer", "Obstacle",
           "Obstacle2D", "Obstacle3D", "Cavity2D", "closed_grid",
           "face_mask", "expand_resolution", "periodic_grid",
           "flow_by_name"]
