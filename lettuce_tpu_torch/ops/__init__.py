from .equilibrium import QuadraticEquilibrium, quadratic_feq
from .collision import Collision, BGKCollision, NoCollision, bgk_relax
from .streaming import stream

__all__ = ["QuadraticEquilibrium", "quadratic_feq", "Collision",
           "BGKCollision", "NoCollision", "bgk_relax", "stream"]
