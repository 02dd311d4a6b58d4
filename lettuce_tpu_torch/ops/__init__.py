from .equilibrium import QuadraticEquilibrium, quadratic_feq
from .collision import Collision, BGKCollision, NoCollision, bgk_relax
from .streaming import stream
from .boundary import (BounceBackBoundary, EquilibriumBoundaryPU,
                       AntiBounceBackOutlet, EquilibriumOutletP,
                       SpongeOutlet, PeriodicPressureBC,
                       combined_equilibrium_field, HYBRID_OUTLET_TYPES)

__all__ = ["QuadraticEquilibrium", "quadratic_feq", "Collision",
           "BGKCollision", "NoCollision", "bgk_relax", "stream",
           "BounceBackBoundary", "EquilibriumBoundaryPU",
           "AntiBounceBackOutlet", "EquilibriumOutletP", "SpongeOutlet",
           "PeriodicPressureBC", "combined_equilibrium_field",
           "HYBRID_OUTLET_TYPES"]
