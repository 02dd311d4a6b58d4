from .equilibrium import QuadraticEquilibrium, quadratic_feq
from .collision import (Collision, BGKCollision, NoCollision, TRTCollision,
                        MRTCollision, RegularizedCollision, KBCCollision,
                        KBCCollision2D, KBCCollision3D, SmagorinskyCollision,
                        bgk_relax)
from .force import Force, Guo, ShanChen
from .streaming import stream
from .boundary import (BounceBackBoundary, EquilibriumBoundaryPU,
                       AntiBounceBackOutlet, EquilibriumOutletP,
                       SpongeOutlet, PeriodicPressureBC,
                       combined_equilibrium_field, HYBRID_OUTLET_TYPES)
from .utils_moments_shim import resolve_mrt_spec

__all__ = ["QuadraticEquilibrium", "quadratic_feq", "Collision",
           "BGKCollision", "NoCollision", "TRTCollision", "MRTCollision",
           "RegularizedCollision", "KBCCollision", "KBCCollision2D",
           "KBCCollision3D", "SmagorinskyCollision", "bgk_relax", "Force",
           "Guo", "ShanChen", "stream", "BounceBackBoundary",
           "EquilibriumBoundaryPU", "AntiBounceBackOutlet",
           "EquilibriumOutletP", "SpongeOutlet", "PeriodicPressureBC",
           "combined_equilibrium_field", "HYBRID_OUTLET_TYPES",
           "resolve_mrt_spec"]
