"""lettuce_tpu_torch: the PyTorch/CUDA port of lettuce_tpu.

The same API as ``lettuce_tpu`` for periodic and bounded flows (obstacle,
lid-driven cavity, Couette, Poiseuille, shear layers, decaying
turbulence, with their boundaries and forces) and its collision models
(BGK, TRT, MRT, regularized, KBC, Smagorinsky), on torch tensors on an
explicit ``torch.device``, with the fused collide-and-stream step, its
collision fragments and its BGK adjoint as hand-written CUDA kernels for
Hopper (``csrc/``). This package imports neither jax nor
``lettuce_tpu``.
"""

from .context import Context
from .stencil import (Stencil, TorchStencil,
                      D1Q3, D2Q9, D3Q15, D3Q19, D3Q27)
from .unit import UnitConversion
from .flow import (Equilibrium, Flow, Boundary, initialize_f_neq,
                   initialize_pressure_poisson, pressure_poisson,
                   state_from_numpy)
from .simulation import Collision, Reporter, Simulation
from .ops import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .reporters import (Observable, MaximumVelocity,
                        IncompressibleKineticEnergy, Enstrophy,
                        EnergySpectrum, Mass, ObservableReporter,
                        ErrorReporter, mean_analytic_error)
from .utils import *  # noqa: F401,F403

__version__ = "0.1.0"
