"""lettuce_tpu_torch: the PyTorch/CUDA port of lettuce_tpu.

The same API as ``lettuce_tpu`` for BGK flows, periodic and bounded
(obstacle, lid-driven cavity, Couette, with their boundaries), on torch
tensors on an explicit ``torch.device``, with the fused collide-and-stream
step and its adjoint as hand-written CUDA kernels for Hopper
(``csrc/stream_collide.cu``, ``csrc/adjoint.cu``). This package imports
neither jax nor ``lettuce_tpu``.
"""

from .context import Context
from .stencil import (Stencil, TorchStencil,
                      D1Q3, D2Q9, D3Q15, D3Q19, D3Q27)
from .unit import UnitConversion
from .flow import (Equilibrium, Flow, Boundary, initialize_f_neq,
                   state_from_numpy)
from .simulation import Collision, Reporter, Simulation
from .ops import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .reporters import (Observable, MaximumVelocity,
                        IncompressibleKineticEnergy, Mass,
                        ObservableReporter, ErrorReporter,
                        mean_analytic_error)
from .utils import torch_gradient

__version__ = "0.1.0"
