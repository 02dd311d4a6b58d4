"""Shared helpers of the ``test_torch_*`` files: build the same flow in
``lettuce_tpu`` (JAX, on the CPU) and in ``lettuce_tpu_torch`` (torch, on
the CPU) and hand both one numpy state."""

import jax.numpy as jnp
import numpy as np
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from lettuce_tpu_torch import tracing

# dtype name -> (jax dtype, torch dtype, parity tolerance). float64 agrees
# to roundoff; float32 to the tolerance tests/test_native.py holds the
# Pallas kernel to against the jnp step.
DTYPES = {
    "float64": (jnp.float64, torch.float64, 1e-12),
    "float32": (jnp.float32, torch.float32, 5e-6),
}


def launch_counts(*kernels):
    """``{key: launches}`` of the kernels ``kernels`` (``"K1"`` ..
    ``"K4"``) in the port's launch counter."""
    return {key: n for key, n in tracing.counts.items()
            if key.split(":")[0] in kernels}


def contexts(dtype_name):
    """(lettuce_tpu context, lettuce_tpu_torch context), both on the CPU,
    both on the plain step path."""
    jax_dtype, torch_dtype, _ = DTYPES[dtype_name]
    return (lt.Context(dtype=jax_dtype, use_native=False),
            ltt.Context(device="cpu", dtype=torch_dtype, use_native=False))


def tgv_pair(dtype_name, resolution, stencil_name, **kwargs):
    """The same Taylor-Green vortex in both packages."""
    jctx, tctx = contexts(dtype_name)
    jflow = lt.TaylorGreenVortex(jctx, resolution, 1600, 0.05,
                                 stencil=getattr(lt, stencil_name)(),
                                 **kwargs)
    tflow = ltt.TaylorGreenVortex(tctx, resolution, 1600, 0.05,
                                  stencil=getattr(ltt, stencil_name)(),
                                  **kwargs)
    return jflow, tflow


def noisy_state(f, seed, scale=1e-3):
    """``f`` (any array) plus seeded numpy noise, as float64 numpy."""
    f = np.asarray(f, dtype=np.float64)
    return f + scale * np.random.default_rng(seed).standard_normal(f.shape)


def hand_state(jflow, tflow, f_np):
    """Put one numpy state onto both flows, each in its own dtype."""
    jflow.f = jnp.asarray(f_np, dtype=jflow.context.dtype)
    ltt.state_from_numpy(tflow, f_np)


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TorchTestFlow(ltt.ExtFlow):
    """The lettuce_tpu_torch twin of ``tests/conftest.py::TestFlow``:
    uniform p=0.01, u=1.01 everywhere; boundaries settable."""

    __test__ = False  # not a pytest collectible

    def __init__(self, context, resolution, reynolds_number=100,
                 mach_number=0.05, stencil=None, equilibrium=None,
                 boundaries=None):
        self._boundaries = boundaries or []
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    def make_resolution(self, resolution, stencil=None):
        return list(resolution)

    def make_units(self, reynolds_number, mach_number, resolution):
        return ltt.UnitConversion(
            reynolds_number=reynolds_number, mach_number=mach_number,
            characteristic_length_lu=resolution[0])

    def initial_pu(self):
        shape = tuple(self.resolution)
        return np.full((1,) + shape, 0.01), np.full((len(shape),) + shape,
                                                    1.01)

    @property
    def boundaries(self):
        return list(self._boundaries)


def boundary_flow_pair(dtype_name, resolution, stencil_name):
    """``tests/conftest.py::TestFlow`` and its torch twin, no boundaries
    yet (set ``_boundaries`` on each)."""
    from tests.conftest import TestFlow
    jctx, tctx = contexts(dtype_name)
    return (TestFlow(jctx, list(resolution),
                     stencil=getattr(lt, stencil_name)()),
            TorchTestFlow(tctx, list(resolution),
                          stencil=getattr(ltt, stencil_name)()))

