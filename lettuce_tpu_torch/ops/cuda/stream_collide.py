"""Fused BGK collide-and-stream step: the hand-written CUDA kernel, its
plain PyTorch version, and the simulation gate that selects it.

The kernel (``lettuce_tpu_torch/csrc/stream_collide.cu``) replaces
``lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel`` for
the periodic BGK configuration (no masks, one step per launch) in float32
and float64, for D2Q9, D3Q15, D3Q19 and D3Q27. It is bound by device
memory: D3Q19 in float32 moves 19*4 bytes in and 19*4 bytes out per cell,
152 B per lattice update, and the design reads each population once and
writes it once (see the source for how). Its emit-u instances also write
the pre-collision velocity, the residual of the adjoint kernel
(:mod:`.adjoint`): 164 B per D3Q19 float32 update.

The source is built and loaded by :mod:`.build`. :func:`stream_collide`
runs the plain version only for a CPU tensor. For a CUDA tensor it
launches the kernel or raises; a CUDA state that requires grad goes
through :func:`.fused_step.fused_step`, the autograd route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..collision import BGKCollision, bgk_relax
from ..equilibrium import QuadraticEquilibrium, quadratic_feq
from ..streaming import stream
from .build import (DTYPES, KERNEL_STENCIL_NAMES, KERNEL_STENCILS,
                    check_launch, check_out, kernel_stencil_name,
                    launch_dims, open_library)

__all__ = ["stream_collide", "stream_collide_plain", "load_library",
           "gate_fused_params", "kernel_stencil_name", "KERNEL_STENCILS"]


# ----------------------------------------------------------------------
# the plain PyTorch version
# ----------------------------------------------------------------------
def stream_collide_plain(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                         opposite: np.ndarray, cs: float, tau_inv: float,
                         emit_u: bool = False):
    """One BGK collide-and-stream step in plain PyTorch: the quadratic
    equilibrium, BGK relaxation, then a per-q ``torch.roll``. With
    ``emit_u`` it returns ``(out, u)``, u = j / rho the pre-collision
    velocity ``[d, *grid]``."""
    et = torch.as_tensor(np.asarray(e), dtype=f.dtype, device=f.device)
    wt = torch.as_tensor(np.asarray(w), dtype=f.dtype, device=f.device)
    rho = torch.sum(f, dim=0, keepdim=True)
    u = torch.tensordot(et.T, f, dims=1) / rho
    feq = quadratic_feq(et, wt, cs, rho, u)
    out = stream(bgk_relax(f, feq, tau_inv), e)
    return (out, u) if emit_u else out


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ``argtypes``
    set on every entry."""
    lib = open_library("stream_collide")
    for name in KERNEL_STENCIL_NAMES:
        for suffix, scalar in DTYPES.values():
            grid = [ctypes.c_int64] * 3
            tail = [scalar, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
            fn = getattr(lib, f"lt_stream_collide_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 2 + grid + tail
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lt_stream_collide_emit_u_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 3 + grid + tail
            fn.restype = ctypes.c_int
    return lib


def stream_collide(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                   opposite: np.ndarray, cs: float, tau_inv: float,
                   out: torch.Tensor = None, u_out: torch.Tensor = None):
    """One fused BGK collide-and-stream step ``f -> out``.

    ``f`` is ``[q, X, Y]`` or ``[q, X, Y, Z]``. On a CPU tensor this is
    :func:`stream_collide_plain`; on a CUDA tensor it launches the kernel
    (allocating ``out`` when none is given) or raises. ``out`` must not be
    ``f``: the kernel pushes to neighbours. With ``u_out`` (``[d, *grid]``)
    the emit-u kernel also writes the pre-collision velocity there, and
    the call returns ``(out, u_out)``.

    A CUDA state that requires grad, with grad mode on, goes through
    :func:`.fused_step.fused_step` (fresh output, adjoint kernel backward);
    ``out`` and ``u_out`` cannot be given then.
    """
    emit_u = u_out is not None
    if f.device.type == "cpu":
        result = stream_collide_plain(f, e, w, opposite, cs, tau_inv,
                                      emit_u=emit_u)
        if emit_u:
            result, u = result
            u_out.copy_(u)
        out = result if out is None else out.copy_(result)
        return (out, u_out) if emit_u else out
    if f.device.type != "cuda":
        raise ValueError(f"stream_collide runs on cpu or cuda tensors, "
                         f"got {f.device}")
    if f.requires_grad and torch.is_grad_enabled():
        if out is not None or emit_u:
            raise ValueError("out and u_out would bypass autograd: a state "
                             "that requires grad takes neither")
        from .fused_step import fused_step
        return fused_step(f, e=e, w=w, opposite=opposite, cs=cs,
                          tau_inv=tau_inv)
    name = kernel_stencil_name(e, w, opposite)
    n0, n1, n2 = launch_dims(f, e)
    out = check_out(out, f, f.shape, "out", f)
    if emit_u:
        d = np.asarray(e).shape[1]
        u_out = check_out(u_out, f, (d, *f.shape[1:]), "u_out", f, out)

    lib = load_library()
    pointers = [f.data_ptr(), out.data_ptr()]
    variant = ""
    if emit_u:
        pointers.append(u_out.data_ptr())
        variant = "emit_u_"
    launch = getattr(lib, f"lt_stream_collide_{variant}{name}_"
                          f"{DTYPES[f.dtype][0]}")
    rc = launch(*pointers, n0, n1, n2, float(tau_inv), float(cs),
                f.device.index,
                torch.cuda.current_stream(f.device).cuda_stream)
    check_launch(lib, rc, "stream_collide (emit u)" if emit_u
                 else "stream_collide")
    if emit_u:
        stream_collide.emit_u_launches += 1
        return out, u_out
    stream_collide.launches += 1
    return out


stream_collide.launches = 0         # primal kernel launches
stream_collide.emit_u_launches = 0  # emit-u kernel launches


# ----------------------------------------------------------------------
# the simulation gate
# ----------------------------------------------------------------------
def gate_fused_params(simulation: "Simulation") -> dict:
    """Static kernel parameters for a Simulation; raises when the
    configuration cannot run inside the kernel, which takes a compiled
    stencil, float32 or float64 state, the quadratic equilibrium, BGK
    without force and no boundaries."""
    flow = simulation.flow
    stencil = flow.stencil
    kernel_stencil_name(stencil.e, stencil.w, stencil.opposite)
    if flow.context.dtype not in DTYPES:
        raise NotImplementedError(
            f"the CUDA kernel runs float32 and float64 state, not "
            f"{flow.context.dtype}; use_native=False runs the torch step")
    if not isinstance(flow.equilibrium, QuadraticEquilibrium):
        raise NotImplementedError(type(flow.equilibrium).__name__)
    if not isinstance(simulation.collision, BGKCollision):
        raise NotImplementedError(type(simulation.collision).__name__)
    if (simulation.no_collision_mask is not None
            or simulation.no_streaming_mask is not None):
        raise NotImplementedError("boundary masks")
    return dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                cs=float(stencil.cs),
                tau_inv=float(1.0 / simulation.collision.tau))
