"""The velocity moment of a state and its adjoint: the hand-written CUDA
kernel pair K5 (``csrc/moments.cu``), their plain PyTorch versions, and the
autograd Function that :meth:`.Flow.u` takes on the card.

For a state ``f`` of shape ``[q, *grid]`` and the stencil's velocities
``e`` (``[q, d]``)::

    rho = sum_q f_q,   u = (sum_q e_q f_q) / rho,
    grad f_q = (e_q . g - u . g) / rho   (g the cotangent of u),

the exact vector-Jacobian product. The kernels replace no kernel of
lettuce_tpu (its ``Flow.u`` is jnp, fused by XLA); they exist because the
same expression in eager PyTorch is a reduction, a cuBLAS product and a
broadcast division, and its autograd backward three more passes, where one
pass each way reads and writes each value once (``csrc/moments.cu``'s
note).

:func:`velocity` is the entry: on a CUDA state it launches K5 (and, under
autograd, the Function saves u and rho, float32, and its backward launches
the adjoint kernel), on a CPU state it runs the plain versions. The kernels
take contiguous float32, bfloat16 and float16 states of D1Q3, D2Q9, D3Q15,
D3Q19 and D3Q27 (:func:`takes`), compute in float32 and write u in the
state's dtype. The plain versions compute in :func:`.build.compute_dtype`
(float64 for float64, else float32) and round u and the cotangent once;
for float32 and float64 they are :meth:`.Flow.u`'s expression itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ... import tracing
from ...stencil import D1Q3, D2Q9, D3Q15, D3Q19, D3Q27
from .build import check_launch, compute_dtype, open_library

__all__ = ["velocity", "velocity_plain", "velocity_adjoint_plain", "takes",
           "plan_of", "stencil_name", "load_library", "STENCILS", "STORAGE"]

# the compiled instances of csrc/moments.cu: stencils, and the entry suffix
# of each state dtype with the cells of one 16-byte access
STENCILS = {"d1q3": D1Q3, "d2q9": D2Q9, "d3q15": D3Q15, "d3q19": D3Q19,
            "d3q27": D3Q27}
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_LANES = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}
_NAMES = {}  # e's bytes -> its compiled stencil's name, or None


def stencil_name(e) -> str:
    """The compiled stencil whose velocities equal ``e``, or None."""
    e = np.asarray(e)
    key = (e.shape, e.tobytes())
    if key not in _NAMES:
        _NAMES[key] = next((name for name, s in STENCILS.items()
                            if np.array_equal(s.e, e)), None)
    return _NAMES[key]


def takes(f: torch.Tensor, e):
    """The name of the compiled stencil K5 runs on the state ``f`` of a
    stencil with velocities ``e``, or None where K5 does not take it: it
    takes a contiguous CUDA tensor of shape ``[q, *grid]`` in float32,
    bfloat16 or float16, of a compiled stencil. Hand the name to
    :func:`velocity`, which then checks nothing again."""
    if not (f.is_cuda and f.dtype in STORAGE and f.is_contiguous()):
        return None
    name = stencil_name(e)
    if name is None:
        return None
    q, d = STENCILS[name].e.shape
    return name if f.dim() == d + 1 and f.shape[0] == q else None


def _name_of(f: torch.Tensor, e) -> str:
    """:func:`takes`'s name, raising ValueError where K5 does not take
    the CUDA state ``f``."""
    name = takes(f, e)
    if name is None:
        raise ValueError(f"the velocity kernel takes contiguous states in "
                         f"float32, bfloat16 or float16 of a stencil of "
                         f"{sorted(STENCILS)}, got a {f.dtype} state of "
                         f"shape {tuple(f.shape)} (contiguous: "
                         f"{f.is_contiguous()}) for velocities of shape "
                         f"{np.shape(e)}")
    return name


# ----------------------------------------------------------------------
# the plain PyTorch versions
# ----------------------------------------------------------------------
def velocity_plain(f: torch.Tensor, e) -> tuple:
    """``(u, rho)`` of the state ``f``: rho ``[1, *grid]`` in the compute
    dtype, u ``[d, *grid]`` rounded once to ``f``'s dtype."""
    c = compute_dtype(f.dtype)
    fc = f.to(c)
    rho = torch.sum(fc, dim=0, keepdim=True)
    et = torch.as_tensor(np.asarray(e), dtype=c, device=f.device)
    u = torch.tensordot(et.T, fc, dims=1) / rho
    return u.to(f.dtype), rho


def velocity_adjoint_plain(g: torch.Tensor, u: torch.Tensor,
                           rho: torch.Tensor, e) -> torch.Tensor:
    """The cotangent of the state, ``(e_q . g - u . g) / rho``, from the
    cotangent ``g`` of u and the forward's ``u`` and ``rho``, in rho's
    dtype, rounded once to u's."""
    c = rho.dtype
    et = torch.as_tensor(np.asarray(e), dtype=c, device=g.device)
    gc = g.to(c)
    ug = torch.sum(u.to(c) * gc, dim=0, keepdim=True)
    return ((torch.tensordot(et, gc, dims=1) - ug) / rho).to(u.dtype)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------
@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/moments.cu``, with ``argtypes``
    set on every entry."""
    lib = open_library("moments")
    pointer = ctypes.c_void_p
    tail = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, pointer]
    for name in STENCILS:
        for suffix in STORAGE.values():
            fn = getattr(lib, f"lt_velocity_{name}_{suffix}")
            fn.argtypes = [pointer] * 3 + tail
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lt_velocity_adjoint_{name}_{suffix}")
            fn.argtypes = [pointer] * 4 + tail
            fn.restype = ctypes.c_int
    return lib


class _Plan(NamedTuple):
    """What every launch on one (stencil, grid, dtype) needs: the library,
    both entries, the cells, whether a 16-byte access divides them, the
    shapes of the state, u and rho, the counter keys and the entries'
    names."""
    lib: ctypes.CDLL
    forward: object
    adjoint: object
    cells: int
    lanes: bool
    f_shape: tuple
    u_shape: tuple
    rho_shape: tuple
    forward_key: str
    adjoint_key: str
    what: str


@functools.lru_cache(maxsize=256)
def _plan(name: str, shape: tuple, dtype: torch.dtype) -> _Plan:
    """The plan of the stencil ``name`` on a state of ``shape`` and
    ``dtype``; raises ValueError when the shape does not fit the stencil.
    Cached: a launch plans once per grid."""
    q, d = STENCILS[name].e.shape
    if len(shape) != d + 1 or shape[0] != q:
        raise ValueError(f"a state of shape {shape} does not fit the "
                         f"{name.upper()} stencil")
    lib = load_library()
    suffix = STORAGE[dtype]
    cells = int(np.prod(shape[1:], dtype=np.int64))
    return _Plan(lib, getattr(lib, f"lt_velocity_{name}_{suffix}"),
                 getattr(lib, f"lt_velocity_adjoint_{name}_{suffix}"),
                 cells, cells % _LANES[dtype] == 0, shape, (d, *shape[1:]),
                 (1, *shape[1:]),
                 tracing.launch_key("K5", "", "u", suffix),
                 tracing.launch_key("K5", "adjoint_", "u", suffix),
                 f"{name}_{suffix}")


def _aligned(*tensors) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def plan_of(f: torch.Tensor, name: str) -> _Plan:
    """The cached plan of K5 on the state ``f`` of the stencil ``name``
    (:func:`takes`'s)."""
    return _plan(name, tuple(f.shape), f.dtype)


def _launch(f: torch.Tensor, plan: _Plan, keep_rho: bool) -> tuple:
    """One K5 launch on the CUDA state ``f`` of ``plan``: ``(u, rho)``,
    rho (float32) None unless ``keep_rho``."""
    device = f.device
    u = torch.empty(plan.u_shape, dtype=f.dtype, device=device)
    rho = (torch.empty(plan.rho_shape, dtype=torch.float32, device=device)
           if keep_rho else None)
    rc = plan.forward(f.data_ptr(), u.data_ptr(),
                      None if rho is None else rho.data_ptr(), plan.cells,
                      int(plan.lanes and _aligned(f, u)), device.index,
                      torch.cuda.current_stream(device).cuda_stream)
    check_launch(plan.lib, rc, f"velocity ({plan.what})")
    tracing.count(plan.forward_key)
    return u, rho


def _launch_adjoint(g: torch.Tensor, u: torch.Tensor, rho: torch.Tensor,
                    plan: _Plan) -> torch.Tensor:
    """One K5 adjoint launch of the forward's ``plan``: the cotangent of
    the state, freshly allocated."""
    g = g.to(u.dtype).contiguous()
    device = u.device
    out = torch.empty(plan.f_shape, dtype=u.dtype, device=device)
    rc = plan.adjoint(g.data_ptr(), u.data_ptr(), rho.data_ptr(),
                      out.data_ptr(), plan.cells,
                      int(plan.lanes and _aligned(g, u, rho, out)),
                      device.index,
                      torch.cuda.current_stream(device).cuda_stream)
    check_launch(plan.lib, rc, f"velocity adjoint ({plan.what})")
    tracing.count(plan.adjoint_key)
    return out


class _Velocity(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, e, name):
        if f.is_cuda:
            ctx.plan = plan_of(f, name or _name_of(f, e))
            u, rho = _launch(f, ctx.plan, keep_rho=True)
        else:
            ctx.e = e
            u, rho = velocity_plain(f, e)
        ctx.save_for_backward(u, rho)
        return u

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u, rho = ctx.saved_tensors
        if u.is_cuda:
            return _launch_adjoint(g, u, rho, ctx.plan), None, None
        return velocity_adjoint_plain(g, u, rho, ctx.e), None, None


def velocity(f: torch.Tensor, e, name: str = None) -> torch.Tensor:
    """u = j / rho of the state ``f`` ``[q, *grid]`` for the velocities
    ``e``, ``[d, *grid]`` in ``f``'s dtype: one K5 launch on a CUDA state,
    the plain version on a CPU state. ``name`` is :func:`takes`'s for
    ``f``; without it a CUDA state is checked here, and one K5 does not
    take raises ValueError. Differentiable: when ``f`` needs a gradient
    the Function saves u and rho and its backward is the adjoint;
    otherwise nothing is saved and rho is not written."""
    if torch.is_grad_enabled() and f.requires_grad:
        return _Velocity.apply(f, e, name)
    if f.is_cuda:
        return _launch(f, plan_of(f, name or _name_of(f, e)),
                       keep_rho=False)[0]
    return velocity_plain(f, e)[0]
