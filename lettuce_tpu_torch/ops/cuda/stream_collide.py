"""Fused BGK collide-and-stream step: the hand-written CUDA kernels, their
plain PyTorch version, and the simulation gate that selects them.

The kernels (``lettuce_tpu_torch/csrc/stream_collide.cu``) replace
``lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel`` with
the BGK fragment and one step per launch, in float32 and float64, for
D2Q9, D3Q15, D3Q19 and D3Q27:

* the periodic instances (no masks);
* the masked instances, the kernel's mask pipeline: per cell the uint8
  ``no_collision_mask`` code selects a kind from a per-code boundary table
  (:data:`KINDS`: collide, bounce back, a constant equilibrium, a per-node
  equilibrium field, or identity for the outlets the window replay
  rewrites), and the bool ``no_streaming_mask`` freezes populations at
  their destination.

They are bound by device memory: D3Q19 in float32 moves 19*4 bytes in and
19*4 bytes out per cell, 152 B per lattice update; the masked instances
add the 1-byte code (73 B per D2Q9 float32 update without a no-streaming
mask). The emit-u instances also write the pre-collision velocity, the
residual of the adjoint kernel (:mod:`.adjoint`).

The sources are built and loaded by :mod:`.build`. :func:`stream_collide`
runs the plain version only for a CPU tensor. For a CUDA tensor it
launches a kernel or raises; a CUDA state that requires grad goes through
:func:`.fused_step.fused_step`, the autograd route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..boundary import (HYBRID_OUTLET_TYPES, BounceBackBoundary,
                        EquilibriumBoundaryPU, combined_equilibrium_field)
from ..collision import BGKCollision, bgk_relax
from ..equilibrium import QuadraticEquilibrium, quadratic_feq
from ..streaming import stream
from .build import (DTYPES, KERNEL_STENCIL_NAMES, KERNEL_STENCILS,
                    check_launch, check_out, kernel_stencil_name,
                    launch_dims, open_library)
from .hybrid_outlets import outlet_window

__all__ = ["stream_collide", "stream_collide_plain", "load_library",
           "gate_fused_params", "kernel_refusals", "check_masks",
           "checked_table", "table_arrays", "PackedTable",
           "kernel_stencil_name", "KERNEL_STENCILS", "KINDS", "MAX_CODES"]

# boundary kinds of the per-code table, in the order of csrc/stencils.cuh's
# Kind enum
KINDS = ("collide", "bounce_back", "equilibrium_pu", "equilibrium_pu_field",
         "identity")
MAX_CODES = 8   # mask codes 0..7: code 0 collides, up to 7 boundaries
MAX_Q = 27      # the table's values per code


# ----------------------------------------------------------------------
# the plain PyTorch version
# ----------------------------------------------------------------------
def _replace_boundaries(f: torch.Tensor, fpost: torch.Tensor, opposite,
                        ncm: torch.Tensor, table, feq_field):
    """``fpost`` where ``ncm`` is 0, and elsewhere the boundary code's
    replacement from ``table``: bounce back ``f[opposite]``, a constant
    equilibrium, the per-node ``feq_field``, or identity ``f``
    (pre-collision), which is also what a code outside the table gets."""
    fpost = torch.where(ncm == 0, fpost, f)
    for code, (kind, values) in enumerate(table):
        if kind == "bounce_back":
            repl = f[torch.as_tensor(np.asarray(opposite), device=f.device)]
        elif kind == "equilibrium_pu":
            repl = torch.as_tensor(values, dtype=f.dtype, device=f.device)
            repl = repl.reshape((-1,) + (1,) * (f.dim() - 1))
        elif kind == "equilibrium_pu_field":
            repl = feq_field
        else:  # collide (code 0, done above) or identity
            continue
        fpost = torch.where(ncm == code, repl, fpost)
    return fpost


def stream_collide_plain(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                         opposite: np.ndarray, cs: float, tau_inv: float,
                         ncm: torch.Tensor = None, nsm: torch.Tensor = None,
                         table=None, feq_field: torch.Tensor = None,
                         emit_u: bool = False):
    """One BGK collide-and-stream step in plain PyTorch: the quadratic
    equilibrium, BGK relaxation, the boundary codes of ``table`` where
    ``ncm`` holds them (:func:`_replace_boundaries`), then a per-q
    ``torch.roll`` with the populations of ``nsm`` frozen. With ``emit_u``
    it returns ``(out, u)``, u = j / rho the pre-collision velocity
    ``[d, *grid]``."""
    et = torch.as_tensor(np.asarray(e), dtype=f.dtype, device=f.device)
    wt = torch.as_tensor(np.asarray(w), dtype=f.dtype, device=f.device)
    rho = torch.sum(f, dim=0, keepdim=True)
    u = torch.tensordot(et.T, f, dims=1) / rho
    feq = quadratic_feq(et, wt, cs, rho, u)
    fpost = bgk_relax(f, feq, tau_inv)
    if ncm is not None:
        fpost = _replace_boundaries(f, fpost, opposite, ncm, table,
                                    feq_field)
    out = stream(fpost, e, nsm)
    return (out, u) if emit_u else out


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ``argtypes``
    set on every entry."""
    lib = open_library("stream_collide")
    pointer = ctypes.c_void_p
    for name in KERNEL_STENCIL_NAMES:
        for suffix, scalar in DTYPES.values():
            grid = [ctypes.c_int64] * 3
            tail = [scalar, ctypes.c_double, ctypes.c_int, pointer]
            # masks: ncm, nsm, feq field, host kinds, host values
            masks = [pointer] * 5
            for variant, n_tensors in (("", 2), ("emit_u_", 3)):
                fn = getattr(lib, f"lt_stream_collide_{variant}{name}_"
                                  f"{suffix}")
                fn.argtypes = [pointer] * n_tensors + grid + tail
                fn.restype = ctypes.c_int
                fn = getattr(lib, f"lt_stream_collide_masked_{variant}"
                                  f"{name}_{suffix}")
                fn.argtypes = [pointer] * n_tensors + masks + grid + tail
                fn.restype = ctypes.c_int
    return lib


def table_arrays(table) -> tuple:
    """The per-code table as the host arrays the C entries copy into the
    kernel parameter: int32 kinds ``[MAX_CODES]`` (unused codes identity)
    and float64 values ``[MAX_CODES, MAX_Q]``."""
    kinds = np.full(MAX_CODES, KINDS.index("identity"), dtype=np.int32)
    values = np.zeros((MAX_CODES, MAX_Q), dtype=np.float64)
    for code, (kind, vals) in enumerate(table):
        kinds[code] = KINDS.index(kind)
        if vals is not None:
            values[code, :len(vals)] = vals
    return kinds, values


class PackedTable(tuple):
    """A per-code table that :func:`check_masks` passed, with its
    :func:`table_arrays` packed once. ``checked`` is what it was checked
    with: the state's shape, dtype and device, and the ``ncm``, ``nsm``
    and ``feq_field`` tensors themselves. It iterates as the table."""

    def __new__(cls, table, checked):
        self = super().__new__(cls, table)
        self.kinds, self.values = table_arrays(table)
        self.checked = checked
        return self


def checked_table(f: torch.Tensor, ncm, nsm, table,
                  feq_field) -> PackedTable:
    """``table`` checked against the masks for a state like ``f`` and
    packed. A table packed with these very masks for such a state (the
    gate's) is returned as it is, so a launch only forwards pointers."""
    if isinstance(table, PackedTable):
        shape, dtype, device, *masks = table.checked
        if (shape == f.shape and dtype == f.dtype and device == f.device
                and all(a is b for a, b in zip(masks,
                                               (ncm, nsm, feq_field)))):
            return table
    check_masks(f, ncm, nsm, table, feq_field)
    return PackedTable(table, (f.shape, f.dtype, f.device, ncm, nsm,
                               feq_field))


def check_masks(f: torch.Tensor, ncm, nsm, table, feq_field) -> None:
    """Raise on masks, a table or a field the masked kernels do not
    take. ``f`` is the ``[q, *grid]`` tensor the kernel steps."""
    if (ncm.dtype != torch.uint8 or tuple(ncm.shape) != tuple(f.shape[1:])
            or ncm.device != f.device or not ncm.is_contiguous()):
        raise ValueError(f"ncm must be a contiguous uint8 tensor of shape "
                         f"{tuple(f.shape[1:])} on {f.device}")
    if nsm is not None and (
            nsm.dtype != torch.bool or tuple(nsm.shape) != tuple(f.shape)
            or nsm.device != f.device or not nsm.is_contiguous()):
        raise ValueError(f"nsm must be a contiguous bool tensor of shape "
                         f"{tuple(f.shape)} on {f.device}")
    if not 0 < len(table) <= MAX_CODES or table[0][0] != "collide":
        raise ValueError(f"the table needs code 0 'collide' and at most "
                         f"{MAX_CODES} codes")
    if any(kind not in KINDS for kind, _ in table):
        raise ValueError(f"table kinds must be among {KINDS}")
    if any(kind == "equilibrium_pu_field" for kind, _ in table):
        if (feq_field is None or feq_field.dtype != f.dtype
                or tuple(feq_field.shape) != tuple(f.shape)
                or feq_field.device != f.device
                or not feq_field.is_contiguous()):
            raise ValueError(f"an equilibrium_pu_field code needs a "
                             f"contiguous feq_field like f "
                             f"{tuple(f.shape)}, {f.dtype}")


def stream_collide(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                   opposite: np.ndarray, cs: float, tau_inv: float,
                   ncm: torch.Tensor = None, nsm: torch.Tensor = None,
                   table=None, feq_field: torch.Tensor = None,
                   out: torch.Tensor = None, u_out: torch.Tensor = None):
    """One fused BGK collide-and-stream step ``f -> out``.

    ``f`` is ``[q, X, Y]`` or ``[q, X, Y, Z]``. On a CPU tensor this is
    :func:`stream_collide_plain`; on a CUDA tensor it launches a kernel
    (allocating ``out`` when none is given) or raises. ``out`` must not be
    ``f``: the kernel pushes to neighbours. With ``ncm`` (the uint8 code
    per cell) and its ``table`` the masked kernel runs, with the optional
    ``nsm`` and ``feq_field``. With ``u_out`` (``[d, *grid]``) the emit-u
    kernel also writes the pre-collision velocity there, and the call
    returns ``(out, u_out)``.

    A CUDA state that requires grad, with grad mode on, goes through
    :func:`.fused_step.fused_step` (fresh output, adjoint kernel backward);
    ``out`` and ``u_out`` cannot be given then.
    """
    emit_u = u_out is not None
    masks = dict(ncm=ncm, nsm=nsm, table=table, feq_field=feq_field)
    if f.device.type == "cpu":
        result = stream_collide_plain(f, e, w, opposite, cs, tau_inv,
                                      emit_u=emit_u, **masks)
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
                          tau_inv=tau_inv, **masks)
    name = kernel_stencil_name(e, w, opposite)
    n0, n1, n2 = launch_dims(f, e)
    out = check_out(out, f, f.shape, "out", f)
    pointers = [f.data_ptr(), out.data_ptr()]
    if emit_u:
        d = np.asarray(e).shape[1]
        u_out = check_out(u_out, f, (d, *f.shape[1:]), "u_out", f, out)
        pointers.append(u_out.data_ptr())
    masked = ncm is not None
    if masked:
        # alive until the call returns
        table = checked_table(f, ncm, nsm, table, feq_field)
        pointers += [ncm.data_ptr(),
                     None if nsm is None else nsm.data_ptr(),
                     None if feq_field is None else feq_field.data_ptr(),
                     table.kinds.ctypes.data, table.values.ctypes.data]

    lib = load_library()
    variant = ("masked_" if masked else "") + ("emit_u_" if emit_u else "")
    launch = getattr(lib, f"lt_stream_collide_{variant}{name}_"
                          f"{DTYPES[f.dtype][0]}")
    rc = launch(*pointers, n0, n1, n2, float(tau_inv), float(cs),
                f.device.index,
                torch.cuda.current_stream(f.device).cuda_stream)
    check_launch(lib, rc, f"stream_collide ({variant or 'periodic_'}"
                          f"{name})")
    counter = f"{variant}launches"
    setattr(stream_collide, counter, getattr(stream_collide, counter) + 1)
    return (out, u_out) if emit_u else out


stream_collide.launches = 0                # periodic primal launches
stream_collide.emit_u_launches = 0         # periodic emit-u launches
stream_collide.masked_launches = 0         # masked primal launches
stream_collide.masked_emit_u_launches = 0  # masked emit-u launches


# ----------------------------------------------------------------------
# the simulation gate
# ----------------------------------------------------------------------
def kernel_refusals(simulation: "Simulation") -> list:
    """Why a Simulation cannot run on the kernels, one reason per
    component (an empty list when it can). The capability probe prints
    these and :func:`gate_fused_params` raises on them, so the two always
    agree. Host-side checks only: nothing is built or launched."""
    flow = simulation.flow
    reasons = []
    if flow.context.dtype not in DTYPES:
        reasons.append(f"the CUDA kernel has no {flow.context.dtype} "
                       f"instance (compiled for "
                       f"{', '.join(map(str, DTYPES))})")
    if not isinstance(flow.stencil, KERNEL_STENCILS):
        reasons.append(f"stencil '{type(flow.stencil).__name__}' has no "
                       f"CUDA kernel instance (compiled for "
                       f"{', '.join(s.__name__ for s in KERNEL_STENCILS)})")
    equilibrium = flow.equilibrium
    if not (equilibrium.native_available()
            and isinstance(equilibrium, QuadraticEquilibrium)):
        reasons.append(f"equilibrium '{type(equilibrium).__name__}' does "
                       f"not support the CUDA kernel")
    collision = simulation.collision
    if not (collision.native_available()
            and isinstance(collision, BGKCollision)):
        reasons.append(f"collision '{type(collision).__name__}' does not "
                       f"support the CUDA kernel")
    boundaries = simulation.boundaries[1:]
    if len(boundaries) >= MAX_CODES:
        reasons.append(f"{len(boundaries)} boundaries: the kernel's table "
                       f"has {MAX_CODES - 1} boundary codes")
    for index, boundary in enumerate(boundaries, start=1):
        name = type(boundary).__name__
        if not boundary.native_available():
            reasons.append(f"boundary '{name}' does not support the CUDA "
                           f"kernel")
        elif type(boundary) in HYBRID_OUTLET_TYPES:
            try:
                outlet_window(simulation.no_collision_mask, index,
                              boundary.face_axis)
            except NotImplementedError as refusal:
                reasons.append(f"outlet '{name}' cannot ride the kernel "
                               f"through the window replay ({refusal})")
        elif not isinstance(boundary, (BounceBackBoundary,
                                       EquilibriumBoundaryPU)):
            reasons.append(f"boundary '{name}' has no kind in the CUDA "
                           f"kernel's table")
    return reasons


def gate_fused_params(simulation: "Simulation") -> tuple:
    """Static kernel parameters for a Simulation, and its hybrid outlets.

    Returns ``(params, hybrid)``. ``params`` are the keyword arguments of
    :func:`stream_collide`, :func:`.adjoint.stream_collide_adjoint` and
    :func:`.fused_step.fused_step`: the stencil tables, ``cs`` and
    ``tau_inv``, and with boundaries the masks (``ncm``, ``nsm``, None
    when no population is frozen), the per-code ``table`` (a
    :class:`PackedTable`, checked and packed here once) and the combined
    per-node ``feq_field`` (or None). ``hybrid`` is a tuple of
    ``(code, outlet)`` for the outlets the kernel leaves frozen (identity)
    and the window replay rewrites. Raises NotImplementedError with
    :func:`kernel_refusals`' reasons when the configuration cannot run on
    the kernels.
    """
    reasons = kernel_refusals(simulation)
    if reasons:
        raise NotImplementedError("; ".join(reasons))
    flow = simulation.flow
    stencil = flow.stencil
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=float(stencil.cs),
                  tau_inv=float(1.0 / simulation.collision.tau))
    ncm = simulation.no_collision_mask
    if ncm is None:
        return params, ()

    feq_field, pernode = combined_equilibrium_field(
        flow, simulation.boundaries, ncm)
    table = [("collide", None)]
    hybrid = []
    for index, boundary in enumerate(simulation.boundaries[1:], start=1):
        if type(boundary) in HYBRID_OUTLET_TYPES:
            table.append(("identity", None))
            hybrid.append((index, boundary))
        elif isinstance(boundary, BounceBackBoundary):
            table.append(("bounce_back", None))
        elif index in pernode:
            table.append(("equilibrium_pu_field", None))
        else:
            rho = flow.units.convert_pressure_pu_to_density_lu(
                boundary.pressure)
            u = flow.units.convert_velocity_to_lu(boundary.velocity)
            feq = flow.equilibrium(flow, rho=rho, u=u)
            table.append(("equilibrium_pu",
                          tuple(float(v) for v in feq.cpu())))
    nsm = simulation.no_streaming_mask
    if not bool(nsm.any()):
        nsm = None
    params.update(ncm=ncm, nsm=nsm, feq_field=feq_field,
                  table=checked_table(flow.f, ncm, nsm, table, feq_field))
    return params, tuple(hybrid)
