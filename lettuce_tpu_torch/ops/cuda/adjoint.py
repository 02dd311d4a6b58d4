"""Adjoint of the fused BGK collide-and-stream step: the hand-written CUDA
kernels and their plain PyTorch version.

The kernels (``lettuce_tpu_torch/csrc/adjoint.cu``) replace
``lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel`` for the
``("bgk", tau_inv)`` spec with the emitted-u residual, in float32 and
float64, for D2Q9, D3Q15, D3Q19 and D3Q27: the periodic instances, and the
masked instances that route the cotangent through the boundary codes and
the no-streaming mask of the forward's masked kernel. Given the cotangent
``g`` of a step's output and the pre-collision velocity ``u`` that the
step's forward emitted (:func:`.stream_collide.stream_collide` with
``u_out``), it returns the cotangent of the step's input, the exact
vector-Jacobian product::

    h_q(x) = g_q(x + e_q)  (periodic), or with frozen populations
    h_q(x) = (nsm_q(x + e_q) ? 0 : g_q(x + e_q)) + (nsm_q(x) ? g_q(x) : 0),
    t = tau_inv h,
    S0 = sum_q w_q t_q,  S1_a = sum_q w_q e_qa t_q,
    S2_ab = sum_q w_q e_qa e_qb t_q,
    A = S0 (1 - u.u / (2 cs^2)) + u.S1 / cs^2 + u.S2.u / (2 cs^4),
    B_a = (S1_a - u_a S0 + (S2 u)_a / cs^2) / cs^2,
    ct_q = h_q - t_q + (A - u.B) + e_q.B      on collide cells,
    ct_q = h_opp(q)                           on bounce-back cells,
    ct_q = 0                                  on equilibrium cells,
    ct_q = h_q                                on identity cells.

It is bound by device memory: D3Q19 in float32 reads 19 + 3 fields and
writes 19, 164 B per lattice update (plus the 1-byte code when masked).

:func:`stream_collide_adjoint` runs the plain version only for a CPU
tensor. For a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import (DTYPES, KERNEL_STENCIL_NAMES, check_launch, check_out,
                    kernel_stencil_name, launch_dims, open_library)
from .stream_collide import checked_table

__all__ = ["stream_collide_adjoint", "stream_collide_adjoint_plain",
           "load_library"]


# ----------------------------------------------------------------------
# the plain PyTorch version
# ----------------------------------------------------------------------
def _pull(g: torch.Tensor, e: np.ndarray, nsm) -> torch.Tensor:
    """h_q(x): the cotangent pulled along -e, re-routed at the
    populations ``nsm`` froze."""
    dims = tuple(range(e.shape[1]))
    h = []
    for q in range(e.shape[0]):
        shift = tuple(-int(s) for s in e[q])
        hq = torch.roll(g[q], shift, dims=dims)
        if nsm is not None:
            frozen_dst = torch.roll(nsm[q], shift, dims=dims)
            hq = (torch.where(frozen_dst, torch.zeros_like(hq), hq)
                  + torch.where(nsm[q], g[q], torch.zeros_like(hq)))
        h.append(hq)
    return torch.stack(h)


def check_bgk(collision_spec) -> None:
    """Raise NotImplementedError unless ``collision_spec`` is None or the
    BGK spec: the adjoint here is BGK's, and must never stand in for
    another collision's."""
    if collision_spec is not None and collision_spec[0] != "bgk":
        raise NotImplementedError(
            f"no adjoint kernel for the {collision_spec[0]!r} collision yet "
            f"(K3b/K3d)")


def stream_collide_adjoint_plain(g: torch.Tensor, u: torch.Tensor,
                                 e: np.ndarray, w: np.ndarray,
                                 opposite: np.ndarray, cs: float,
                                 tau_inv: float, ncm: torch.Tensor = None,
                                 nsm: torch.Tensor = None, table=None,
                                 feq_field: torch.Tensor = None,
                                 collision_spec=None) -> torch.Tensor:
    """The closed-form VJP of one BGK collide-and-stream step in plain
    PyTorch (``collision_spec`` None or BGK; any other raises): the
    cotangent pulled by ``torch.roll`` along -e (re-routed
    where ``nsm`` froze populations), then the transposed collision
    Jacobian from the weighted moments of t and the pre-collision velocity
    ``u`` (the formulas of the module docstring), and the boundary codes
    of ``table`` where ``ncm`` holds them. ``feq_field`` is unused (an
    equilibrium replacement is constant in f); it is taken so that one
    parameter set serves the forward and the adjoint."""
    check_bgk(collision_spec)
    e = np.asarray(e)
    et = torch.as_tensor(e, dtype=g.dtype, device=g.device)
    wt = torch.as_tensor(np.asarray(w), dtype=g.dtype, device=g.device)
    h = _pull(g, e, nsm)
    t = tau_inv * h
    inv_cs2 = 1.0 / (cs * cs)
    we = (wt[:, None] * et).T                               # [d, q]
    s0 = torch.tensordot(wt, t, dims=1)                     # [...]
    s1 = torch.tensordot(we, t, dims=1)                     # [d, ...]
    s2 = torch.tensordot(we[:, None, :] * et.T[None, :, :], t,
                         dims=1)                            # [d, d, ...]
    su = torch.einsum("ab...,b...->a...", s2, u)            # (S2 u)_a
    u2 = torch.sum(u * u, dim=0)
    a_term = (s0 * (1 - 0.5 * inv_cs2 * u2)
              + inv_cs2 * torch.sum(u * s1, dim=0)
              + 0.5 * inv_cs2 * inv_cs2 * torch.sum(u * su, dim=0))
    b = inv_cs2 * (s1 - u * s0 + inv_cs2 * su)              # [d, ...]
    a_prime = a_term - torch.sum(u * b, dim=0)
    ct = h - t + a_prime + torch.tensordot(et, b, dims=1)
    if ncm is None:
        return ct
    # identity off code 0, as the forward (codes outside the table too)
    ct = torch.where(ncm == 0, ct, h)
    for code, (kind, _) in enumerate(table):
        if kind == "bounce_back":
            repl = h[torch.as_tensor(np.asarray(opposite), device=g.device)]
        elif kind in ("equilibrium_pu", "equilibrium_pu_field"):
            repl = torch.zeros_like(h)  # constant in f
        else:  # collide (code 0) or identity
            continue
        ct = torch.where(ncm == code, repl, ct)
    return ct


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the adjoint library, with ``argtypes``
    set on every entry."""
    lib = open_library("adjoint")
    pointer = ctypes.c_void_p
    for name in KERNEL_STENCIL_NAMES:
        for suffix, scalar in DTYPES.values():
            tail = ([ctypes.c_int64] * 3
                    + [scalar, ctypes.c_double, ctypes.c_int, pointer])
            fn = getattr(lib, f"lt_stream_collide_adjoint_{name}_{suffix}")
            fn.argtypes = [pointer] * 3 + tail
            fn.restype = ctypes.c_int
            # masks: ncm, nsm, host kinds
            fn = getattr(lib, f"lt_stream_collide_adjoint_masked_{name}_"
                              f"{suffix}")
            fn.argtypes = [pointer] * 3 + [pointer] * 3 + tail
            fn.restype = ctypes.c_int
    return lib


def stream_collide_adjoint(g: torch.Tensor, u: torch.Tensor, e: np.ndarray,
                           w: np.ndarray, opposite: np.ndarray, cs: float,
                           tau_inv: float, ncm: torch.Tensor = None,
                           nsm: torch.Tensor = None, table=None,
                           feq_field: torch.Tensor = None,
                           out: torch.Tensor = None,
                           collision_spec=None) -> torch.Tensor:
    """The cotangent of one step's input from the cotangent ``g``
    (``[q, *grid]``) of its output and its pre-collision velocity ``u``
    (``[d, *grid]``). With ``ncm`` and ``table`` (and ``nsm``) the masked
    kernel routes it as the forward's masked kernel ran; ``feq_field`` is
    checked as the forward checks it, and never read.

    On a CPU tensor this is :func:`stream_collide_adjoint_plain`; on a
    CUDA tensor it launches a kernel (allocating ``out`` when none is
    given) or raises. ``out`` must not be ``g``: the kernel pulls from
    neighbours. ``collision_spec`` is None or BGK: no other collision has
    an adjoint kernel yet, and one raises NotImplementedError.
    """
    check_bgk(collision_spec)
    masks = dict(ncm=ncm, nsm=nsm, table=table, feq_field=feq_field)
    if g.device.type == "cpu":
        result = stream_collide_adjoint_plain(g, u, e, w, opposite, cs,
                                              tau_inv, **masks)
        return result if out is None else out.copy_(result)
    if g.device.type != "cuda":
        raise ValueError(f"stream_collide_adjoint runs on cpu or cuda "
                         f"tensors, got {g.device}")
    name = kernel_stencil_name(e, w, opposite)
    n0, n1, n2 = launch_dims(g, e)
    d = np.asarray(e).shape[1]
    if (u.device != g.device or u.dtype != g.dtype
            or tuple(u.shape) != (d, *g.shape[1:]) or not u.is_contiguous()):
        raise ValueError(f"u must be a contiguous tensor of shape "
                         f"{(d, *g.shape[1:])} on g's device in g's dtype")
    out = check_out(out, g, g.shape, "out", g, u)
    pointers = [g.data_ptr(), u.data_ptr(), out.data_ptr()]
    masked = ncm is not None
    if masked:
        # alive until the call returns; the field is checked, never read
        table = checked_table(g, ncm, nsm, table, feq_field)
        pointers += [ncm.data_ptr(),
                     None if nsm is None else nsm.data_ptr(),
                     table.kinds.ctypes.data]

    lib = load_library()
    variant = "masked_" if masked else ""
    launch = getattr(lib, f"lt_stream_collide_adjoint_{variant}{name}_"
                          f"{DTYPES[g.dtype][0]}")
    rc = launch(*pointers, n0, n1, n2, float(tau_inv), float(cs),
                g.device.index,
                torch.cuda.current_stream(g.device).cuda_stream)
    check_launch(lib, rc, f"stream_collide_adjoint ({variant}{name})")
    if masked:
        stream_collide_adjoint.masked_launches += 1
    else:
        stream_collide_adjoint.launches += 1
    return out


stream_collide_adjoint.launches = 0         # periodic launches
stream_collide_adjoint.masked_launches = 0  # masked launches
