"""Fused collide-and-stream step: the hand-written CUDA kernels, their
plain PyTorch version, and the simulation gate that selects them.

The kernels (``lettuce_tpu_torch/csrc/``) replace
``lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel`` with
one step per launch, in float32 and float64, for D2Q9, D3Q15, D3Q19 and
D3Q27. A collision spec, built from the simulation like the TPU gate's,
selects the fragment: ``("bgk", tau_inv)`` runs ``stream_collide.cu``;
``("none",)``, ``("bgk_force", tau_inv, accel, k_ueq, src_pref)``,
``("trt", tau_plus, tau_minus)``, ``("reg", tau)``, ``("smag", tau, C)``,
``("mrt", M, Minv, taus, meq_kind)`` and ``("kbc", tau)`` run the
fragment sources ``collide_*.cu`` (:data:`FRAGMENTS`). Each comes as:

* the periodic instances (no masks);
* the masked instances, the kernel's mask pipeline: per cell the uint8
  ``no_collision_mask`` code selects a kind from a per-code boundary table
  (:data:`KINDS`: collide, bounce back, a constant equilibrium, a per-node
  equilibrium field, or identity for the outlets the window replay
  rewrites), and the bool ``no_streaming_mask`` freezes populations at
  their destination.

BGK is bound by device memory: D3Q19 in float32 moves 19*4 bytes in and
19*4 bytes out per cell, 152 B per lattice update; the masked instances
add the 1-byte code (73 B per D2Q9 float32 update without a no-streaming
mask). The emit-u instances (:data:`EMIT_U_FRAGMENTS`: BGK, TRT,
regularized and the folded MRT) also write the pre-collision velocity, the
residual of their adjoint kernels (:mod:`.adjoint`). :func:`pack_spec`
packs a spec's adjoint once beside it (:class:`PackedSpec`): the
transposed relaxation of the full-mode adjoint kernels, or split mode for
a collision whose Jacobian has no closed-form kernel.

Every forward instance also comes in 16 bits, computing in float32
(``csrc/half_*.cu``): a bfloat16 or float16 state (K1f), and with
``dev_storage`` the bfloat16 deviations g = f - w_q (K1e, every fragment
but the closed-form MRT bases, :data:`DEV_REFUSED`), which halve the
bytes per update. The emit-u instances take a 16-bit state too (K1d at
16 bits, the forward of its gradient) and write u in float32, as
lettuce_tpu's kernel does (:1778-1779); deviations have no gradient and
no emit-u. :func:`encode_deviations` and :func:`decode_deviations`
convert a state to and from deviation storage.

The temporally blocked kernel (K2, ``csrc/multi_*.cu``) runs ``n_sub``
steps of any fragment in one launch, periodic or masked (the boundary
codes and frozen populations on every sub-step), in every storage
(``stream_collide(..., n_sub=n)``): it reads and writes the state once per
launch. Both forms march columns along the grid's slowest moving axis
(:func:`march_plan`, :func:`.build.plan_march`); a masked launch on a 2D
grid runs several small blocks per SM, one row each.
:func:`build_fused_multi_step` builds the blocked step of a Simulation
when a span is asked for (``LETTUCE_NSUB``), with the outlets'
window replay at that span; on a periodic grid its gradient runs the
blocked adjoint (K4, :mod:`.adjoint`).

The sources are built and loaded by :mod:`.build`. :func:`stream_collide`
runs the plain version only for a CPU tensor. For a CUDA tensor it
launches a kernel or raises. A state that requires grad, on either
device, goes through :func:`.fused_step.fused_step`, the autograd route.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ... import tracing
from . import moments
from ..boundary import (HYBRID_OUTLET_TYPES, BounceBackBoundary,
                        EquilibriumBoundaryPU, combined_equilibrium_field)
from ..collision import (BGKCollision, KBCCollision, MRTCollision,
                         NoCollision, RegularizedCollision,
                         SmagorinskyCollision, TRTCollision, bgk_relax,
                         constant_table, kbc_relax, mrt_relax, regularize,
                         smagorinsky_relax, trt_relax)
from ..equilibrium import QuadraticEquilibrium, quadratic_feq
from ..force import Guo, ShanChen, guo_source
from ..streaming import stream
from ...utils.moments import (HERMITE_MULTIINDICES, dellar_meq, hermite_meq,
                             lallemand_meq)
from ..utils_moments_shim import resolve_mrt_spec
from .build import (DTYPES, HALF_DTYPES, KERNEL_STENCIL_NAMES,
                    KERNEL_STENCILS, STORAGE, cells_of, check_launch,
                    check_out, compute_dtype, kernel_stencil_name,
                    launch_dims, march_candidates, march_values,
                    min_blocks_of, moving_axes, open_library, plan_cells,
                    plan_march, ring_keep, storage_suffix, tile_stride)
from .hybrid_outlets import (build_hybrid_fixup, nsm_outside_regions,
                             outlet_window)

__all__ = ["stream_collide", "stream_collide_plain", "collide_plain",
           "prestream_plain", "load_library", "load_fragment_library",
           "load_libraries", "gate_fused_params", "kernel_refusals",
           "collision_spec_of", "fragment_of", "pack_spec", "PackedSpec",
           "adjoint_collision_spec", "check_masks", "check_nsm",
           "checked_table", "table_arrays", "PackedTable",
           "kernel_stencil_name", "KERNEL_STENCILS", "KINDS", "MAX_CODES",
           "FRAGMENTS", "EMIT_U_FRAGMENTS", "HALF_SOURCES", "DEV_REFUSED",
           "encode_deviations", "decode_deviations",
           "load_half_library", "MULTI_SOURCES", "load_multi_library",
           "blocking_refusals", "build_fused_multi_step", "march_plan",
           "march_scratch", "without_nsm", "cell_plan"]

# boundary kinds of the per-code table, in the order of csrc/stencils.cuh's
# Kind enum
KINDS = ("collide", "bounce_back", "equilibrium_pu", "equilibrium_pu_field",
         "identity")
MAX_CODES = 8   # mask codes 0..7: code 0 collides, up to 7 boundaries
MAX_Q = 27      # the table's values per code

_ALL = ("d2q9", "d3q15", "d3q19", "d3q27")
# fragment -> (csrc source, the stencils it is compiled for); the fragment
# of a spec is its kind, or "mrt_<meq_kind>"
FRAGMENTS = {
    "none": ("collide_basic", _ALL),
    "bgk_force": ("collide_basic", _ALL),
    "trt": ("collide_basic", _ALL),
    "reg": ("collide_moments", _ALL),
    "smag": ("collide_moments", _ALL),
    "mrt_from_feq": ("collide_mrt", ("d3q19",)),
    "mrt_lallemand": ("collide_mrt", ("d2q9",)),
    "mrt_dellar": ("collide_mrt", ("d2q9",)),
    "mrt_hermite27": ("collide_mrt", ("d3q27",)),
    "kbc": ("collide_kbc", ("d2q9", "d3q27")),
}
# the fragments with emit-u instances: those whose adjoint kernel reads the
# pre-collision u (lettuce_tpu's build_adjoint_step :770-772)
EMIT_U_FRAGMENTS = ("bgk", "trt", "reg", "mrt_from_feq")
# the 16-bit instances of each source: csrc/half_<name>.cu
HALF_SOURCES = {"stream_collide": "half_stream_collide",
                "collide_basic": "half_basic",
                "collide_moments": "half_moments",
                "collide_mrt": "half_mrt", "collide_kbc": "half_kbc"}
# the blocked instances (K2) of each source, every storage: csrc/multi_*.cu
MULTI_SOURCES = {"stream_collide": "multi_stream_collide",
                 "collide_basic": "multi_basic",
                 "collide_moments": "multi_moments",
                 "collide_mrt": "multi_mrt", "collide_kbc": "multi_kbc"}
# the fragments deviation storage refuses: closed-form equilibrium moments
# are not shift-invariant in f (lettuce_tpu's build_fused_step :1998-2004)
DEV_REFUSED = ("mrt_lallemand", "mrt_dellar", "mrt_hermite27")
# the parity of each moment under e -> -e that the MRT fragment's closed
# forms assume (csrc/collide_mrt.cu, moment_parity)
MRT_PARITY = {
    "lallemand": (1, -1, -1, 1, 1, 1, -1, -1, 1),
    "dellar": (1, -1, -1, 1, 1, 1, 1, -1, -1),
    "hermite27": tuple(1 - 2 * (sum(idx) % 2)
                       for idx in HERMITE_MULTIINDICES),
}


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


def _velocity(f: torch.Tensor, et: torch.Tensor, rho: torch.Tensor,
              e: np.ndarray) -> torch.Tensor:
    """u = j / rho of ``f``: through K5 where :meth:`.Flow.u` takes it
    (:func:`.moments.takes`), as the torch step's collisions compute it,
    so that split mode's VJP (:func:`.adjoint.prestream_vjp`) linearises
    at the torch step's own u; elsewhere the expression."""
    name = moments.takes(f, e)
    if name is not None:
        return moments.velocity(f, e, name)
    return torch.tensordot(et.T, f, dims=1) / rho


def collide_plain(f: torch.Tensor, spec, e: np.ndarray, w: np.ndarray,
                  opposite: np.ndarray, cs: float) -> torch.Tensor:
    """The post-collision state of the collision ``spec`` in plain torch:
    per fragment, the formula of lettuce_tpu's jnp operator on the
    quadratic equilibrium of ``f``, its u computed as :meth:`.Flow.u`
    computes it (:func:`_velocity`)."""
    kind = spec[0]
    if kind == "none":
        return f
    et = constant_table(e, f.dtype, f.device)
    wt = constant_table(w, f.dtype, f.device)
    rho = torch.sum(f, dim=0, keepdim=True)
    u = _velocity(f, et, rho, e)
    if kind == "bgk_force":
        _, tau_inv, accel, k_ueq, src_pref = spec
        a = torch.as_tensor(accel, dtype=f.dtype, device=f.device)
        u = u + k_ueq * a.reshape((-1,) + (1,) * (f.dim() - 1)) / rho
        out = bgk_relax(f, quadratic_feq(et, wt, cs, rho, u), tau_inv)
        if src_pref is not None:
            out = out + guo_source(et, wt, cs, u, a, src_pref)
        return out
    if kind == "mrt":
        _, M, Minv, taus, meq_kind = spec
        M = torch.as_tensor(M, dtype=f.dtype, device=f.device)
        Minv = torch.as_tensor(Minv, dtype=f.dtype, device=f.device)
        m = torch.tensordot(M, f, dims=1)
        if meq_kind == "from_feq":
            # the exact image of feq, through f-space
            f_rt = torch.tensordot(Minv, m, dims=1)
            rho_rt = torch.sum(f_rt, dim=0, keepdim=True)
            u_rt = _velocity(f_rt, et, rho_rt, e)
            meq = torch.tensordot(M, quadratic_feq(et, wt, cs, rho_rt, u_rt),
                                  dims=1)
        else:
            meq = {"lallemand": lallemand_meq, "dellar": dellar_meq,
                   "hermite27": hermite_meq}[meq_kind](m)
        m = mrt_relax(m, meq, torch.as_tensor(taus, dtype=f.dtype))
        return torch.tensordot(Minv, m, dims=1)
    feq = quadratic_feq(et, wt, cs, rho, u)
    if kind == "bgk":
        return bgk_relax(f, feq, spec[1])
    if kind == "trt":
        return trt_relax(f, feq, opposite, spec[1], spec[2])
    if kind == "reg":
        return regularize(f, feq, et, wt, cs, spec[1])
    if kind == "smag":
        return smagorinsky_relax(f, feq, rho, et, cs, spec[1], spec[2])
    if kind == "kbc":
        return kbc_relax(f, feq, e, spec[1])
    raise ValueError(f"unknown collision spec {kind!r}")


def _weights(w, dtype: torch.dtype, device, ndim: int) -> torch.Tensor:
    """The stencil weights as a ``[q, 1, ...]`` tensor broadcasting over a
    state of ``ndim`` axes."""
    return torch.as_tensor(np.asarray(w), dtype=dtype, device=device
                           ).reshape((-1,) + (1,) * (ndim - 1))


def encode_deviations(f: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """Deviation storage of the state ``f``: g = f - w_q, computed in
    float32 (float64 for a float64 ``f``) and rounded to bfloat16 (to
    nearest even), as lettuce_tpu's ``Simulation._select_steps`` encodes."""
    wide = torch.promote_types(torch.float32, f.dtype)
    return (f.to(wide) - _weights(w, wide, f.device, f.dim())
            ).to(torch.bfloat16)


def decode_deviations(g: torch.Tensor, w: np.ndarray,
                      dtype: torch.dtype) -> torch.Tensor:
    """The state f = g + w_q in ``dtype`` from bfloat16 deviations ``g``:
    the sum in float32, or in float64 for a float64 ``dtype``, as
    lettuce_tpu's decode promotes."""
    wide = torch.promote_types(torch.float32, dtype)
    return (g.to(wide) + _weights(w, wide, g.device, g.dim())).to(dtype)


def _widen(x: torch.Tensor, w, dev_storage: bool) -> torch.Tensor:
    """A 16-bit stored state (or per-node field) as wide populations: a
    16-bit state in float32; deviations decoded in float64, so that an
    entry near a deviation's zero crossing keeps its precision (the
    kernels rebuild g + w_q in float32 and agree with it to a float32
    roundoff of a population)."""
    if dev_storage:
        return decode_deviations(x, w, torch.float64)
    return x.float()


def _narrow(f: torch.Tensor, w, dtype: torch.dtype,
            dev_storage: bool) -> torch.Tensor:
    """Wide populations rounded to the storage: deviations encoded, or
    the 16-bit ``dtype``."""
    if dev_storage:
        return encode_deviations(f, w)
    return f.to(dtype)


def prestream_plain(f: torch.Tensor, spec, e: np.ndarray, w: np.ndarray,
                    opposite: np.ndarray, cs: float, ncm: torch.Tensor = None,
                    table=None, feq_field: torch.Tensor = None,
                    dev_storage: bool = False) -> torch.Tensor:
    """The kernel's pointwise pre-streaming map in plain PyTorch: the
    collision of ``spec`` (:func:`collide_plain`), then the boundary codes
    of ``table`` where ``ncm`` holds them (:func:`_replace_boundaries`).

    A 16-bit state (``dev_storage``: bfloat16 deviations, and then
    ``feq_field`` too) runs as the 16-bit kernels do: widened to
    populations (:func:`_widen`), the wide map, then rounded back to its
    storage."""
    storage_suffix(f.dtype, dev_storage)  # raises on deviations not in bf16
    if dev_storage or f.dtype in HALF_DTYPES:
        wide = prestream_plain(
            _widen(f, w, dev_storage), spec, e, w, opposite, cs, ncm, table,
            None if feq_field is None else _widen(feq_field, w, dev_storage))
        return _narrow(wide, w, f.dtype, dev_storage)
    fpost = collide_plain(f, spec, e, w, opposite, cs)
    if ncm is None:
        return fpost
    return _replace_boundaries(f, fpost, opposite, ncm, table, feq_field)


def _check_emit_u(spec, dtype: torch.dtype, dev_storage: bool) -> None:
    if fragment_of(spec) not in EMIT_U_FRAGMENTS:
        raise ValueError(f"emit_u is for {', '.join(EMIT_U_FRAGMENTS)} (the "
                         f"residual of their adjoint kernels), not "
                         f"{fragment_of(spec)!r}")
    if dev_storage:
        raise ValueError("emit_u has no deviation-storage instance: "
                         "deviation storage is a throughput mode with no "
                         "gradient")
    storage_suffix(dtype)  # raises on a dtype no kernel stores


def _check_span(n_sub, emit_u: bool = False, grad: bool = False) -> None:
    """Raise on a span or a request the blocked kernel (K2) does not
    take: it has no emit-u (lettuce_tpu's kernel refuses it, :1717), and
    a state that requires grad steps through
    :func:`.fused_step.fused_multi_step`."""
    if int(n_sub) != n_sub or n_sub < 1:
        raise ValueError(f"n_sub must be a positive integer, got {n_sub!r}")
    if n_sub == 1:
        return
    if emit_u:
        raise ValueError("emit_u is a single-step residual: the blocked "
                         "kernel (n_sub > 1) has none")
    if grad:
        raise ValueError("a state that requires grad steps n_sub > 1 "
                         "through fused_multi_step (the blocked adjoint) or "
                         "one step at a time")


def stream_collide_plain(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                         opposite: np.ndarray, cs: float, tau_inv: float,
                         ncm: torch.Tensor = None, nsm: torch.Tensor = None,
                         table=None, feq_field: torch.Tensor = None,
                         emit_u: bool = False, collision_spec=None,
                         dev_storage: bool = False, n_sub: int = 1):
    """One collide-and-stream step in plain PyTorch: the pre-streaming map
    of ``collision_spec`` (BGK with ``tau_inv`` when None,
    :func:`prestream_plain`, 16-bit states and ``dev_storage`` included),
    then a per-q ``torch.roll`` with the populations of ``nsm`` frozen.
    With ``emit_u`` (a fragment of :data:`EMIT_U_FRAGMENTS`, not under
    ``dev_storage``) it returns ``(out, u)``, u = j / rho the pre-collision
    velocity ``[d, *grid]``, in float32 for a 16-bit state (computed from
    the widened state, as the 16-bit emit-u kernel does).

    ``n_sub`` steps at once are the blocked kernel's (K2) plain version:
    ``n_sub`` plain steps, masks and all; a 16-bit state is widened once
    (:func:`_widen`), stepped wide and rounded once, as the kernel keeps
    its rings (tiles when masked) in float32 between sub-steps (no
    ``emit_u`` then)."""
    spec = ("bgk", tau_inv) if collision_spec is None else collision_spec
    if n_sub != 1:
        _check_span(n_sub, emit_u)
        half = dev_storage or f.dtype in HALF_DTYPES
        if half:
            storage_suffix(f.dtype, dev_storage)
            x = _widen(f, w, dev_storage)
            feq_field = (None if feq_field is None
                         else _widen(feq_field, w, dev_storage))
        else:
            x = f
        for _ in range(n_sub):
            x = stream_collide_plain(x, e, w, opposite, cs, tau_inv, ncm, nsm,
                                     table, feq_field, collision_spec=spec)
        return _narrow(x, w, f.dtype, dev_storage) if half else x
    if emit_u:
        _check_emit_u(spec, f.dtype, dev_storage)
    fpost = prestream_plain(f, spec, e, w, opposite, cs, ncm, table,
                            feq_field, dev_storage)
    out = stream(fpost, e, nsm)
    if not emit_u:
        return out
    x = f.to(compute_dtype(f.dtype))
    et = torch.as_tensor(np.asarray(e), dtype=x.dtype, device=f.device)
    u = torch.tensordot(et.T, x, dims=1) / torch.sum(x, dim=0, keepdim=True)
    return out, u


# ----------------------------------------------------------------------
# the collision spec and its kernel parameters
# ----------------------------------------------------------------------
def fragment_of(spec) -> str:
    """The kernel fragment of a collision spec: its kind, or
    ``mrt_<meq_kind>``."""
    return f"mrt_{spec[4]}" if spec[0] == "mrt" else spec[0]


def _fold_pairs(C: np.ndarray, opposite, what: str) -> list:
    """``[ce, co]``, the f-space matrix C folded by opposite-pair parity
    (flattened): the even block ce (rows: the rest and the first member of
    each pair; columns: the rest and the pair sums) and the odd block co
    (pair differences), as csrc/collide_mrt.cu's ``apply_c`` reads them.
    Raises NotImplementedError when C does not commute with the opposite
    permutation, which the fold needs."""
    perm = np.asarray(opposite)
    if not np.allclose(C[np.ix_(perm, perm)], C, atol=1e-11):
        raise NotImplementedError(
            f"{what} does not commute with the opposite permutation")
    firsts = [a for a in range(len(perm)) if a < perm[a]]
    pairs = [(a, perm[a]) for a in firsts]
    reps = [0] + firsts
    ce = np.array([[C[r, 0]] + [0.5 * (C[r, a] + C[r, b]) for a, b in pairs]
                   for r in reps])
    co = np.array([[0.5 * (C[a, x] - C[a, y]) for x, y in pairs]
                   for a in firsts])
    return [ce.ravel(), co.ravel()]


def _mrt_matrix(spec) -> np.ndarray:
    """C = M^-1 diag(1/tau) M of an MRT spec."""
    _, M, Minv, taus, _ = spec
    s = 1.0 / np.asarray(taus, dtype=np.float64)
    return (np.asarray(Minv, dtype=np.float64)
            @ (s[:, None] * np.asarray(M, dtype=np.float64)))


def _mrt_params(spec, opposite) -> np.ndarray:
    """The MRT fragment's kernel parameters: C = M^-1 diag(1/tau) M folded
    by opposite-pair parity (:func:`_fold_pairs`), then for a closed-form
    equilibrium A = M^-1 diag(1/tau) on the same rows (ae, ao). Raises
    NotImplementedError when C does not commute with the opposite
    permutation or a moment lacks the parity the kernel assumes."""
    _, M, Minv, taus, meq_kind = spec
    M = np.asarray(M, dtype=np.float64)
    Minv = np.asarray(Minv, dtype=np.float64)
    s = 1.0 / np.asarray(taus, dtype=np.float64)
    perm = np.asarray(opposite)
    firsts = [a for a in range(len(perm)) if a < perm[a]]
    reps = [0] + firsts
    parts = _fold_pairs(_mrt_matrix(spec), opposite, "the MRT matrix")
    if meq_kind != "from_feq":
        parity = np.asarray(MRT_PARITY[meq_kind], dtype=np.float64)
        if not np.allclose(M[:, perm], M * parity[:, None], atol=1e-11):
            raise NotImplementedError(
                f"the {meq_kind} moments lack the parity the kernel assumes")
        A = Minv * s[None, :]
        if not np.allclose(A[perm], A * parity[None, :], atol=1e-11):
            raise NotImplementedError(
                f"the {meq_kind} relaxation breaks the moment parity")
        parts += [A[reps].ravel(), A[firsts].ravel()]
    return np.ascontiguousarray(np.concatenate(parts), dtype=np.float64)


def adjoint_collision_spec(spec, e, w, cs) -> tuple:
    """The adjoint spec of the forward collision ``spec``, as
    lettuce_tpu's ``adjoint_collision_spec`` derives it: an f-linear
    collision f' = f - C (f - feq) transposes as ``("matvec", C^T)`` (the
    folded MRT ``from_feq``, C = M^-1 diag(1/tau) M, and the regularized,
    C = I - (1 - 1/tau) P with the static projection
    P_ij = w_i ((e_i.e_j)^2 - cs^2 |e_j|^2) / (2 cs^4)); BGK, TRT,
    Smagorinsky, KBC and the identity keep their spec (KBC's adjoint is a
    kernel of the port's own: lettuce_tpu runs it in split mode); every
    other collision (forced BGK, the closed-form MRT bases) gives
    ``("split",)``: no closed-form Jacobian, so its gradient runs split
    mode."""
    kind = spec[0]
    if kind == "mrt" and spec[4] == "from_feq":
        return ("matvec", tuple(map(tuple, _mrt_matrix(spec).T)))
    if kind == "reg":
        e = np.asarray(e, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        cs2 = float(cs) ** 2
        G = e @ e.T
        P = ((G * G - cs2 * (e * e).sum(axis=1)[None, :])
             * (w[:, None] / (2.0 * cs2 * cs2)))
        C = np.eye(len(w)) - (1.0 - 1.0 / float(spec[1])) * P
        return ("matvec", tuple(map(tuple, C.T)))
    if kind in ("bgk", "trt", "smag", "kbc", "none"):
        return tuple(spec)
    return ("split",)


class PackedSpec(tuple):
    """A collision spec with its kernel fragment (``fragment``), the
    stencil instance it was packed for (``stencil``), the float64 array
    the fragment's C entry reads (``params``), and its adjoint: the spec
    of :func:`adjoint_collision_spec` (``adjoint``), the float64 array its
    kernel's C entry reads (``adjoint_params``; for ``matvec`` C^T folded
    by opposite-pair parity), ``mode`` (``'full'``: one adjoint kernel;
    ``'split'``: the ``none`` adjoint kernel, then the VJP of the
    pre-streaming map) and ``residual``, what the forward saves for it
    (``'u'`` the emitted pre-collision velocity, ``'f'`` the step's input,
    or None). It compares and iterates as the spec."""

    def __new__(cls, spec, stencil, params, adjoint, adjoint_params):
        self = super().__new__(cls, spec)
        self.fragment = fragment_of(spec)
        self.stencil = stencil
        self.params = params
        self.adjoint = adjoint
        self.adjoint_params = adjoint_params
        self.mode = "split" if adjoint[0] == "split" else "full"
        self.residual = {"bgk": "u", "trt": "u", "matvec": "u", "smag": "f",
                         "kbc": "f", "none": None,
                         "split": "f"}[adjoint[0]]
        return self


def _pack_adjoint(spec, e, w, opposite, cs) -> tuple:
    """(the adjoint spec, the float64 array its kernel reads)."""
    adjoint = adjoint_collision_spec(spec, e, w, cs)
    if adjoint[0] == "matvec":
        params = np.concatenate(_fold_pairs(
            np.asarray(adjoint[1]), opposite,
            "the transposed relaxation matrix"))
    else:  # bgk, trt, smag, kbc: the spec's scalars; none and split: none
        params = adjoint[1:] or (0.0,)
    return adjoint, np.ascontiguousarray(params, dtype=np.float64)


def pack_spec(spec, e, w, opposite) -> PackedSpec:
    """``spec`` packed for the stencil (e, w, opposite), with its adjoint;
    a spec already packed for it is returned as it is. Raises
    NotImplementedError when no kernel instance takes it."""
    name = kernel_stencil_name(e, w, opposite)
    if isinstance(spec, PackedSpec) and spec.stencil == name:
        return spec
    fragment = fragment_of(spec)
    if fragment == "bgk":
        params = np.asarray([spec[1]], dtype=np.float64)
    else:
        if fragment not in FRAGMENTS:
            raise NotImplementedError(f"no CUDA fragment {fragment!r}")
        if name not in FRAGMENTS[fragment][1]:
            raise NotImplementedError(
                f"the {fragment!r} fragment is compiled for "
                f"{', '.join(FRAGMENTS[fragment][1])}, not {name}")
        kind = spec[0]
        if kind == "bgk_force":
            _, tau_inv, accel, k_ueq, src_pref = spec
            a = list(accel) + [0.0] * (3 - len(accel))
            params = [tau_inv, k_ueq, float(src_pref is not None),
                      0.0 if src_pref is None else src_pref, *a]
        elif kind == "mrt":
            params = _mrt_params(spec, opposite)
        else:  # none, trt, reg, smag, kbc: the spec's scalars
            params = spec[1:]
        params = np.ascontiguousarray(params, dtype=np.float64)
    cs = KERNEL_STENCILS[KERNEL_STENCIL_NAMES.index(name)].cs
    return PackedSpec(spec, name, params,
                      *_pack_adjoint(spec, e, w, opposite, cs))


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
            grid = [ctypes.c_int64] * 3 + [pointer]  # + the geometry
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


@functools.cache
def load_fragment_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of the collision fragments
    ``csrc/<source>.cu`` (a source of :data:`FRAGMENTS`), with
    ``argtypes`` set on every entry."""
    lib = open_library(source)
    pointer = ctypes.c_void_p
    grid = [ctypes.c_int64] * 3 + [pointer]  # + the geometry
    tail = [pointer, ctypes.c_double, ctypes.c_int, pointer]
    for fragment, (src, names) in FRAGMENTS.items():
        if src != source:
            continue
        # (variant, tensors): periodic f, out (+ u); masked f, out (+ u),
        # ncm, nsm, feq field, host kinds, host values
        variants = [("", 2), ("masked_", 7)]
        if fragment in EMIT_U_FRAGMENTS:
            variants += [("emit_u_", 3), ("masked_emit_u_", 8)]
        for name in names:
            for suffix, _ in DTYPES.values():
                for variant, n_pointers in variants:
                    fn = getattr(lib, f"lt_collide_{fragment}_{variant}"
                                      f"{name}_{suffix}")
                    fn.argtypes = [pointer] * n_pointers + grid + tail
                    fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_half_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the 16-bit instances of
    ``csrc/<source>.cu`` (``"stream_collide"`` or a source of
    :data:`FRAGMENTS`; the library of :data:`HALF_SOURCES`), with
    ``argtypes`` set on every entry: periodic and masked, for each storage
    of :data:`.build.STORAGE` (no deviations for :data:`DEV_REFUSED`), and
    the emit-u entries of :data:`EMIT_U_FRAGMENTS` on a bfloat16 or
    float16 state."""
    lib = open_library(HALF_SOURCES[source])
    pointer = ctypes.c_void_p
    grid = [ctypes.c_int64] * 3 + [pointer]  # + the geometry
    if source == "stream_collide":  # BGK: tau_inv as a float
        entries = [("stream_collide", "bgk", KERNEL_STENCIL_NAMES)]
        tail = [ctypes.c_float, ctypes.c_double, ctypes.c_int, pointer]
    else:
        entries = [(f"collide_{fragment}", fragment, names)
                   for fragment, (src, names) in FRAGMENTS.items()
                   if src == source]
        tail = [pointer, ctypes.c_double, ctypes.c_int, pointer]
    for prefix, fragment, names in entries:
        for suffix in STORAGE.values():
            if suffix == "bf16_dev" and fragment in DEV_REFUSED:
                continue
            # periodic f, out (+ u); masked f, out (+ u), ncm, nsm, feq
            # field, host kinds, host values
            variants = [("", 2), ("masked_", 7)]
            if fragment in EMIT_U_FRAGMENTS and suffix != "bf16_dev":
                variants += [("emit_u_", 3), ("masked_emit_u_", 8)]
            for name in names:
                for variant, n_pointers in variants:
                    fn = getattr(lib, f"lt_{prefix}_{variant}{name}_"
                                      f"{suffix}")
                    fn.argtypes = [pointer] * n_pointers + grid + tail
                    fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_multi_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the blocked instances (K2) of
    ``csrc/<source>.cu`` (``"stream_collide"`` or a source of
    :data:`FRAGMENTS`; the library of :data:`MULTI_SOURCES`), with
    ``argtypes`` set on every entry: f, out, scratch, the masks (ncm, nsm,
    feq field, host kinds, host values; null for a periodic launch), the
    grid, n_sub, the march's interior (the cross-section's, and the
    segment's planes on the march axis), the blocks and their threads,
    the float64 parameters, cs, device, stream; every storage (no
    deviations for :data:`DEV_REFUSED`)."""
    lib = open_library(MULTI_SOURCES[source])
    pointer = ctypes.c_void_p
    argtypes = ([pointer] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 6
                + [pointer, ctypes.c_double, ctypes.c_int, pointer])
    if source == "stream_collide":
        entries = [("bgk", KERNEL_STENCIL_NAMES)]
    else:
        entries = [(fragment, names)
                   for fragment, (src, names) in FRAGMENTS.items()
                   if src == source]
    for fragment, names in entries:
        for suffix in (*(s for s, _ in DTYPES.values()), *STORAGE.values()):
            if suffix == "bf16_dev" and fragment in DEV_REFUSED:
                continue
            for name in names:
                fn = getattr(lib, f"lt_multi_{fragment}_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


def load_libraries() -> None:
    """Build (if needed) and load every kernel library of the step, the
    16-bit and the blocked instances included."""
    load_library()
    for source in sorted({src for src, _ in FRAGMENTS.values()}):
        load_fragment_library(source)
    for source in HALF_SOURCES:
        load_half_library(source)
    for source in MULTI_SOURCES:
        load_multi_library(source)


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
    if nsm is not None:
        check_nsm(f, nsm)
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


def check_nsm(f: torch.Tensor, nsm: torch.Tensor) -> None:
    """Raise on a no-streaming mask the kernels do not take for a state
    like ``f``."""
    if (nsm.dtype != torch.bool or tuple(nsm.shape) != tuple(f.shape)
            or nsm.device != f.device or not nsm.is_contiguous()):
        raise ValueError(f"nsm must be a contiguous bool tensor of shape "
                         f"{tuple(f.shape)} on {f.device}")


def stream_collide(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                   opposite: np.ndarray, cs: float, tau_inv: float,
                   ncm: torch.Tensor = None, nsm: torch.Tensor = None,
                   table=None, feq_field: torch.Tensor = None,
                   out: torch.Tensor = None, u_out: torch.Tensor = None,
                   collision_spec=None, dev_storage: bool = False,
                   n_sub: int = 1):
    """One fused collide-and-stream step ``f -> out`` (``n_sub`` steps in
    one launch of the blocked kernel, K2, when ``n_sub > 1``).

    ``f`` is ``[q, X, Y]`` or ``[q, X, Y, Z]``. The collision is
    ``collision_spec`` (a spec or a :class:`PackedSpec`), or BGK with
    ``tau_inv`` when it is None. On a CPU tensor this is
    :func:`stream_collide_plain`; on a CUDA tensor it launches the
    fragment's kernel (allocating ``out`` when none is given) or raises.
    ``out`` must not be ``f``: the kernel pushes to neighbours. With
    ``ncm`` (the uint8 code per cell) and its ``table`` the masked kernel
    runs, with the optional ``nsm`` and ``feq_field``. With ``u_out``
    (``[d, *grid]``, a fragment of :data:`EMIT_U_FRAGMENTS`; float32 for a
    16-bit state) the emit-u kernel also writes the pre-collision velocity
    there, and the call returns ``(out, u_out)``.

    A bfloat16 or float16 ``f`` runs the 16-bit instances (K1f); with
    ``dev_storage`` a bfloat16 ``f`` (and ``feq_field``) holds the
    deviations g = f - w_q (K1e, :func:`encode_deviations`). Both compute
    in float32 and round each stored value to nearest even.

    A state that requires grad, with grad mode on, goes through
    :func:`.fused_step.fused_step` with the same spec and masks (fresh
    output, the spec's adjoint in the backward); ``out`` and ``u_out``
    cannot be given then, nor ``dev_storage``, a throughput mode.

    ``n_sub > 1`` runs the blocked kernel, periodic or with the same
    masks, in every storage (a 16-bit state rounded once per launch); it
    raises for ``u_out`` and a state that requires grad
    (:func:`.fused_step.fused_multi_step` is its differentiable form on a
    periodic grid).
    """
    spec = ("bgk", tau_inv) if collision_spec is None else collision_spec
    emit_u = u_out is not None
    masks = dict(ncm=ncm, nsm=nsm, table=table, feq_field=feq_field)
    _check_span(n_sub, emit_u, f.requires_grad and torch.is_grad_enabled())
    if f.requires_grad and torch.is_grad_enabled():
        if out is not None or emit_u:
            raise ValueError("out and u_out would bypass autograd: a state "
                             "that requires grad takes neither")
        if dev_storage:
            raise NotImplementedError(
                "deviation storage is a throughput mode: a state that "
                "requires grad runs at full precision")
        from .fused_step import fused_step
        return fused_step(f, e=e, w=w, opposite=opposite, cs=cs,
                          tau_inv=tau_inv, collision_spec=spec, **masks)
    if f.device.type == "cpu":
        result = stream_collide_plain(f, e, w, opposite, cs, tau_inv,
                                      emit_u=emit_u, collision_spec=spec,
                                      dev_storage=dev_storage, n_sub=n_sub,
                                      **masks)
        if emit_u:
            result, u = result
            u_out.copy_(u)
        out = result if out is None else out.copy_(result)
        return (out, u_out) if emit_u else out
    if f.device.type != "cuda":
        raise ValueError(f"stream_collide runs on cpu or cuda tensors, "
                         f"got {f.device}")
    if n_sub > 1:
        return _launch_multi(f, out, pack_spec(spec, e, w, opposite), n_sub,
                             e, cs, dev_storage, **masks)
    return _launch(f, out, u_out, spec, e, w, opposite, cs, dev_storage,
                   **masks)


def _aligned(cells: int, *tensors) -> bool:
    """Whether each tensor's data starts on the alignment of ``cells`` of
    its elements (None passes)."""
    return all(x is None or x.data_ptr() % (cells * x.element_size()) == 0
               for x in tensors)


def cell_plan(f: torch.Tensor, e, fragment: str = "bgk", masked=False,
              dev_storage: bool = False, frozen: bool = False,
              tensors=(), cells: int = None, division: str = None,
              min_blocks: int = None, name: str = None):
    """The geometry of a single-step launch of ``fragment`` over the state
    ``f`` (:func:`.build.plan_cells`): a ``masked`` 16-bit launch gives a
    thread the cells its stencil and storage ship
    (:func:`.build.cells_of`), as vectors unless ``frozen`` populations or
    one of ``tensors`` (the launch's state, output, codes and u) is off
    their alignment; the instance's minimum blocks per SM
    (:func:`.build.min_blocks_of`). ``cells``, ``division`` and
    ``min_blocks`` replace the defaults (phase 36's candidates); ``name``
    is the compiled stencil's, when the caller knows it."""
    name = name or _stencil_name(e)
    suffix = storage_suffix(f.dtype, dev_storage)
    if cells is None:
        cells = cells_of(fragment, name, suffix, masked)[0]
    if min_blocks is None:
        min_blocks = min_blocks_of(fragment, name, suffix, masked)[0]
    return plan_cells(launch_dims(f, e), cells,
                      _aligned(cells, f, *tensors), frozen, division,
                      min_blocks)


def _stencil_name(e) -> str:
    """The compiled stencil whose velocities are ``e``."""
    e = np.asarray(e)
    for name, stencil in zip(KERNEL_STENCIL_NAMES, KERNEL_STENCILS):
        if e.shape == stencil.e.shape and np.array_equal(e, stencil.e):
            return name
    raise ValueError(f"no compiled CUDA kernel for the stencil with e of "
                     f"shape {e.shape}")


def _launch(f: torch.Tensor, out, u_out, spec, e, w, opposite, cs: float,
            dev_storage: bool, ncm=None, nsm=None, table=None,
            feq_field=None, plan=None):
    """One single-step launch (K1) of ``spec`` on the CUDA state ``f``
    into ``out`` (and ``u_out``), masked when ``ncm`` is given, over the
    geometry of ``plan`` when given (a :class:`.build.CellPlan`), else of
    :func:`cell_plan`'s."""
    with tracing.span("launch"):
        emit_u = u_out is not None
        if emit_u:
            _check_emit_u(spec, f.dtype, dev_storage)
        suffix = storage_suffix(f.dtype, dev_storage)
        half = dev_storage or f.dtype in HALF_DTYPES
        bgk = spec[0] == "bgk"
        name = kernel_stencil_name(e, w, opposite)
        n0, n1, n2 = launch_dims(f, e)
        out = check_out(out, f, f.shape, "out", f)
        pointers = [f.data_ptr(), out.data_ptr()]
        if emit_u:
            d = np.asarray(e).shape[1]
            u_out = check_out(u_out, f, (d, *f.shape[1:]), "u_out", f, out,
                              dtype=compute_dtype(f.dtype))
            pointers.append(u_out.data_ptr())
        masked = ncm is not None
        if masked:
            # alive until the call returns
            table = checked_table(f, ncm, nsm, table, feq_field)
            pointers += [ncm.data_ptr(),
                         None if nsm is None else nsm.data_ptr(),
                         None if feq_field is None else feq_field.data_ptr(),
                         table.kinds.ctypes.data, table.values.ctypes.data]
        if not bgk:
            spec = pack_spec(spec, e, w, opposite)  # alive until it returns
            if dev_storage and spec.fragment in DEV_REFUSED:
                raise NotImplementedError(
                    f"the {spec.fragment!r} fragment has no deviation-"
                    f"storage instance: its closed-form equilibrium moments "
                    f"are not shift-invariant in f")
        fragment = "bgk" if bgk else spec.fragment
        if plan is None:
            plan = cell_plan(f, e, fragment, masked, dev_storage,
                             frozen=nsm is not None,
                             tensors=(out, ncm, u_out), name=name)
        geometry = plan.geometry()  # alive until the call returns
        stream_ptr = torch.cuda.current_stream(f.device).cuda_stream
        variant = ("masked_" if masked else "") + ("emit_u_" if emit_u
                                                   else "")
        if bgk:
            lib = (load_half_library("stream_collide") if half
                   else load_library())
            launch = getattr(lib, f"lt_stream_collide_{variant}{name}_"
                                  f"{suffix}")
            params = float(spec[1])
        else:
            source = FRAGMENTS[spec.fragment][0]
            lib = (load_half_library(source) if half
                   else load_fragment_library(source))
            launch = getattr(lib, f"lt_collide_{spec.fragment}_{variant}"
                                  f"{name}_{suffix}")
            params = spec.params.ctypes.data
        with tracing.span("enqueue"):
            rc = launch(*pointers, n0, n1, n2, geometry.ctypes.data, params,
                        float(cs), f.device.index, stream_ptr)
        check_launch(lib, rc, f"stream_collide ({fragment}, "
                              f"{variant or 'periodic_'}{name}_{suffix})")
        tracing.count(tracing.launch_key("K1", variant, fragment, suffix))
        return (out, u_out) if emit_u else out


def march_plan(f: torch.Tensor, e, n_sub: int, adjoint: bool = False,
               halo: int = None, candidates: bool = False,
               masked: bool = False, frozen: bool = False,
               rows: bool = None):
    """The columns of a marched launch over the state ``f``
    (:func:`.build.plan_march`): K2 (n_sub levels, a halo and a march halo
    of n_sub; ``masked`` with the codes' rows, ``frozen`` populations
    adding their bits and a kept plane) or K4 (``adjoint``: a cross halo
    of ``halo``, 2 (n_sub - 1) planes before and after a segment), ring
    values of the compute type (:func:`.build.march_values`), the waves
    filled on the SMs of ``f``'s card (132 off the card). With
    ``candidates``, every plan :func:`.build.march_candidates` offers, the
    default first (``rows`` forces the row budgets on or off)."""
    itemsize = torch.finfo(compute_dtype(f.dtype)).bits // 8
    dims = tuple(int(n) for n in launch_dims(f, e))
    q, d = np.asarray(e).shape
    sms = (torch.cuda.get_device_properties(f.device).multi_processor_count
           if f.device.type == "cuda" else 132)
    keep = ring_keep(e) if masked and frozen else 0
    plans = march_candidates(
        dims, moving_axes(e), int(n_sub if halo is None else halo),
        2 * (int(n_sub) - 1) if adjoint else int(n_sub),
        march_values(q, d, int(n_sub), adjoint, keep), itemsize, q, adjoint,
        sms, bool(masked), bool(masked and frozen), rows)
    return plans if candidates else plans[0]


def march_scratch(plan, device):
    """The global scratch of a marched launch (None in shared memory):
    ``plan.blocks`` slices of its buffer's bytes, rounded up to 16."""
    if not plan.scratch:
        return None
    return torch.empty(plan.blocks * tile_stride(plan.bytes),
                       dtype=torch.uint8, device=device)


def _launch_multi(f: torch.Tensor, out, spec: PackedSpec, n_sub: int, e,
                  cs: float, dev_storage: bool, ncm=None, nsm=None,
                  table=None, feq_field=None, plan=None) -> torch.Tensor:
    """One launch of the blocked kernel (K2): ``n_sub`` steps of the
    packed ``spec`` on the CUDA state ``f`` into ``out``, masked when
    ``ncm`` is given (with the optional ``nsm`` and ``feq_field``), over
    the columns of ``plan`` when given (a :class:`.build.MarchPlan` of
    :func:`.build.march_candidates` for the same masks), else of
    :func:`march_plan`'s."""
    with tracing.span("launch"):
        suffix = storage_suffix(f.dtype, dev_storage)
        if dev_storage and spec.fragment in DEV_REFUSED:
            raise NotImplementedError(
                f"the {spec.fragment!r} fragment has no deviation-storage "
                f"instance: its closed-form equilibrium moments are not "
                f"shift-invariant in f")
        source = ("stream_collide" if spec.fragment == "bgk"
                  else FRAGMENTS[spec.fragment][0])
        lib = load_multi_library(source)
        masked = ncm is not None
        pointers = [None] * 5
        if masked:
            # alive until the call returns
            table = checked_table(f, ncm, nsm, table, feq_field)
            pointers = [ncm.data_ptr(),
                        None if nsm is None else nsm.data_ptr(),
                        None if feq_field is None else feq_field.data_ptr(),
                        table.kinds.ctypes.data, table.values.ctypes.data]
        dims = tuple(int(n) for n in launch_dims(f, e))
        if plan is None:
            plan = march_plan(f, e, n_sub, masked=masked,
                              frozen=nsm is not None)
        scratch = march_scratch(plan, f.device)
        out = check_out(out, f, f.shape, "out", f)
        launch = getattr(lib, f"lt_multi_{spec.fragment}_{spec.stencil}_"
                              f"{suffix}")
        with tracing.span("enqueue"):
            rc = launch(f.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        *pointers, *dims, int(n_sub), *plan.interior,
                        plan.blocks, plan.threads, spec.params.ctypes.data,
                        float(cs), f.device.index,
                        torch.cuda.current_stream(f.device).cuda_stream)
        variant = "masked_" if masked else ""
        check_launch(lib, rc, f"stream_collide ({spec.fragment}, blocked "
                              f"{variant}x{n_sub} {spec.stencil}_{suffix})")
        tracing.count(tracing.launch_key("K2", variant, spec.fragment, suffix,
                                         n_sub))
        return out


# ----------------------------------------------------------------------
# the simulation gate
# ----------------------------------------------------------------------
def collision_spec_of(simulation: "Simulation") -> tuple:
    """``(spec, reason)``: the kernel's collision spec for the
    simulation's collision, as lettuce_tpu's gate builds it, or ``(None,
    reason)`` when the collision has no kernel fragment."""
    collision = simulation.collision
    flow = simulation.flow
    name = type(collision).__name__

    def tau_or_units(tau):
        return float(tau if tau is not None
                     else flow.units.relaxation_parameter_lu)

    if isinstance(collision, BGKCollision):
        tau_inv = float(1.0 / collision.tau)
        force = collision.force
        if force is None:
            return ("bgk", tau_inv), None
        accel = getattr(force, "acceleration", None)
        if accel is None or accel.ndim != 1:
            return None, (f"force '{type(force).__name__}' has a per-node "
                          f"acceleration: the forced-BGK fragment takes a "
                          f"uniform one")
        if isinstance(force, Guo):
            src_pref = float(1.0 - 1.0 / (2.0 * force.tau))
        elif isinstance(force, ShanChen):
            src_pref = None
        else:
            return None, (f"force '{type(force).__name__}' has no CUDA "
                          f"fragment")
        return ("bgk_force", tau_inv,
                tuple(float(a) for a in accel.cpu().tolist()),
                float(force.ueq_scaling_factor), src_pref), None
    if isinstance(collision, NoCollision):
        return ("none",), None
    if isinstance(collision, TRTCollision):
        return ("trt", float(collision.tau_plus),
                float(collision.tau_minus)), None
    if isinstance(collision, SmagorinskyCollision):
        if collision.force is not None:
            return None, ("collision 'SmagorinskyCollision' with a force has "
                          "no CUDA fragment")
        return ("smag", float(collision.tau),
                float(collision.constant)), None
    if isinstance(collision, RegularizedCollision):
        return ("reg", tau_or_units(collision.tau)), None
    if isinstance(collision, MRTCollision):
        try:
            return resolve_mrt_spec(collision), None
        except NotImplementedError as refusal:
            return None, f"collision '{name}': {refusal}"
    if isinstance(collision, KBCCollision):
        return ("kbc", tau_or_units(collision.tau)), None
    return None, f"collision '{name}' has no CUDA fragment"


def kernel_refusals(simulation: "Simulation",
                    dev_storage: bool = False) -> list:
    """Why a Simulation cannot run on the kernels, one reason per
    component (an empty list when it can); with ``dev_storage``, on the
    bfloat16 deviation instances (K1e), which also refuse what
    lettuce_tpu's ``build_fused_step`` refuses there (:1998-2007): the
    closed-form MRT bases and the outlets' window replay. The capability
    probe prints these and :func:`gate_fused_params` raises on them, so the
    two always agree. Host-side checks only: nothing is built or
    launched."""
    flow = simulation.flow
    reasons = []  # every dtype a Context takes has instances
    if not isinstance(flow.stencil, KERNEL_STENCILS):
        reasons.append(f"stencil '{type(flow.stencil).__name__}' has no "
                       f"CUDA kernel instance (compiled for "
                       f"{', '.join(s.__name__ for s in KERNEL_STENCILS)})")
    equilibrium = flow.equilibrium
    if not (equilibrium.native_available()
            and isinstance(equilibrium, QuadraticEquilibrium)):
        reasons.append(f"equilibrium '{type(equilibrium).__name__}' does "
                       f"not support the CUDA kernel")
    spec, reason = collision_spec_of(simulation)
    if reason is not None:
        reasons.append(reason)
    elif isinstance(flow.stencil, KERNEL_STENCILS):
        stencil = flow.stencil
        try:
            pack_spec(spec, stencil.e, stencil.w, stencil.opposite)
        except NotImplementedError as refusal:
            reasons.append(f"collision '{type(simulation.collision).__name__}"
                           f"': {refusal}")
        if dev_storage and fragment_of(spec) in DEV_REFUSED:
            reasons.append("the analytic-moment MRT fragment is not "
                           "shift-invariant: no deviation storage")
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
            if dev_storage:
                reasons.append(f"outlet '{name}': the window replay "
                               f"operates on f, not on deviations")
        elif not isinstance(boundary, (BounceBackBoundary,
                                       EquilibriumBoundaryPU)):
            reasons.append(f"boundary '{name}' has no kind in the CUDA "
                           f"kernel's table")
    return reasons


def gate_fused_params(simulation: "Simulation",
                      dev_storage: bool = False) -> tuple:
    """Static kernel parameters for a Simulation, and its hybrid outlets.

    Returns ``(params, hybrid)``. ``params`` are the keyword arguments of
    :func:`stream_collide`, :func:`.adjoint.stream_collide_adjoint` and
    :func:`.fused_step.fused_step`: the stencil tables, ``cs``, the
    ``collision_spec`` (a :class:`PackedSpec`, packed here once) and
    ``tau_inv`` (its 1/tau for BGK, else None), and with boundaries the
    masks (``ncm``, ``nsm``, None
    when no population is frozen), the per-code ``table`` (a
    :class:`PackedTable`, checked and packed here once) and the combined
    per-node ``feq_field`` (or None). ``hybrid`` is a tuple of
    ``(code, outlet)`` for the outlets the kernel leaves frozen (identity)
    and the window replay rewrites. Raises NotImplementedError with
    :func:`kernel_refusals`' reasons when the configuration cannot run on
    the kernels.

    With ``dev_storage`` the parameters are those of a bfloat16 deviation
    state (``dev_storage=True`` among them, for :func:`stream_collide`
    alone): the per-node field is encoded like the state
    (:func:`encode_deviations`), the table stays in f.
    """
    reasons = kernel_refusals(simulation, dev_storage)
    if reasons:
        raise NotImplementedError("; ".join(reasons))
    flow = simulation.flow
    stencil = flow.stencil
    spec = pack_spec(collision_spec_of(simulation)[0], stencil.e, stencil.w,
                     stencil.opposite)
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=float(stencil.cs),
                  tau_inv=spec[1] if spec[0] == "bgk" else None,
                  collision_spec=spec)
    state = flow.f
    if dev_storage:
        params.update(dev_storage=True)
        # what the masks are checked against: a deviation state's shape,
        # dtype and device, without its memory
        state = torch.empty((), dtype=torch.bfloat16,
                            device=flow.f.device).expand(flow.f.shape)
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
    if dev_storage and feq_field is not None:
        feq_field = encode_deviations(feq_field, stencil.w)
    params.update(ncm=ncm, nsm=nsm, feq_field=feq_field,
                  table=checked_table(state, ncm, nsm, table, feq_field))
    return params, tuple(hybrid)


def without_nsm(params: dict) -> dict:
    """The gate's ``params`` with the no-streaming mask dropped and the
    table checked and packed again without it: for a kernel whose frozen
    populations all lie on planes the window replay rewrites
    (:func:`.hybrid_outlets.nsm_outside_regions`)."""
    shape, dtype, device, ncm, _, feq_field = params["table"].checked
    like = torch.empty((), dtype=dtype, device=device).expand(shape)
    return dict(params, nsm=None, table=checked_table(
        like, ncm, None, tuple(params["table"]), feq_field))


def blocking_refusals(simulation: "Simulation", span: int,
                      dev_storage: bool = False) -> list:
    """Why a Simulation on the kernel path cannot run the blocked kernel
    (K2) at ``span`` steps per launch, as lettuce_tpu's
    ``build_fused_multi_step`` refuses (:2216-2331): deviation storage
    with outlets (the window replay operates on f) or with the closed-form
    MRT bases, and an outlet whose replay window at this span covers its
    whole axis. Host-side checks only."""
    reasons = []
    spec, _ = collision_spec_of(simulation)
    if (dev_storage and spec is not None
            and fragment_of(spec) in DEV_REFUSED):
        reasons.append("the analytic-moment MRT fragment is not "
                       "shift-invariant: no deviation storage")
    for code, boundary in enumerate(simulation.boundaries[1:], start=1):
        if type(boundary) not in HYBRID_OUTLET_TYPES:
            continue
        name = type(boundary).__name__
        if dev_storage:
            reasons.append(f"outlet '{name}': the window replay operates on "
                           f"f, not on deviations")
            continue
        try:
            outlet_window(simulation.no_collision_mask, code,
                          boundary.face_axis, span)
        except NotImplementedError as refusal:
            reasons.append(f"outlet '{name}' has no window replay at span "
                           f"{span} ({refusal})")
    return reasons


def build_fused_multi_step(simulation: "Simulation",
                           dev_storage: bool = False, n_sub: int = None):
    """The temporally blocked step of a Simulation on the kernel path:
    ``(step, span)``, ``step`` advancing ``span`` steps per launch of the
    blocked kernel (K2), or None. The counterpart of lettuce_tpu's
    ``build_fused_multi_step`` (:2195-2410).

    The span comes from ``LETTUCE_NSUB`` (0 disables), then from
    ``n_sub``; with neither it is None, on a CUDA context too: blocking
    has not been shown to pay on this card yet. When a span is asked for
    and the configuration cannot block (:func:`blocking_refusals`) it
    prints the reasons, as the capability probe does, and returns None;
    the single-step kernel then runs. A span that no march holds raises
    (:func:`.build.plan_march`); a build or launch error is never caught.

    ``step`` is :func:`.fused_step.fused_multi_step` bound to the launch's
    parameters (``step.params``: the gate's, with ``dev_storage`` those of
    bfloat16 deviations) and to the outlets' window replay at this span
    (``step.fixup``, None without outlets), applied after each launch. The
    kernel runs without the no-streaming mask when every frozen
    population lies on the planes that replay rewrites, so the mask may be
    dropped here and kept for the single-step kernel, or the reverse.
    ``step.adjoint_kernel`` says whether the blocked adjoint (K4) takes
    its gradient: a periodic grid in float32, float64, bfloat16 or
    float16 (K4 at 16 bits), the f-linear specs and the identity
    (:func:`.adjoint.adjoint_multi_refusal`, whose reason it prints
    otherwise); never under deviations, masks or a replay (lettuce_tpu
    :2360-2362), whose gradients run the single-step kernels."""
    from .adjoint import adjoint_multi_refusal
    from .fused_step import fused_multi_step
    env = os.environ.get("LETTUCE_NSUB")
    span = int(env) if env is not None else n_sub
    if span is None or int(span) <= 1:
        return None
    span = int(span)
    reasons = blocking_refusals(simulation, span, dev_storage)
    for reason in reasons:
        print(f"temporal blocking (span {span}) was requested, but "
              f"{reason}; the single-step kernel runs.")
    if reasons:
        return None
    params, hybrid = gate_fused_params(simulation, dev_storage)
    fixup = None
    if hybrid:
        fixup, regions = build_hybrid_fixup(simulation, hybrid, n_sub=span)
        if (params["nsm"] is not None
                and not nsm_outside_regions(params["nsm"], regions)):
            params = without_nsm(params)
    stencil = simulation.flow.stencil
    dtype = simulation.flow.f.dtype
    dims = tuple(int(n) for n in simulation.flow.f.shape[1:])
    dims = (1,) * (3 - len(dims)) + dims
    itemsize = 8 if dtype == torch.float64 and not dev_storage else 4
    masked = params.get("ncm") is not None
    # raises past what a march holds
    frozen = masked and params.get("nsm") is not None
    plan_march(dims, moving_axes(stencil.e), span, span,
               march_values(stencil.q, stencil.d, span,
                            keep=ring_keep(stencil.e) if frozen else 0),
               itemsize, stencil.q, masked=masked, frozen=frozen)
    step = functools.partial(fused_multi_step, n_sub=span, fixup=fixup,
                             **params)
    step.params, step.fixup = params, fixup
    step.adjoint_kernel = False
    if not (dev_storage or masked):
        reason = adjoint_multi_refusal(params["collision_spec"], dtype)
        if reason is not None:
            print(f"temporal blocking (span {span}) runs, but {reason}; "
                  f"gradients run the single-step adjoint.")
        step.adjoint_kernel = reason is None
    return step, span
