"""Adjoint of the fused collide-and-stream step: the hand-written CUDA
kernels, their plain PyTorch version, and the VJP of the pointwise
pre-streaming map that split mode composes after them.

The kernels replace ``lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel``
in float32 and float64, for D2Q9, D3Q15, D3Q19 and D3Q27, periodic and
masked: ``csrc/adjoint.cu`` for the ``("bgk", tau_inv)`` spec (K3a, K3c)
and ``csrc/adjoint_fragments.cu`` for the other adjoint specs
(:data:`ADJOINT_FRAGMENTS`, K3b; KBC's, K3 kbc, on D2Q9 and D3Q27
only). The adjoint spec of a forward collision is packed with it
(:func:`.stream_collide.adjoint_collision_spec`,
:class:`.stream_collide.PackedSpec`). Given the cotangent ``g`` of a
step's output and the forward's residual (the pre-collision velocity u
the emit-u forward wrote, or the step's input f), a kernel returns the
cotangent of the step's input, the exact vector-Jacobian product::

    h_q(x) = g_q(x + e_q)  (periodic), or with frozen populations
    h_q(x) = (nsm_q(x + e_q) ? 0 : g_q(x + e_q)) + (nsm_q(x) ? g_q(x) : 0),
    t = M^T h, the transposed relaxation of f' = f - M (f - feq(f)):
        bgk     t = tau_inv h,
        trt     t_q = (cp + cm) h_q + (cp - cm) h_opp(q),
                cp = 1 / (2 tau_plus), cm = 1 / (2 tau_minus),
        matvec  t = C^T h (the folded MRT, the regularized),
        smag    t = s h, s = 1 / tau_eff per cell,
        kbc     t = feq_bar, the cotangent of KBC's equilibrium (below),
    S0 = sum_q w_q t_q,  S1_a = sum_q w_q e_qa t_q,
    S2_ab = sum_q w_q e_qa e_qb t_q,
    A = S0 (1 - u.u / (2 cs^2)) + u.S1 / cs^2 + u.S2.u / (2 cs^4),
    B_a = (S1_a - u_a S0 + (S2 u)_a / cs^2) / cs^2,
    ct_q = h_q - t_q + (A - u.B) + e_q.B (+ X_q)   on collide cells,
    ct_q = h_q                                     for the identity (none),
    ct_q = h_opp(q)                                on bounce-back cells,
    ct_q = 0                                       on equilibrium cells,
    ct_q = h_q                                     on identity cells.

Smagorinsky's X_q differentiates the forward's two-step fixed point for
tau_eff (lettuce_tpu's adjoint.py:299-422): with d = f - feq, D = d.h,
Pi_ab = sum_q e_qa e_qb d_q, P = |Pi|^2 and R = P / (4 cs^4 rho^2),
X_q = D s^2 (dtau/dR) (e_q.Pi.e_q - cs^2 tr Pi - 2 e_q.Pi u + u.Pi.u -
P / rho) / (2 cs^4 rho^2); it reads the state f, not u.

KBC's reverse recomputes the forward (csrc/kbc.cuh) from the state f:
dh = f - feq - ds, the stabiliser gamma = 1/beta - c S_s / S_h (c = 2 -
1/beta, S_s = sum ds dh / feq, S_h = sum dh^2 / feq, gamma = 2 where
guarded), then with gamma_bar = -beta h.dh (0 where guarded), S_s_bar =
-c gamma_bar / S_h, S_h_bar = -S_s_bar S_s / S_h::

    dh_bar  = -beta gamma h + S_s_bar ds / feq + 2 S_h_bar dh / feq,
    ds_bar  = -2 beta h + S_s_bar dh / feq - dh_bar,
    feq_bar = -dh_bar - (S_s_bar ds + S_h_bar dh) dh / feq^2,
    ct_q    = h_q + dh_bar_q + (A' + e_q.B)(t = feq_bar)
              + (e_q - u).R.(e_q - u) - cs^2 tr R,

with R = sum_q K_q ds_bar_q, where ds_q = K_q : Q is linear in the
non-equilibrium second moment Q = sum e e f - rho u u - rho cs^2 I
(:func:`_kbc_shear_map`). lettuce_tpu differentiates KBC in split mode; its
gradient here is the same function in one kernel.

Split mode (the closed-form MRT bases, forced BGK: no closed-form
Jacobian) runs the ``none`` kernel with the no-streaming re-route but no
boundary routing (the streaming transpose S^T), then
:func:`prestream_vjp`, the VJP of the pointwise pre-streaming map
(P^T, the collision and the boundary codes), as lettuce_tpu's
``build_adjoint_step`` does with ``jax.vjp``.

The kernels are bound by device memory: D3Q19 in float32 reads 19 + 3
fields and writes 19, 164 B per lattice update with the u residual, 228 B
with the f residual, 152 B for ``none`` (plus the 1-byte code when
masked); KBC on D3Q27 324 B.

The blocked adjoint (K4, ``csrc/adjoint_multi.cu``) replaces
``lettuce_tpu/ops/pallas/adjoint.py::_adjoint_multi_kernel``: the exact VJP
of one blocked forward launch (``n_sub`` steps, K2) in one launch, from the
launch input f alone. It marches columns along the grid's slowest moving
axis (``csrc/adjoint_multi.cuh``), replaying the forward in rings of
planes, keeping each level's pre-collision u, and pulls the cotangent
back through the levels with the adjoints above: periodic grids, float32
and float64, the forward fragments of :data:`ADJOINT_MULTI_FRAGMENTS`. It
reads f and g and writes the cotangent once per launch: 228 / n_sub B per
D3Q19 float32 lattice update.

A bfloat16 or float16 state differentiates on the same kernels at 16-bit
storage (``csrc/adjoint_half.cu``, K3 at 16 bits, every spec;
``csrc/adjoint_multi_half.cu``, K4 at 16 bits): the cotangent (and the f
residual of Smagorinsky and KBC) is stored in the state's dtype, the u
residual in float32, every sum runs in float32 and each stored value
rounds once, as lettuce_tpu's adjoint kernel computes in float32
(:167-174). D3Q19 moves 88 B per lattice update with the u residual, 114
B with the f residual. The blocked adjoint keeps its rings in float32
between levels and rounds once per launch, where lettuce_tpu's computes
in the storage dtype (ROADMAP F11). The plain versions widen to float32, compute and round
once. Deviation storage has no gradient.

:func:`stream_collide_adjoint` and :func:`stream_collide_adjoint_multi`
run their plain versions only for a CPU tensor. For a CUDA tensor they
launch a kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import tracing
from ..collision import constant_table, kbc_parts
from ..equilibrium import quadratic_feq
from .build import (DTYPES, HALF_DTYPES, KERNEL_STENCIL_NAMES,
                    check_launch, check_out, compute_dtype,
                    kernel_stencil_name, launch_dims, open_library,
                    storage_suffix)
from .stream_collide import (FRAGMENTS, _velocity, check_nsm,
                             checked_table, fragment_of, march_plan,
                             march_scratch, pack_spec, prestream_plain,
                             stream_collide_plain)

__all__ = ["stream_collide_adjoint", "stream_collide_adjoint_plain",
           "stream_collide_adjoint_multi",
           "stream_collide_adjoint_multi_plain", "adjoint_multi_refusal",
           "adjoint_multi_halo", "prestream_vjp", "load_library",
           "load_fragment_library", "load_multi_library",
           "load_half_library", "load_libraries",
           "ADJOINT_FRAGMENTS", "ADJOINT_MULTI_FRAGMENTS", "NONE_SPEC"]

# the adjoint specs of csrc/adjoint_fragments.cu, each on every stencil
# but kbc, which is on its forward's (FRAGMENTS)
ADJOINT_FRAGMENTS = ("none", "trt", "matvec", "smag", "kbc")
# the adjoint specs of csrc/adjoint_half.cu (K3 at 16 bits), each on every
# stencil in bfloat16 and float16
HALF_ADJOINT_FRAGMENTS = ("bgk", *ADJOINT_FRAGMENTS)
# the forward fragments of the blocked adjoint (csrc/adjoint_multi.cu): the
# f-linear collisions whose adjoint reads the pre-collision u (bgk, trt,
# and through matvec the regularized and the folded MRT) and the identity,
# as lettuce_tpu's build_fused_multi_step takes them (:2360-2371)
ADJOINT_MULTI_FRAGMENTS = ("bgk", "trt", "reg", "mrt_from_feq", "none")
# the identity's spec: split mode's streaming transpose
NONE_SPEC = ("none",)


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


def _equilibrium_transpose(h, t, u, et, wt, cs):
    """h - t + (A' + e.B): the transposed Jacobian of f' = f - M (f -
    feq(f)) for t = M^T h, from the weighted moments of t and the
    pre-collision velocity u (the module docstring's formulas)."""
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
    return h - t + a_prime + torch.tensordot(et, b, dims=1)


def _smagorinsky_transpose(h, f, et, wt, cs, tau0, constant):
    """J^T h for the Smagorinsky collision at the state f: the BGK shape
    with t = s h, s = 1 / tau_eff, plus X (the module docstring), for the
    forward's two-step fixed point tau_{k+1} = tau0 + 3 C^2 R / tau_k^2."""
    inv_cs2 = 1.0 / (cs * cs)
    rho = torch.sum(f, dim=0)
    u = torch.tensordot(et.T, f, dims=1) / rho
    u2 = torch.sum(u * u, dim=0)
    eu = torch.tensordot(et, u, dims=1)                     # [q, ...]
    shape = (-1,) + (1,) * (f.dim() - 1)
    feq = wt.reshape(shape) * rho * (1 + inv_cs2 * eu
                                     + 0.5 * inv_cs2 * inv_cs2 * eu * eu
                                     - 0.5 * inv_cs2 * u2)
    d = f - feq
    D = torch.sum(d * h, dim=0)
    ee = et[:, :, None] * et[:, None, :]                    # [q, d, d]
    pi = torch.tensordot(ee.permute(1, 2, 0), d, dims=1)    # [d, d, ...]
    P = torch.sum(pi * pi, dim=(0, 1))
    tr_pi = torch.diagonal(pi, dim1=0, dim2=1).sum(-1)
    R = P * (0.25 * inv_cs2 * inv_cs2) / (rho * rho)
    a_c = 3.0 * constant * constant
    tau1 = tau0 + a_c * R / (tau0 * tau0)
    dtau1 = a_c / (tau0 * tau0)
    tau2 = tau0 + a_c * R / (tau1 * tau1)
    dtau2 = a_c / (tau1 * tau1) - 2.0 * a_c * R / (tau1 ** 3) * dtau1
    s = 1.0 / tau2
    pi_u = torch.einsum("ab...,b...->a...", pi, u)
    base = -(cs * cs) * tr_pi - P / rho + torch.sum(u * pi_u, dim=0)
    c0 = D * s * s * dtau2 * (0.5 * inv_cs2 * inv_cs2) / (rho * rho)
    e_pi_e = torch.einsum("qab,ab...->q...", ee, pi)
    x = c0 * (base + e_pi_e - 2.0 * torch.tensordot(et, pi_u, dims=1))
    return _equilibrium_transpose(h, s * h, u, et, wt, cs) + x


def _kbc_shear_map(e) -> np.ndarray:
    """``K [q, d, d]``, symmetric in its last two axes: KBC's shear part
    ds_q = K_q : Q of the non-equilibrium second moment Q (csrc/kbc.cuh's
    tracers): -I on the rest direction, e e^T / 2 along an axis, the
    off-diagonal of e e^T / 8 on an edge diagonal, 0 on a corner."""
    e = np.asarray(e, dtype=np.float64)
    K = np.zeros((e.shape[0], e.shape[1], e.shape[1]))
    for q, c in enumerate(e):
        n = int(np.count_nonzero(c))
        if n == 0:
            K[q] = -np.eye(e.shape[1])
        elif n == 1:
            K[q] = 0.5 * np.outer(c, c)
        elif n == 2:
            K[q] = 0.125 * (np.outer(c, c) - np.diag(c * c))
    return K


def _kbc_transpose(h, f, e, et, wt, cs, tau):
    """J^T h for the KBC collision at the state f, with no autograd: the
    forward recomputed by the plain step's own code
    (:func:`.collision.kbc_parts` on the equilibrium
    :func:`.stream_collide.collide_plain` builds), so that its
    ill-conditioned pieces (dh = f - feq - ds, the stabiliser's 1/S_h)
    round as the plain step's do, then the reverse of the module
    docstring, as ``KbcAdjoint`` computes it."""
    rho = torch.sum(f, dim=0, keepdim=True)
    u = _velocity(f, et, rho, e)
    feq = quadratic_feq(et, wt, cs, rho, u)
    beta, ds, dh, sum_s, sum_h, gamma, guarded = kbc_parts(f, feq, e, tau)
    c = 2.0 - 1.0 / beta
    safe = torch.where(guarded, torch.ones_like(sum_h), sum_h)
    r = 1.0 / feq
    ss_bar = (c * beta * torch.sum(h * dh, dim=0, keepdim=True)
              / safe).masked_fill(guarded, 0.0)
    sh_bar = -ss_bar * sum_s / safe
    dh_bar = -beta * gamma * h + ss_bar * ds * r + 2 * sh_bar * dh * r
    ds_bar = -2 * beta * h + ss_bar * dh * r - dh_bar
    feq_bar = -dh_bar - (ss_bar * ds + sh_bar * dh) * dh * r * r
    # ds = K : Q, dQ_ab / df_q = (e_q - u)_a (e_q - u)_b - cs^2 delta_ab
    shear = constant_table(_kbc_shear_map(e), f.dtype, f.device)
    R = torch.tensordot(shear.permute(1, 2, 0), ds_bar, dims=1)  # [d, d, ...]
    v = et.reshape(et.shape + (1,) * (f.dim() - 1)) - u[None]   # [q, d, ...]
    x = (torch.einsum("qa...,ab...,qb...->q...", v, R, v)
         - (cs * cs) * torch.diagonal(R, dim1=0, dim2=1).sum(-1))
    return _equilibrium_transpose(h + dh_bar + feq_bar, feq_bar, u, et, wt,
                                  cs) + x


def stream_collide_adjoint_plain(g: torch.Tensor, res: torch.Tensor,
                                 e: np.ndarray, w: np.ndarray,
                                 opposite: np.ndarray, cs: float,
                                 tau_inv: float, ncm: torch.Tensor = None,
                                 nsm: torch.Tensor = None, table=None,
                                 feq_field: torch.Tensor = None,
                                 collision_spec=None) -> torch.Tensor:
    """The closed-form VJP of one collide-and-stream step in plain
    PyTorch, for the adjoint spec of ``collision_spec`` (BGK with
    ``tau_inv`` when None; a split-mode spec raises): the cotangent pulled
    by ``torch.roll`` along -e (re-routed where ``nsm`` froze
    populations), the transposed collision Jacobian of the module
    docstring at the residual ``res`` (u ``[d, *grid]`` for bgk, trt and
    matvec, the state f for smag and kbc, unused for none), and the
    boundary codes of ``table`` where ``ncm`` holds them. ``feq_field`` is
    unused (an equilibrium replacement is constant in f); it is taken so
    that one parameter set serves the forward and the adjoint.

    A 16-bit ``g`` (and f residual) is widened to float32 and the result
    rounded once to ``g``'s dtype, as the 16-bit kernels compute; the u
    residual is then float32."""
    if g.dtype in HALF_DTYPES:
        return _adjoint_plain(
            g.float(), None if res is None else res.float(), e, w, opposite,
            cs, tau_inv, ncm, nsm, table, collision_spec).to(g.dtype)
    return _adjoint_plain(g, res, e, w, opposite, cs, tau_inv, ncm, nsm,
                          table, collision_spec)


def _adjoint_plain(g, res, e, w, opposite, cs, tau_inv, ncm, nsm, table,
                   collision_spec) -> torch.Tensor:
    """:func:`stream_collide_adjoint_plain` in the dtype of ``g``."""
    adjoint = _adjoint_of(collision_spec, tau_inv, e, w, opposite)
    kind = adjoint[0]
    e = np.asarray(e)
    et = torch.as_tensor(e, dtype=g.dtype, device=g.device)
    wt = torch.as_tensor(np.asarray(w), dtype=g.dtype, device=g.device)
    h = _pull(g, e, nsm)
    if kind == "none":
        ct = h
    elif kind == "smag":
        ct = _smagorinsky_transpose(h, res, et, wt, cs, adjoint[1],
                                    adjoint[2])
    elif kind == "kbc":
        ct = _kbc_transpose(h, res, e, et, wt, cs, adjoint[1])
    else:
        if kind == "bgk":
            t = adjoint[1] * h
        elif kind == "trt":
            cp, cm = 0.5 / adjoint[1], 0.5 / adjoint[2]
            opp = torch.as_tensor(np.asarray(opposite), device=g.device)
            t = (cp + cm) * h + (cp - cm) * h[opp]
        else:  # matvec: t = C^T h
            ct_matrix = torch.as_tensor(np.asarray(adjoint[1]),
                                        dtype=g.dtype, device=g.device)
            t = torch.tensordot(ct_matrix, h, dims=1)
        ct = _equilibrium_transpose(h, t, res, et, wt, cs)
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


def _packed(collision_spec, tau_inv, e, w, opposite):
    return pack_spec(("bgk", tau_inv) if collision_spec is None
                     else collision_spec, e, w, opposite)


def _adjoint_of(collision_spec, tau_inv, e, w, opposite) -> tuple:
    """The adjoint spec of a forward spec; raises for a split-mode one."""
    spec = _packed(collision_spec, tau_inv, e, w, opposite)
    if spec.mode == "split":
        raise ValueError(f"the {spec.fragment!r} collision has no "
                         f"closed-form adjoint: its gradient runs split "
                         f"mode (the 'none' adjoint, then prestream_vjp)")
    return spec.adjoint


def adjoint_multi_halo(n_sub: int) -> int:
    """The blocked adjoint's halo: the cotangent's cone (n_sub) and the
    forward replay's cone for the deepest level's u (2 (n_sub - 1)),
    lettuce_tpu's plan_adjoint_multi (:954-981)."""
    return max(int(n_sub), 2 * (int(n_sub) - 1))


def adjoint_multi_refusal(spec, dtype: torch.dtype):
    """Why the blocked adjoint (K4) cannot take the gradient of the packed
    ``spec`` on a ``dtype`` state, or None when it can."""
    if spec.fragment not in ADJOINT_MULTI_FRAGMENTS:
        return (f"the {spec.fragment!r} collision has no blocked adjoint "
                f"(it takes {', '.join(ADJOINT_MULTI_FRAGMENTS)}: the "
                f"Jacobians of Smagorinsky and KBC read every sub-step's "
                f"state, the others run split mode)")
    if dtype not in DTYPES and dtype not in HALF_DTYPES:
        return (f"the blocked adjoint runs float32, float64, bfloat16 and "
                f"float16 states, not {dtype}")
    return None


def _multi_spec(collision_spec, tau_inv, e, w, opposite, dtype):
    spec = _packed(collision_spec, tau_inv, e, w, opposite)
    reason = adjoint_multi_refusal(spec, dtype)
    if reason is not None:
        raise NotImplementedError(reason)
    return spec


def stream_collide_adjoint_multi_plain(f: torch.Tensor, g: torch.Tensor,
                                       n_sub: int, e: np.ndarray,
                                       w: np.ndarray, opposite: np.ndarray,
                                       cs: float, tau_inv: float,
                                       collision_spec=None) -> torch.Tensor:
    """The VJP of ``n_sub`` collide-and-stream steps from ``f`` in plain
    PyTorch, the blocked adjoint's plain version: the forward replayed
    with plain emit-u steps, then ``n_sub`` plain adjoint steps
    (:func:`stream_collide_adjoint_plain`) in reverse on the cotangent
    ``g`` of the last step's output. A 16-bit ``f`` and ``g`` are widened
    once, replayed and pulled back in float32, and the result rounded
    once, as the blocked kernels keep their rings in float32."""
    spec = _multi_spec(collision_spec, tau_inv, e, w, opposite, f.dtype)
    if g.dtype in HALF_DTYPES:
        return stream_collide_adjoint_multi_plain(
            f.float(), g.float(), n_sub, e, w, opposite, cs, tau_inv,
            collision_spec=spec).to(g.dtype)
    us, x = [], f
    for _ in range(int(n_sub)):
        if spec.residual == "u":
            x, u = stream_collide_plain(x, e, w, opposite, cs, tau_inv,
                                        emit_u=True, collision_spec=spec)
        else:  # the identity reads no residual
            x, u = stream_collide_plain(x, e, w, opposite, cs, tau_inv,
                                        collision_spec=spec), None
        us.append(u)
    for u in reversed(us):
        g = stream_collide_adjoint_plain(g, u, e, w, opposite, cs, tau_inv,
                                         collision_spec=spec)
    return g


def prestream_vjp(f: torch.Tensor, h: torch.Tensor, *, e, w, opposite,
                  cs: float, collision_spec, ncm=None, table=None,
                  feq_field=None) -> torch.Tensor:
    """Split mode's P^T: the VJP of the pointwise pre-streaming map
    (:func:`.stream_collide.prestream_plain`: the collision of
    ``collision_spec`` and the boundary codes) at the state ``f``, applied
    to the streaming-transposed cotangent ``h``. The map is recomputed
    here, under autograd, and its graph is freed on return, so a rollout
    never holds more than one step's graph. A 16-bit state runs the map's
    VJP on float32 copies (``f``, ``h`` and the field), as the 16-bit
    kernels compute, and rounds the result once to its dtype. Each call
    is one ``vjp`` span and counts once under ``vjp:<fragment>``."""
    with tracing.span("vjp"):
        tracing.count(f"vjp:{fragment_of(collision_spec)}")
        dtype = f.dtype
        if dtype in HALF_DTYPES:
            f, h = f.float(), h.float()
            feq_field = None if feq_field is None else feq_field.float()
        with torch.enable_grad():
            x = f.detach().requires_grad_(True)
            fpost = prestream_plain(x, collision_spec, e, w, opposite, cs,
                                    ncm, table, feq_field)
            (ct,) = torch.autograd.grad(fpost, x, h)
        return ct.to(dtype)


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the BGK adjoint library, with
    ``argtypes`` set on every entry."""
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


def _adjoint_stencils(fragment: str) -> tuple:
    """The stencil instances of an adjoint spec's entries: its forward's
    for kbc, every stencil for the others."""
    return FRAGMENTS[fragment][1] if fragment == "kbc" \
        else KERNEL_STENCIL_NAMES


@functools.cache
def load_fragment_library() -> ctypes.CDLL:
    """Build (if needed) and load the library of the other adjoint specs
    (``csrc/adjoint_fragments.cu``), with ``argtypes`` set on every
    entry."""
    lib = open_library("adjoint_fragments")
    pointer = ctypes.c_void_p
    tail = ([ctypes.c_int64] * 3
            + [pointer, ctypes.c_double, ctypes.c_int, pointer])
    for fragment in ADJOINT_FRAGMENTS:
        for name in _adjoint_stencils(fragment):
            for suffix, _ in DTYPES.values():
                fn = getattr(lib, f"lt_adjoint_{fragment}_{name}_{suffix}")
                fn.argtypes = [pointer] * 3 + tail
                fn.restype = ctypes.c_int
                # masks: ncm (or null), nsm (or null), host kinds (or null)
                fn = getattr(lib, f"lt_adjoint_{fragment}_masked_{name}_"
                                  f"{suffix}")
                fn.argtypes = [pointer] * 6 + tail
                fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_half_library() -> ctypes.CDLL:
    """Build (if needed) and load the adjoints at 16-bit storage
    (``csrc/adjoint_half.cu``: every spec of :data:`HALF_ADJOINT_FRAGMENTS`
    in bfloat16 and float16, the arguments of
    :func:`load_fragment_library`'s entries), with ``argtypes`` set on
    every entry."""
    lib = open_library("adjoint_half")
    pointer = ctypes.c_void_p
    tail = ([ctypes.c_int64] * 3
            + [pointer, ctypes.c_double, ctypes.c_int, pointer])
    for fragment in HALF_ADJOINT_FRAGMENTS:
        for name in _adjoint_stencils(fragment):
            for dtype in HALF_DTYPES:
                suffix = storage_suffix(dtype)
                for variant, n_pointers in (("", 3), ("masked_", 6)):
                    fn = getattr(lib, f"lt_adjoint_{fragment}_{variant}"
                                      f"{name}_{suffix}")
                    fn.argtypes = [pointer] * n_pointers + tail
                    fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_multi_library(half: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the blocked adjoint library
    (``csrc/adjoint_multi.cu``, float32 and float64; with ``half``
    ``csrc/adjoint_multi_half.cu``, bfloat16 and float16), with
    ``argtypes`` set on every entry: f, g, out, scratch, the grid, n_sub,
    the halo, the march's interior (the segment's planes on the march
    axis), the blocks and their threads, the forward's and the adjoint's
    float64 parameters, cs, device, stream."""
    lib = open_library("adjoint_multi_half" if half else "adjoint_multi")
    pointer = ctypes.c_void_p
    argtypes = ([pointer] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 7
                + [pointer, pointer, ctypes.c_double, ctypes.c_int, pointer])
    suffixes = ([storage_suffix(dtype) for dtype in HALF_DTYPES] if half
                else [suffix for suffix, _ in DTYPES.values()])
    for fragment in ADJOINT_MULTI_FRAGMENTS:
        names = (KERNEL_STENCIL_NAMES if fragment == "bgk"
                 else FRAGMENTS[fragment][1])
        for name in names:
            for suffix in suffixes:
                fn = getattr(lib, f"lt_adjoint_multi_{fragment}_{name}_"
                                  f"{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


def load_libraries() -> None:
    """Build (if needed) and load the adjoint libraries, the blocked and
    the 16-bit ones included."""
    load_library()
    load_fragment_library()
    load_half_library()
    load_multi_library()
    load_multi_library(half=True)


def _check_residual(res, g, shape, what, dtype=None):
    """Raise unless ``res`` is a contiguous tensor of ``shape`` on g's
    device in ``dtype`` (g's when None)."""
    dtype = g.dtype if dtype is None else dtype
    if (res is None or res.device != g.device or res.dtype != dtype
            or tuple(res.shape) != tuple(shape) or not res.is_contiguous()):
        raise ValueError(f"the {what} residual must be a contiguous tensor "
                         f"of shape {tuple(shape)} on g's device in "
                         f"{dtype}")


def stream_collide_adjoint(g: torch.Tensor, res: torch.Tensor,
                           e: np.ndarray, w: np.ndarray,
                           opposite: np.ndarray, cs: float, tau_inv: float,
                           ncm: torch.Tensor = None,
                           nsm: torch.Tensor = None, table=None,
                           feq_field: torch.Tensor = None,
                           out: torch.Tensor = None,
                           collision_spec=None) -> torch.Tensor:
    """The cotangent of one step's input from the cotangent ``g``
    (``[q, *grid]``) of its output and the forward's residual ``res``: the
    pre-collision velocity u (``[d, *grid]``) for BGK, TRT and the
    ``matvec`` specs, in float32 for a 16-bit ``g``), the step's input f
    for Smagorinsky and KBC (in g's dtype), None for the identity.
    ``collision_spec`` is the forward's (BGK with ``tau_inv``
    when None); its adjoint spec selects the kernel, and a split-mode spec
    raises ValueError (split mode is ``fused_step``'s: this function with
    :data:`NONE_SPEC`, then :func:`prestream_vjp`). With ``ncm`` and
    ``table`` (and ``nsm``) the masked kernel routes the cotangent as the
    forward's masked kernel ran; with ``nsm`` alone the masked kernel
    re-routes frozen populations and routes no code. ``feq_field`` is
    checked as the forward checks it, and never read.

    On a CPU tensor this is :func:`stream_collide_adjoint_plain`; on a
    CUDA tensor it launches a kernel (allocating ``out`` when none is
    given) or raises. ``out`` must not be ``g``: the kernel pulls from
    neighbours. A bfloat16 or float16 ``g`` runs the 16-bit instances
    (K3 at 16 bits). Each launch counts under
    ``tracing.launch_key("K3", ...)``.
    """
    spec = _packed(collision_spec, tau_inv, e, w, opposite)
    masks = dict(ncm=ncm, nsm=nsm, table=table, feq_field=feq_field)
    if g.device.type == "cpu":
        result = stream_collide_adjoint_plain(g, res, e, w, opposite, cs,
                                              tau_inv, collision_spec=spec,
                                              **masks)
        return result if out is None else out.copy_(result)
    if g.device.type != "cuda":
        raise ValueError(f"stream_collide_adjoint runs on cpu or cuda "
                         f"tensors, got {g.device}")
    with tracing.span("launch"):
        fragment = _adjoint_of(spec, None, e, w, opposite)[0]
        name = kernel_stencil_name(e, w, opposite)
        n0, n1, n2 = launch_dims(g, e)
        half = g.dtype in HALF_DTYPES
        if spec.residual == "u":
            d = np.asarray(e).shape[1]
            _check_residual(res, g, (d, *g.shape[1:]), "u",
                            compute_dtype(g.dtype))
        elif spec.residual == "f":
            _check_residual(res, g, g.shape, "state")
        else:
            res = None
        out = check_out(out, g, g.shape, "out", g,
                        *([] if res is None else [res]))
        pointers = [g.data_ptr(), None if res is None else res.data_ptr(),
                    out.data_ptr()]
        if ncm is not None:
            # alive until the call returns; the field is checked, never read
            table = checked_table(g, ncm, nsm, table, feq_field)
            pointers += [ncm.data_ptr(),
                         None if nsm is None else nsm.data_ptr(),
                         table.kinds.ctypes.data]
            variant = "masked_"
        elif nsm is not None:
            # frozen populations only: the masked kernel with no code table
            check_nsm(g, nsm)
            pointers += [None, nsm.data_ptr(), None]
            variant = "frozen_"
        else:
            variant = ""
        suffix = storage_suffix(g.dtype)
        entry = "masked_" if variant else ""
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if fragment == "bgk" and not half:
            lib = load_library()
            launch = getattr(lib, f"lt_stream_collide_adjoint_{entry}{name}_"
                                  f"{suffix}")
            params = float(spec[1])
        else:
            lib = load_half_library() if half else load_fragment_library()
            launch = getattr(lib, f"lt_adjoint_{fragment}_{entry}{name}_"
                                  f"{suffix}")
            params = spec.adjoint_params.ctypes.data
        with tracing.span("enqueue"):
            rc = launch(*pointers, n0, n1, n2, params, float(cs),
                        g.device.index, stream)
        check_launch(lib, rc, f"stream_collide_adjoint ({fragment}, "
                              f"{variant or 'periodic_'}{name}_{suffix})")
        tracing.count(tracing.launch_key("K3", variant, fragment, suffix))
        return out


def stream_collide_adjoint_multi(f: torch.Tensor, g: torch.Tensor,
                                 n_sub: int, e: np.ndarray, w: np.ndarray,
                                 opposite: np.ndarray, cs: float,
                                 tau_inv: float, collision_spec=None,
                                 out: torch.Tensor = None,
                                 **masks) -> torch.Tensor:
    """The cotangent of a blocked launch's input ``f`` (``n_sub`` steps of
    ``collision_spec``, BGK with ``tau_inv`` when None) from the cotangent
    ``g`` of its output: one launch of the blocked adjoint (K4) on a CUDA
    tensor (allocating ``out`` when none is given), else
    :func:`stream_collide_adjoint_multi_plain`. Periodic only: ``masks``
    (the gate's ``ncm``, ``nsm``, ``table``, ``feq_field``) must be None.
    A bfloat16 or float16 state runs K4 at 16 bits (float32 rings,
    rounded once). Raises NotImplementedError for a spec or dtype it does
    not take (:func:`adjoint_multi_refusal`)."""
    if any(m is not None for m in masks.values()):
        raise ValueError("the blocked adjoint runs periodic grids: no masks")
    spec = _multi_spec(collision_spec, tau_inv, e, w, opposite, g.dtype)
    if g.device.type == "cpu":
        result = stream_collide_adjoint_multi_plain(
            f, g, n_sub, e, w, opposite, cs, tau_inv, collision_spec=spec)
        return result if out is None else out.copy_(result)
    if g.device.type != "cuda":
        raise ValueError(f"stream_collide_adjoint_multi runs on cpu or cuda "
                         f"tensors, got {g.device}")
    launch_dims(g, e)
    _check_residual(f, g, g.shape, "state")
    out = check_out(out, g, g.shape, "out", g, f)
    return _launch_adjoint_multi(f, g, out, spec, n_sub, e, cs)


def _launch_adjoint_multi(f: torch.Tensor, g: torch.Tensor,
                          out: torch.Tensor, spec, n_sub: int, e, cs: float,
                          plan=None) -> torch.Tensor:
    """One launch of the blocked adjoint (K4) of the packed ``spec`` on
    the CUDA tensors ``f`` and ``g`` into ``out``, over the columns of
    ``plan`` (:func:`.stream_collide.march_plan`'s when None; another
    candidate of :func:`.build.march_candidates` when given)."""
    with tracing.span("launch"):
        dims = launch_dims(g, e)
        halo = adjoint_multi_halo(n_sub)
        if plan is None:
            plan = march_plan(g, e, n_sub, adjoint=True, halo=halo)
        scratch = march_scratch(plan, g.device)
        suffix = storage_suffix(g.dtype)
        lib = load_multi_library(half=g.dtype in HALF_DTYPES)
        launch = getattr(lib, f"lt_adjoint_multi_{spec.fragment}_"
                              f"{spec.stencil}_{suffix}")
        with tracing.span("enqueue"):
            rc = launch(f.data_ptr(), g.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        *dims, int(n_sub), halo, *plan.interior, plan.blocks,
                        plan.threads, spec.params.ctypes.data,
                        spec.adjoint_params.ctypes.data, float(cs),
                        g.device.index,
                        torch.cuda.current_stream(g.device).cuda_stream)
        check_launch(lib, rc, f"stream_collide_adjoint_multi "
                              f"({spec.fragment}, x{n_sub} {spec.stencil}_"
                              f"{suffix})")
        tracing.count(tracing.launch_key("K4", "", spec.fragment, suffix,
                                         n_sub))
        return out
