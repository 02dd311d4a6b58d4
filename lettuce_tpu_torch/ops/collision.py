"""Collision operators: BGK (with an optional force), the identity, TRT,
MRT, regularized, KBC and Smagorinsky.

Each operator is a ``flow -> f_post`` map on the flow's current state.
The formulas are module functions of tensors (``bgk_relax``,
``trt_relax``, ``regularize``, ``smagorinsky_relax``, ``mrt_relax``,
``kbc_relax``), shared by the operators and by the plain step of the CUDA
kernel's collision fragments (``ops/cuda/stream_collide.py``). Every
operator here has a fragment in that kernel; ``native_available`` says
whether an instance can run there.
"""

from __future__ import annotations

import functools
import warnings
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from ..stencil import D2Q9, D3Q27

__all__ = ["Collision", "BGKCollision", "NoCollision", "TRTCollision",
           "MRTCollision", "RegularizedCollision", "KBCCollision",
           "KBCCollision2D", "KBCCollision3D", "SmagorinskyCollision",
           "bgk_relax", "trt_relax", "shear_tensor", "regularize",
           "smagorinsky_relax", "mrt_relax", "kbc_relax"]


class Collision(ABC):
    """Collision protocol."""

    @abstractmethod
    def __call__(self, flow: "Flow") -> torch.Tensor:
        ...

    def native_available(self) -> bool:
        """True if this op can run inside the CUDA kernel."""
        return False

    def name(self) -> str:
        return self.__class__.__name__


# ----------------------------------------------------------------------
# the formulas
# ----------------------------------------------------------------------
def bgk_relax(f, feq, tau_inv):
    """f - 1/tau (f - feq)."""
    return f - tau_inv * (f - feq)


def trt_relax(f, feq, opposite, tau_plus, tau_minus):
    """Two-relaxation-time collision: the parts of f - feq symmetric and
    antisymmetric under e -> -e relax with tau_plus and tau_minus."""
    opp = torch.as_tensor(np.asarray(opposite), device=f.device)
    f_opp = f[opp]
    feq_opp = feq[opp]
    f_diff_neq = ((f + f_opp) - (feq + feq_opp)) / (2.0 * tau_plus)
    f_diff_neq = f_diff_neq + ((f - f_opp) - (feq - feq_opp)) / (
        2.0 * tau_minus)
    return f - f_diff_neq


def shear_tensor(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Pi_ab = sum_q f_q e_qa e_qb, shape ``[d, d, *grid]``; ``e`` is
    ``[q, d]``."""
    ee = e[:, :, None] * e[:, None, :]  # [q, d, d]
    return torch.tensordot(ee.permute(2, 1, 0), f, dims=([2], [0]))


def regularize(f, feq, e: torch.Tensor, w: torch.Tensor, cs: float, tau):
    """Regularized collision (Latt & Chopard 2006): f_neq projected on
    the Q tensor, only the first-order part kept and relaxed."""
    d = e.shape[1]
    Q = (e[:, :, None] * e[:, None, :]
         - torch.eye(d, dtype=e.dtype, device=e.device) * cs ** 2)
    pi_neq = shear_tensor(e, f - feq)                       # [d, d, *grid]
    pi_neq = torch.einsum("qab,ab...->q...", Q, pi_neq)     # [q, *grid]
    w = w.reshape((-1,) + (1,) * d)
    fi1 = w * pi_neq / (2 * cs ** 4)
    return feq + (1.0 - 1.0 / tau) * fi1


def smagorinsky_relax(f, feq, rho, e: torch.Tensor, cs: float, tau,
                      constant, iterations: int = 2):
    """BGK with the Smagorinsky effective relaxation time, by a fixed-point
    iteration on the local shear tensor."""
    S_shear = shear_tensor(e, f - feq) / (2.0 * rho * cs ** 2)
    tau_eff = tau
    nu = (tau - 0.5) / 3.0
    for _ in range(iterations):
        S = S_shear / tau_eff
        S = torch.sum(S * S, dim=(0, 1))
        nu_t = constant ** 2 * S
        tau_eff = (nu + nu_t) * 3.0 + 0.5
    return f - 1.0 / tau_eff * (f - feq)


def mrt_relax(m, meq, relaxation_parameters: torch.Tensor):
    """m - diag(1/tau) (m - meq), the rates cast to the state's dtype."""
    s_inv = (1 / relaxation_parameters).to(dtype=m.dtype, device=m.device)
    return m - s_inv.reshape((-1,) + (1,) * (m.ndim - 1)) * (m - meq)


@functools.lru_cache(maxsize=64)
def _constant_table(shape: tuple, values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64).reshape(shape).to(
        dtype=dtype, device=device)


def constant_table(array, dtype: torch.dtype, device) -> torch.Tensor:
    """``array`` (a stencil's velocities or weights, a moment matrix) as a
    ``dtype`` tensor on ``device``, made once and then shared: a copy from
    the host's pageable memory waits for the device's stream, so making it
    at every call would stall the device once per table in every step of
    split mode's VJP. Callers never write into it."""
    a = np.asarray(array, dtype=np.float64)
    return _constant_table(a.shape, tuple(a.ravel().tolist()), dtype,
                           torch.device(device))


def kbc_moment_matrix(e) -> np.ndarray:
    """Raw moments e_x^i e_y^j (e_z^k), i, j, k in 0..2: ``[3, 3, q]`` in
    2D, ``[3, 3, 3, q]`` in 3D."""
    e = np.asarray(e, dtype=np.float64)
    powers = [e[:, a, None] ** np.arange(3) for a in range(e.shape[1])]
    if e.shape[1] == 3:
        return np.einsum("qi,qj,qk->ijkq", *powers)
    return np.einsum("qi,qj->ijq", *powers)


def _kbc_moments(M: torch.Tensor, d: int, f: torch.Tensor):
    """(raw moments over rho, rho)."""
    m = torch.einsum("abcq,q...->abc..." if d == 3 else "abq,q...->ab...",
                     M, f)
    rho = m[(0,) * d]
    return m / rho, rho


def _kbc_s_seq_3d(m, rho):
    T = m[2, 0, 0] + m[0, 2, 0] + m[0, 0, 2]
    N_xz = m[2, 0, 0] - m[0, 0, 2]
    N_yz = m[0, 2, 0] - m[0, 0, 2]
    Pi_xy = m[1, 1, 0]
    Pi_xz = m[1, 0, 1]
    Pi_yz = m[0, 1, 1]

    s0 = rho * -T
    s1 = 1. / 6. * rho * (2 * N_xz - N_yz + T)
    s3 = 1. / 6. * rho * (2 * N_yz - N_xz + T)
    s5 = 1. / 6. * rho * (-N_xz - N_yz + T)
    s7 = 1. / 4. * rho * Pi_yz
    s11 = 1. / 4. * rho * Pi_xz
    s15 = 1. / 4. * rho * Pi_xy
    zero = torch.zeros_like(s0)
    return torch.stack([s0, s1, s1, s3, s3, s5, s5,
                        s7, s7, -s7, -s7, s11, s11, -s11, -s11,
                        s15, s15, -s15, -s15] + [zero] * 8)


def _kbc_s_seq_2d(m, rho):
    T = m[2, 0] + m[0, 2]
    N = m[2, 0] - m[0, 2]
    Pi_xy = m[1, 1]

    s0 = rho * -T
    s1 = 1. / 2. * rho * (0.5 * (T + N))
    s2 = 1. / 2. * rho * (0.5 * (T - N))
    s5 = 1. / 4. * rho * Pi_xy
    return torch.stack([s0, s1, s2, s1, s2, s5, -s5, s5, -s5])


def kbc_relax(f, feq, e, tau):
    """Entropic KBC collision (Karlin, Boesch, Chikatamarla) on D2Q9 or
    D3Q27: the shear part relaxes with beta = 1/(2 tau), the higher-order
    part with the stabiliser gamma from the entropy condition. A cell
    whose higher-order part vanishes (0/0) and a gamma below 1e-15 get
    gamma = 2."""
    d = np.asarray(e).shape[1]
    M = constant_table(kbc_moment_matrix(e), f.dtype, f.device)
    beta = 1.0 / (2 * tau)
    s_seq = _kbc_s_seq_3d if d == 3 else _kbc_s_seq_2d
    delta_s = s_seq(*_kbc_moments(M, d, f))
    delta_s = delta_s - s_seq(*_kbc_moments(M, d, feq))

    delta_h = f - feq - delta_s
    sum_s = torch.sum(delta_s * delta_h / feq, dim=0, keepdim=True)
    sum_h = torch.sum(delta_h * delta_h / feq, dim=0, keepdim=True)
    degenerate = sum_h == 0
    ratio = sum_s / torch.where(degenerate, torch.ones_like(sum_h), sum_h)
    gamma_stab = 1.0 / beta - (2 - 1.0 / beta) * ratio
    two = torch.full_like(gamma_stab, 2.0)
    gamma_stab = torch.where(degenerate, two, gamma_stab)
    gamma_stab = torch.where(gamma_stab < 1e-15, two, gamma_stab)
    return f - beta * (2 * delta_s + gamma_stab * delta_h)


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------
class BGKCollision(Collision):
    """Single-relaxation-time BGK, with an optional forcing scheme."""

    def __init__(self, tau, force: Optional["Force"] = None):
        self.tau = tau
        self.force = force

    def __call__(self, flow: "Flow") -> torch.Tensor:
        u = flow.u()
        if self.force is not None:
            u = u + self.force.u_eq(flow)
        feq = flow.equilibrium(flow, u=u)
        out = bgk_relax(flow.f, feq, 1.0 / self.tau)
        if self.force is not None:
            out = out + self.force.source_term(u)
        return out

    def name(self) -> str:
        if self.force is not None:
            return f"{self.__class__.__name__}_{self.force.__class__.__name__}"
        return self.__class__.__name__

    def native_available(self) -> bool:
        return self.force is None or self.force.native_available()


class NoCollision(Collision):
    """Identity collision, used for streaming-only tests."""

    def __call__(self, flow: "Flow") -> torch.Tensor:
        return flow.f

    def native_available(self) -> bool:
        return True


class TRTCollision(Collision):
    """Two-relaxation-time collision (Krueger 2017). Even/odd parts split
    via ``opposite``."""

    def __init__(self, tau, tau_minus=1.0):
        self.tau_plus = tau
        self.tau_minus = tau_minus

    def __call__(self, flow: "Flow") -> torch.Tensor:
        return trt_relax(flow.f, flow.equilibrium(flow),
                         flow.stencil.opposite, self.tau_plus,
                         self.tau_minus)

    def native_available(self) -> bool:
        return True


class MRTCollision(Collision):
    """Multi-relaxation-time collision in the moment space of a
    ``Transform``."""

    def __init__(self, transform: "Transform", relaxation_parameters,
                 context: "Context" = None):
        self.transform = transform
        if context is not None:
            self.relaxation_parameters = context.convert_to_tensor(
                relaxation_parameters)
        else:
            self.relaxation_parameters = torch.as_tensor(
                relaxation_parameters)

    def __call__(self, flow: "Flow") -> torch.Tensor:
        m = self.transform.transform(flow.f)
        meq = self.transform.equilibrium(m, flow)
        m = mrt_relax(m, meq, self.relaxation_parameters)
        return self.transform.inverse_transform(m)

    def native_available(self) -> bool:
        # the kernel fragment covers the transforms with closed-form
        # equilibrium moments (d'Humieres as the exact image of feq)
        from ..utils.moments import (D2Q9Dellar, D2Q9Lallemand,
                                     D3Q27Hermite, D3Q19DHumieres)
        return isinstance(self.transform,
                          (D2Q9Lallemand, D2Q9Dellar, D3Q27Hermite,
                           D3Q19DHumieres))


class RegularizedCollision(Collision):
    """Regularized LBM (Latt & Chopard 2006): project f_neq onto the Q
    tensor and relax only the first-order part. ``tau`` None reads the
    units' relaxation parameter."""

    def __init__(self, tau: float = None):
        self.tau = tau

    def __call__(self, flow: "Flow") -> torch.Tensor:
        tau = (self.tau if self.tau is not None
               else flow.units.relaxation_parameter_lu)
        st = flow.torch_stencil
        return regularize(flow.f, flow.equilibrium(flow), st.e, st.w, st.cs,
                          tau)

    def native_available(self) -> bool:
        return True


class KBCCollision(Collision):
    """Entropic multi-relaxation (Karlin-Boesch-Chikatamarla) collision,
    D2Q9 and D3Q27 only. ``tau`` None reads the units' relaxation
    parameter."""

    def __init__(self, tau: float = None):
        self.tau = tau

    def __call__(self, flow: "Flow") -> torch.Tensor:
        if not isinstance(flow.stencil, (D2Q9, D3Q27)):
            raise ValueError(f"KBC Collision is only implemented for D2Q9 "
                             f"and D3Q27, not "
                             f"{type(flow.stencil).__name__}")
        tau = (self.tau if self.tau is not None
               else flow.units.relaxation_parameter_lu)
        return kbc_relax(flow.f, flow.equilibrium(flow), flow.stencil.e, tau)

    def native_available(self) -> bool:
        # the kernel fragment covers D2Q9 and D3Q27 (the gate checks)
        return True


class KBCCollision2D(KBCCollision):
    def __init__(self, tau: float = None):
        warnings.warn("KBCCollision2D is deprecated! Use KBCCollision "
                      "instead!")
        super().__init__(tau)


class KBCCollision3D(KBCCollision):
    def __init__(self, tau: float = None):
        warnings.warn("KBCCollision3D is deprecated! Use KBCCollision "
                      "instead!")
        super().__init__(tau)


class SmagorinskyCollision(Collision):
    """Smagorinsky LES with the BGK operator: the effective tau from the
    local shear tensor by a 2-step fixed point."""

    def __init__(self, tau, smagorinsky_constant=0.17,
                 force: "Force" = None):
        self.force = force
        self.tau = tau
        self.iterations = 2
        self.constant = smagorinsky_constant

    def __call__(self, flow: "Flow") -> torch.Tensor:
        rho = flow.rho()
        u = flow.u()
        if self.force is not None:
            u = u + self.force.u_eq(flow)
        feq = flow.equilibrium(flow, rho, u)
        out = smagorinsky_relax(flow.f, feq, rho, flow.torch_stencil.e,
                                flow.torch_stencil.cs, self.tau,
                                self.constant, self.iterations)
        if self.force is not None:
            out = out + self.force.source_term(u)
        return out

    def native_available(self) -> bool:
        return self.force is None
