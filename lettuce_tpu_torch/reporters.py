"""Observables and reporters.

Observables are device computations on the flow's state; only the
reporter boundary moves data to the host (one scalar or vector per
interval). :func:`mean_analytic_error` keeps its per-step errors in a device
tensor and reads them on the host once, at the end.
"""

from __future__ import annotations

import sys
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from .simulation import Reporter
from .utils.utility import torch_gradient

__all__ = ["Observable", "MaximumVelocity", "IncompressibleKineticEnergy",
           "Enstrophy", "EnergySpectrum", "Mass", "ObservableReporter",
           "ErrorReporter", "mean_analytic_error"]


class Observable(ABC):
    def __init__(self, flow: "Flow"):
        self.context = flow.context
        self.flow = flow

    @abstractmethod
    def __call__(self, f: Optional[torch.Tensor] = None):
        ...


class MaximumVelocity(Observable):
    """Maximum velocity magnitude in physical units."""

    def __call__(self, f: Optional[torch.Tensor] = None):
        flow = self.flow if f is None else self.flow.view(f)
        return torch.max(torch.linalg.vector_norm(flow.u_pu, dim=0))


class IncompressibleKineticEnergy(Observable):
    """Total kinetic energy of an incompressible flow (physical units)."""

    def __call__(self, f: Optional[torch.Tensor] = None):
        flow = self.flow if f is None else self.flow.view(f)
        dx = flow.units.convert_length_to_pu(1.0)
        kin_e = flow.units.convert_incompressible_energy_to_pu(
            torch.sum(flow.incompressible_energy()))
        return kin_e * dx ** flow.stencil.d


class Enstrophy(Observable):
    """Integral of squared vorticity (6th-order FD; periodic domains
    only)."""

    def __call__(self, f: Optional[torch.Tensor] = None):
        flow = self.flow if f is None else self.flow.view(f)
        u = flow.units.convert_velocity_to_pu(flow.u())
        dx = flow.units.convert_length_to_pu(1.0)
        grad_u0 = torch_gradient(u[0], dx=dx, order=6)
        grad_u1 = torch_gradient(u[1], dx=dx, order=6)
        vorticity = torch.sum((grad_u0[1] - grad_u1[0]) ** 2)
        if flow.stencil.d == 3:
            grad_u2 = torch_gradient(u[2], dx=dx, order=6)
            vorticity = vorticity + torch.sum(
                (grad_u2[1] - grad_u1[2]) ** 2
                + (grad_u0[2] - grad_u2[0]) ** 2)
        return vorticity * dx ** flow.stencil.d


class EnergySpectrum(Observable):
    """Shell-binned kinetic energy spectrum via FFT."""

    def __init__(self, flow: "Flow"):
        super().__init__(flow)
        self.dx = flow.units.convert_length_to_pu(1.0)
        self.dimensions = flow.resolution
        frequencies = [np.fft.fftfreq(dim, d=1 / dim)
                       for dim in self.dimensions]
        wavenumbers = np.stack(np.meshgrid(*frequencies, indexing="ij"))
        wavenorms = np.linalg.norm(wavenumbers, axis=0)

        if flow.stencil.d == 3:
            self.norm = self.dimensions[0] * np.sqrt(2 * np.pi) / self.dx ** 2
        else:
            self.norm = self.dimensions[0] / self.dx

        self.wavenumbers = np.arange(int(np.max(wavenorms)))
        self.wavemask = torch.as_tensor(
            (wavenorms[..., None] > self.wavenumbers - 0.5)
            & (wavenorms[..., None] <= self.wavenumbers + 0.5),
            device=flow.context.device)

    def __call__(self, f: Optional[torch.Tensor] = None):
        flow = self.flow if f is None else self.flow.view(f)
        return self.spectrum_from_u(flow.u())

    def spectrum_from_u(self, u):
        # torch's FFT takes no 16-bit input: a 16-bit state's spectrum is
        # float32, as jnp.fft's
        u = u.to(torch.promote_types(u.dtype, torch.float32))
        u = self.flow.units.convert_velocity_to_pu(u)
        d = self.flow.stencil.d
        uh = torch.stack([torch.fft.fftn(u[i], dim=tuple(range(d)))
                          for i in range(d)]) / self.norm
        ekin = torch.sum(0.5 * (uh.imag ** 2 + uh.real ** 2), dim=0)
        ek = ekin[..., None] * self.wavemask.to(ekin.dtype)
        return ek.sum(dim=tuple(range(d)))


class Mass(Observable):
    """Total mass in lattice units, optionally excluding masked nodes."""

    def __init__(self, flow: "Flow", no_mass_mask=None):
        super().__init__(flow)
        # a numpy or torch mask, on the flow's device
        self.mask = (None if no_mass_mask is None
                     else flow.context.convert_to_tensor(no_mass_mask))

    def __call__(self, f: Optional[torch.Tensor] = None):
        f = self.flow.f if f is None else f
        # trims one cell from the LAST TWO axes only, regardless of
        # dimension, as lettuce_tpu's Mass does
        mass = f[..., 1:-1, 1:-1].sum()
        if self.mask is not None:
            mass -= (f * self.mask.to(f.dtype)).sum()
        return mass


class ObservableReporter(Reporter):
    """Prints/accumulates ``[step, t_pu, observable...]`` every ``interval``
    steps."""

    def __init__(self, observable: "Observable", interval=1, out=sys.stdout):
        super().__init__(interval)
        self.observable = observable
        self.out = [] if out is None else out
        self._parameter_name = observable.__class__.__name__
        print('steps    ', 'time    ', self._parameter_name)

    def __call__(self, simulation: "Simulation"):
        if simulation.flow.i % self.interval == 0:
            observed = simulation.context.convert_to_ndarray(
                self.observable(simulation.flow.f))
            if observed.ndim >= 2:
                raise ValueError("observables must be scalars or vectors")
            observed = ([observed.item()] if observed.ndim == 0
                        else observed.tolist())
            entry = ([simulation.flow.i,
                      simulation.units.convert_time_to_pu(simulation.flow.i)]
                     + observed)
            if isinstance(self.out, list):
                self.out.append(entry)
            else:
                print(*entry, file=self.out)


class ErrorReporter(Reporter):
    """Resolution-normalised L2 errors of u and p against an analytic
    solution."""

    def __init__(self, analytical_solution, interval=1, out=sys.stdout):
        super().__init__(interval)
        self.analytical_solution = analytical_solution
        self.out = [] if out is None else out
        if not isinstance(self.out, list):
            print("#error_u         error_p", file=self.out)

    def __call__(self, simulation: "Simulation"):
        flow = simulation.flow
        i = flow.i
        t = simulation.units.convert_time_to_pu(i)

        if i % self.interval == 0:
            pref, uref = self.analytical_solution(t=t)
            pref = flow.context.convert_to_tensor(pref)
            uref = flow.context.convert_to_tensor(uref)
            p = flow.p_pu
            u = flow.u_pu

            resolution = float(np.prod(np.asarray(p.shape))
                               ) ** (1 / flow.stencil.d)

            err_u = (torch.linalg.vector_norm(u - uref)
                     / resolution ** (flow.stencil.d / 2))
            err_p = (torch.linalg.vector_norm(p - pref)
                     / resolution ** (flow.stencil.d / 2))

            if isinstance(self.out, list):
                self.out.append([float(err_u), float(err_p)])
            else:
                print(float(err_u), float(err_p), file=self.out)


def mean_analytic_error(simulation, num_steps: int):
    """Mean per-step L2 errors of (u, p) against the flow's analytic
    solution over ``num_steps`` steps: ``ErrorReporter(interval=1)``, the
    mean of the absolute per-step errors including the initial state.

    The errors stay in a device tensor during the run and reach the host
    once at the end. Returns ``(err_u, err_p)`` floats; the flow state
    advances as with a normal call.
    """
    flow = simulation.flow
    units = flow.units
    # prod(p.shape)^(1/d) ** (d/2) == sqrt(prod(p.shape))
    denom = float(np.sqrt(np.prod([1] + list(flow.resolution))))
    errs = torch.empty((num_steps + 1, 2), dtype=flow.context.dtype,
                       device=flow.context.device)

    def record(row, f, i):
        pref, uref = flow.analytic_solution(t=units.convert_time_to_pu(i))
        view = flow.view(f)
        errs[row, 0] = torch.linalg.vector_norm(view.u_pu - uref) / denom
        errs[row, 1] = torch.linalg.vector_norm(view.p_pu - pref) / denom

    i0 = int(flow.i)
    f = flow.f
    record(0, f, i0)
    for k in range(num_steps):
        f = simulation._step(f)
        record(k + 1, f, i0 + 1 + k)
    flow.f = f
    flow.i += num_steps
    err_u, err_p = errs.abs().mean(dim=0).tolist()
    return err_u, err_p
