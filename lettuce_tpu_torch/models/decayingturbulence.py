"""Decaying isotropic turbulence with a prescribed initial spectrum.

As in ``lettuce_tpu``: a random-phase velocity field is shaped to
``E(k) ~ k^4 exp(-2 (k/k0)^2)``, projected divergence-free against the
*modified* wavenumbers ``sin(k dx)/dx`` (so the discrete second-order
divergence vanishes, not just the spectral one), and rescaled to the
requested kinetic energy. Construction runs once on the host in numpy
float64 from ``np.random.RandomState(randseed)``, so both packages draw
the same field; the field then moves to the device. Wavenumber components
pair with grid axes through ``indexing='ij'``.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..stencil import D1Q3, D2Q9, D3Q19
from ..unit import UnitConversion
from ._ext_flow import ExtFlow, expand_resolution, periodic_grid

__all__ = ["DecayingTurbulence"]


class DecayingTurbulence(ExtFlow):
    """Periodic box of synthetic turbulence decaying from ``ic_energy``
    at peak wavenumber ``k0``. ``randseed`` fixes the phase realisation.
    The pressure-Poisson initialisation runs in 2D only."""

    def __init__(self, context: "Context", resolution: Union[int, List[int]],
                 reynolds_number, mach_number, k0=20, ic_energy=0.5,
                 stencil: Optional["Stencil"] = None,
                 equilibrium: Optional["Equilibrium"] = None,
                 initialize_pressure: bool = True,
                 initialize_fneq: bool = True,
                 randseed: Optional[int] = None):
        self.k0 = k0
        self.ic_energy = ic_energy
        self.randseed = randseed
        self.initialize_fneq = initialize_fneq
        self.wavenumbers = []
        self.spectrum = []
        if stencil is None:
            stencil = (D1Q3, D2Q9, D3Q19)[len(resolution) - 1]()
        elif callable(stencil):
            stencil = stencil()
        self.initialize_pressure = initialize_pressure and stencil.d == 2
        super().__init__(context, resolution, reynolds_number, mach_number,
                         stencil, equilibrium)

    # -------------------- geometry --------------------
    @property
    def grid(self):
        return periodic_grid(self.resolution, 2 * np.pi, self.context.dtype,
                             self.context.device)

    @property
    def boundaries(self) -> List["Boundary"]:
        return []

    @property
    def energy_spectrum(self):
        return self.spectrum, self.wavenumbers

    def analytic_solution(self, x, t=0):
        return

    # -------------------- spectral construction --------------------
    def _target_spectrum(self):
        """Shell-binned target E(k) plus the per-mode wavevector grid."""
        shape = tuple(self.resolution)
        freq = [np.fft.fftfreq(n, d=1 / n) for n in shape]
        kvec = np.meshgrid(*freq, indexing="ij")  # 'ij': k_a <-> axis a
        knorm = np.linalg.norm(kvec, axis=0)

        ek = knorm ** 4 * np.exp(-2 * (knorm / self.k0) ** 2)
        ek *= self.ic_energy / np.sum(ek)

        # the shell-binned spectrum, for diagnostics: shell k holds the
        # modes with k - 1/2 < |k| <= k + 1/2, summed by bincount (a
        # [*grid, shells] mask would take ~30 GB at 256^3)
        self.wavenumbers = np.arange(int(np.max(knorm)))
        shell = np.ceil(knorm - 0.5).astype(np.int64).ravel()
        inside = shell < len(self.wavenumbers)
        self.spectrum = np.bincount(shell[inside], weights=ek.ravel()[inside],
                                    minlength=len(self.wavenumbers))
        return ek, kvec

    def _synthesise_velocity(self, ek, kvec):
        """Random phases -> spectrum-shaped -> divergence-projected ->
        energy-rescaled velocity field (complex arithmetic throughout)."""
        d = self.stencil.d
        shape = tuple(self.resolution)
        dx = self.units.convert_length_to_pu(1.0)

        def kill_dc(fields):
            for c in fields:
                c.ravel()[0] = 0

        rng = np.random.RandomState(self.randseed)
        phases = rng.random_sample((d,) + shape) * 2 * np.pi + 0j
        uh = [np.fft.fftn(phases[a], axes=tuple(range(d)))
              for a in range(d)]
        kill_dc(uh)

        # shape |u_h| to the target spectrum (equipartition over components)
        amp = [np.sqrt(2 / d * ek / (uh[a].imag ** 2 + uh[a].real ** 2
                                     + 1.e-15)) for a in range(d)]
        uh = [amp[a] * uh[a] for a in range(d)]
        kill_dc(uh)

        # project out the *discrete* divergence: modified wavenumbers of
        # the 2nd-order central difference
        km = [np.sin(kvec[a] * dx) / dx for a in range(d)]
        km_norm2 = (np.linalg.norm(km, axis=0) + 1e-16) ** 2
        div = sum(km[a] * uh[a] for a in range(d))
        uh = [uh[a] - div * km[a] / km_norm2 for a in range(d)]
        kill_dc(uh)

        # exact energy rescale
        e_kin = 0.5 * np.sum([np.sum(uh[a].real ** 2 + uh[a].imag ** 2)
                              for a in range(d)])
        scale = np.sqrt(self.ic_energy / e_kin)

        fft_norm = ((self.resolution[0] * dx ** (1 - d)
                     * np.sqrt(self.units.characteristic_length_pu))
                    if d == 3 else (self.resolution[0] / dx))
        return np.asarray([
            (np.fft.ifftn(uh[a] * scale, axes=tuple(range(d)))
             * fft_norm).real for a in range(d)])

    def initial_pu(self):
        """Also sets the characteristic velocity from the realised field."""
        ek, kvec = self._target_spectrum()
        u = self._synthesise_velocity(ek, kvec)
        self.units.characteristic_velocity_pu = np.linalg.norm(u,
                                                               axis=0).max()
        p = np.zeros((1,) + tuple(self.resolution))
        return p, u

    # -------------------- configuration hooks --------------------
    def make_resolution(self, resolution: Union[int, List[int]],
                        stencil: Optional["Stencil"] = None) -> List[int]:
        d = stencil.d if stencil is not None else len(resolution)
        return expand_resolution(resolution, d)

    def make_units(self, reynolds_number, mach_number,
                   resolution) -> "UnitConversion":
        return UnitConversion(reynolds_number, mach_number,
                              characteristic_length_lu=resolution[0],
                              characteristic_length_pu=2 * np.pi,
                              characteristic_velocity_pu=None)
