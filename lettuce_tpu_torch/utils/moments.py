"""Moment transforms for MRT collisions.

``moment_tensor``, ``get_default_moment_transform``, the ``Transform``
protocol and the linear transforms with a closed-form equilibrium:

  * D1Q3: natural moments e^0, e^1, e^2;
  * D2Q9 Lallemand & Luo (2000): [1, ex, ey, ex^2-ey^2, ex ey,
    -4+3|e|^2, (-5+3|e|^2) ex, (-5+3|e|^2) ey, 4 - 21/2 |e|^2 + 9/2 |e|^4];
  * D2Q9 Dellar (2002): [1, ex, ey, (9 ex^2 - 3)/2, 9 ex ey,
    (9 ey^2 - 3)/2, N(|e|^2), (6|e|^2 - 8) ex, (6|e|^2 - 8) ey];
  * D3Q27 Hermite: tensor products of H0 = 1, H1 = e, H2 = e^2 - cs^2;
  * D3Q19 d'Humieres et al. (2002).

Every matrix is generated from its basis polynomials on the stencil
velocities and inverted numerically, as in ``lettuce_tpu``. The
equilibrium moments of the closed forms are module functions of
``(rho, j)``, shared by the transforms and by the plain step of the CUDA
kernel's MRT fragment.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from ..stencil import D1Q3, D2Q9, D3Q19, D3Q27, Stencil

__all__ = ["moment_tensor", "get_default_moment_transform", "Transform",
           "D1Q3Transform", "D2Q9Lallemand", "D2Q9Dellar", "D3Q27Hermite",
           "D3Q19DHumieres", "HERMITE_MULTIINDICES", "lallemand_meq",
           "dellar_meq", "hermite_meq", "InefficientCodeWarning",
           "ExperimentalWarning"]


class InefficientCodeWarning(UserWarning):
    pass


class ExperimentalWarning(UserWarning):
    pass


def moment_tensor(e, multiindex):
    """prod_a e_a^multiindex_a for each (multiindex row, velocity)."""
    e = np.asarray(e)
    multiindex = np.asarray(multiindex)
    return np.prod(np.power(e, multiindex[..., None, :]), axis=-1)


def get_default_moment_transform(stencil: "Stencil", context: "Context"):
    instance = stencil if isinstance(stencil, Stencil) else stencil()
    if isinstance(instance, D1Q3):
        return D1Q3Transform(instance, context)
    if isinstance(instance, D2Q9):
        return D2Q9Lallemand(instance, context)
    if isinstance(instance, D3Q19):
        return D3Q19DHumieres(instance, context)
    raise ValueError(f"No default moment transform for lattice {stencil}.")


class Transform:
    """Moment transform protocol: ``transform`` / ``inverse_transform`` /
    ``equilibrium`` (in moment space)."""

    names: List[str] = None
    supported_stencils: List[type] = []

    def __init__(self, stencil: "Stencil", context: "Context" = None,
                 names=None):
        self.context = context
        self.stencil = stencil
        self.names = ([f"m{i}" for i in range(stencil.q)]
                      if names is None else names)

    def __getitem__(self, moment_names):
        if not isinstance(moment_names, tuple):
            moment_names = [moment_names]
        return [self.names.index(name) for name in moment_names]

    def transform(self, f):
        return f

    def inverse_transform(self, m):
        return m

    def equilibrium(self, m: torch.Tensor, flow: "Flow"):
        """Fallback: roundtrip through f-space (inefficient, warns)."""
        warnings.warn(
            "Transform.equilibrium is a poor man's implementation of the "
            "moment equilibrium. Please consider implementing the "
            "equilibrium moments for your transform by hand.",
            InefficientCodeWarning)
        f = self.inverse_transform(m)
        feq = flow.equilibrium(flow, flow.rho(f), flow.u(f))
        return self.transform(feq)

    @staticmethod
    def _mv(matrix, v):
        return torch.tensordot(matrix.to(v.dtype), v, dims=1)


class _MatrixTransform(Transform):
    """Linear transform defined by a generated moment matrix."""

    def __init__(self, stencil: "Stencil", context: "Context" = None,
                 names=None):
        super().__init__(stencil, context, names or type(self).names)
        e = stencil.e  # a Stencil's numpy table, or a TorchStencil's tensor
        if isinstance(e, torch.Tensor):
            e = e.cpu().numpy()
        matrix = self._build_matrix(np.asarray(e, dtype=np.float64))
        inverse = np.linalg.inv(matrix)
        if context is not None:
            self.matrix = context.convert_to_tensor(matrix)
            self.inverse = context.convert_to_tensor(inverse)
        else:
            self.matrix = torch.as_tensor(matrix, dtype=torch.float64)
            self.inverse = torch.as_tensor(inverse, dtype=torch.float64)

    @staticmethod
    def _build_matrix(e: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, f):
        return self._mv(self.matrix, f)

    def inverse_transform(self, m):
        return self._mv(self.inverse, m)


class D1Q3Transform(_MatrixTransform):
    """Natural moments rho, j, e = e^0, e^1, e^2."""

    names = ["rho", "j", "e"]
    supported_stencils = [D1Q3]

    @staticmethod
    def _build_matrix(e):
        ex = e[:, 0]
        return np.stack([np.ones_like(ex), ex, ex ** 2])


def dellar_meq(m: torch.Tensor) -> torch.Tensor:
    """Equilibrium moments of the Dellar basis from m[0] = rho, m[1:3] = j."""
    rho, jx, jy = m[0], m[1], m[2]
    zeros = torch.zeros_like(rho)
    return torch.stack([
        rho, jx, jy,
        jx * jx / rho * 9 / 2,
        jx * jy / rho * 9,
        jy * jy / rho * 9 / 2,
        zeros, zeros, zeros,
    ])


def lallemand_meq(m: torch.Tensor) -> torch.Tensor:
    """Equilibrium moments of the Lallemand & Luo basis from m[0] = rho,
    m[1:3] = j."""
    rho, jx, jy = m[0], m[1], m[2]
    c1, alpha2, alpha3 = -2, -8, 4
    gamma1, gamma2, gamma3, gamma4 = 2 / 3, 18, 2 / 3, -18
    j2 = jx ** 2 + jy ** 2
    return torch.stack([
        rho, jx, jy,
        1 / 2 * gamma1 * (jx ** 2 - jy ** 2),
        1 / 2 * gamma3 * (jx * jy),
        1 / 4 * alpha2 * rho + 1 / 6 * gamma2 * j2,
        1 / 2 * c1 * jx,
        1 / 2 * c1 * jy,
        1 / 4 * alpha3 * rho + 1 / 6 * gamma4 * j2,
    ])


class D2Q9Dellar(_MatrixTransform):
    """Dellar (2002) basis: rho / j / Pi / N / J."""

    names = ["rho", "jx", "jy", "Pi_xx", "Pi_xy", "PI_yy", "N", "Jx", "Jy"]
    supported_stencils = [D2Q9]

    @staticmethod
    def _build_matrix(e):
        ex, ey = e[:, 0], e[:, 1]
        s = ex ** 2 + ey ** 2
        return np.stack([
            np.ones_like(ex),
            ex,
            ey,
            (9 * ex ** 2 - 3) / 2,
            9 * ex * ey,
            (9 * ey ** 2 - 3) / 2,
            4.5 * s ** 2 - 7.5 * s + 1,
            (6 * s - 8) * ex,
            (6 * s - 8) * ey,
        ])

    def equilibrium(self, m, flow: "Flow"):
        warnings.warn("I am not 100% sure if this equilibrium is correct.",
                      ExperimentalWarning)
        return dellar_meq(m)


class D2Q9Lallemand(_MatrixTransform):
    """Classic Lallemand & Luo (2000) basis."""

    names = ["rho", "jx", "jy", "pxx", "pxy", "e", "qx", "qy", "eps"]
    supported_stencils = [D2Q9]

    @staticmethod
    def _build_matrix(e):
        ex, ey = e[:, 0], e[:, 1]
        s = ex ** 2 + ey ** 2
        return np.stack([
            np.ones_like(ex),
            ex,
            ey,
            ex ** 2 - ey ** 2,
            ex * ey,
            -4 + 3 * s,
            (-5 + 3 * s) * ex,
            (-5 + 3 * s) * ey,
            4 - 10.5 * s + 4.5 * s ** 2,
        ])

    def equilibrium(self, m, flow: "Flow"):
        """From Lallemand and Luo."""
        warnings.warn("I am not 100% sure if this equilibrium is correct.",
                      ExperimentalWarning)
        return lallemand_meq(m)


# multi-index order of the 27 Hermite moments
HERMITE_MULTIINDICES = [
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2), (0, 2, 1),
    (0, 1, 2),
    (2, 2, 0), (2, 1, 1), (2, 0, 2), (1, 2, 1), (1, 1, 2), (0, 2, 2),
    (2, 2, 1), (2, 1, 2), (1, 2, 2), (2, 2, 2),
]


def hermite_meq(m: torch.Tensor) -> torch.Tensor:
    """Equilibrium tensor-Hermite moments from m[0] = rho, m[1:4] = j:
    products of momenta over rho^(order - 1)."""
    rho, jx, jy, jz = m[0], m[1], m[2], m[3]
    rows = [rho, jx, jy, jz]
    for (i, jj, k) in HERMITE_MULTIINDICES[4:]:
        order = i + jj + k
        rows.append(jx ** i * jy ** jj * jz ** k / rho ** (order - 1))
    return torch.stack(rows)


class D3Q27Hermite(_MatrixTransform):
    """Tensor-Hermite moments: products of H0=1, H1=e, H2=e^2 - cs^2."""

    names = ['rho', 'jx', 'jy', 'jz',
             'Pi_xx', 'Pi_xy', 'PI_xz', 'PI_yy', 'PI_yz', 'PI_zz',
             'J_xxy', 'J_xxz', 'J_xyy', 'J_xyz', 'J_xzz', 'J_yyz', 'J_yzz',
             'J_xxyy', 'J_xxyz', 'J_xxzz', 'J_xyyz', 'J_xyzz', 'J_yyzz',
             'J_xxyyz', 'J_xxyzz', 'J_xyyzz', 'J_xyxzyz']
    supported_stencils = [D3Q27]

    @staticmethod
    def _build_matrix(e):
        cs2 = 1.0 / 3.0

        def hermite(x, order):
            if order == 0:
                return np.ones_like(x)
            if order == 1:
                return x
            return x ** 2 - cs2

        rows = []
        for (i, j, k) in HERMITE_MULTIINDICES:
            rows.append(hermite(e[:, 0], i) * hermite(e[:, 1], j)
                        * hermite(e[:, 2], k))
        return np.stack(rows)

    def equilibrium(self, m, flow: "Flow"):
        return hermite_meq(m)


class D3Q19DHumieres(_MatrixTransform):
    """d'Humieres et al. (2002) Gram-Schmidt basis for D3Q19: density,
    energy, energy square, momenta with their heat fluxes, the five
    second-order stress modes with their higher-order partners, and the
    three antisymmetric third-order modes. Its equilibrium moments are the
    exact moment-space image of the quadratic equilibrium, so equal
    relaxation rates reduce the MRT collision to BGK."""

    names = ["rho", "e", "eps", "jx", "qx", "jy", "qy", "jz", "qz",
             "pxx3", "pixx3", "pww", "piww", "pxy", "pyz", "pxz",
             "mx", "my", "mz"]
    supported_stencils = [D3Q19]

    @staticmethod
    def _build_matrix(e):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        s = ex ** 2 + ey ** 2 + ez ** 2
        return np.stack([
            np.ones_like(ex),
            19 * s - 30,
            (21 * s ** 2 - 53 * s + 24) / 2,
            ex,
            (5 * s - 9) * ex,
            ey,
            (5 * s - 9) * ey,
            ez,
            (5 * s - 9) * ez,
            3 * ex ** 2 - s,
            (3 * s - 5) * (3 * ex ** 2 - s),
            ey ** 2 - ez ** 2,
            (3 * s - 5) * (ey ** 2 - ez ** 2),
            ex * ey,
            ey * ez,
            ex * ez,
            (ey ** 2 - ez ** 2) * ex,
            (ez ** 2 - ex ** 2) * ey,
            (ex ** 2 - ey ** 2) * ez,
        ])

    def equilibrium(self, m, flow: "Flow"):
        f = self.inverse_transform(m)
        feq = flow.equilibrium(flow, flow.rho(f), flow.u(f))
        return self.transform(feq)
