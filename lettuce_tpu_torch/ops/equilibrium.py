"""Equilibrium distributions: the quadratic (second-order Hermite)
equilibrium of the BGK main path."""

from __future__ import annotations

import torch

from ..flow import Equilibrium

__all__ = ["QuadraticEquilibrium", "quadratic_feq"]


def quadratic_feq(e: torch.Tensor, w: torch.Tensor, cs: float, rho, u
                  ) -> torch.Tensor:
    """f_eq = w_q rho (1 + e.u/cs^2 + (e.u)^2/(2 cs^4) - u^2/(2 cs^2)).

    ``e``: [q, d]; ``u``: [d, ...]; ``rho``: broadcastable to [...].
    Returns [q, ...]. The terms associate as in ``lettuce_tpu``'s
    ``quadratic_feq``, so float64 results agree to roundoff:
    w * rho * ((2 exu - uxu)/(2 cs^2) + 0.5 (exu/cs^2)^2 + 1).
    """
    exu = torch.tensordot(e, u, dims=1)             # [q, ...]
    uxu = torch.sum(u * u, dim=0)                   # [...]
    inner = rho * ((2 * exu - uxu) / (2 * cs ** 2)
                   + 0.5 * (exu / cs ** 2) ** 2 + 1)
    return w.reshape((-1,) + (1,) * (inner.ndim - 1)) * inner


class QuadraticEquilibrium(Equilibrium):
    def __call__(self, flow: "Flow", rho=None, u=None) -> torch.Tensor:
        rho = flow.rho() if rho is None else rho
        u = flow.u() if u is None else u
        return quadratic_feq(flow.torch_stencil.e, flow.torch_stencil.w,
                             flow.torch_stencil.cs, rho, u)

    def native_available(self) -> bool:
        return True
