"""The MRT collision spec of the CUDA kernel, resolved from an
``MRTCollision`` (kept apart from ``cuda/stream_collide.py`` so that the
moment transforms stay out of the kernel wrapper's imports)."""

from __future__ import annotations

import numpy as np

__all__ = ["resolve_mrt_spec"]


def resolve_mrt_spec(collision) -> tuple:
    """The ``("mrt", M, Minv, taus, meq_kind)`` kernel spec of an
    MRTCollision whose transform has a closed-form equilibrium in the
    kernel (D2Q9 Lallemand / Dellar, D3Q27 tensor-Hermite) or whose
    equilibrium moments are the image of feq (D3Q19 d'Humieres). Raises
    NotImplementedError for any other transform."""
    from ..utils.moments import (D2Q9Dellar, D2Q9Lallemand, D3Q27Hermite,
                                 D3Q19DHumieres)

    tr = collision.transform
    if isinstance(tr, D2Q9Lallemand):
        meq_kind = "lallemand"
    elif isinstance(tr, D2Q9Dellar):
        meq_kind = "dellar"
    elif isinstance(tr, D3Q27Hermite):
        meq_kind = "hermite27"
    elif isinstance(tr, D3Q19DHumieres):
        meq_kind = "from_feq"
    else:
        raise NotImplementedError(
            f"MRT transform '{type(tr).__name__}' has no closed-form "
            f"equilibrium in the kernel")
    # through float64 on the host: numpy takes no 16-bit torch tensor
    M = tuple(tuple(float(x) for x in row)
              for row in tr.matrix.cpu().double().numpy())
    Minv = tuple(tuple(float(x) for x in row)
                 for row in tr.inverse.cpu().double().numpy())
    taus = tuple(float(t) for t in collision.relaxation_parameters.cpu()
                 .double().numpy().ravel())
    if len(taus) != len(M):
        raise NotImplementedError("per-moment relaxation list required")
    return ("mrt", M, Minv, taus, meq_kind)
