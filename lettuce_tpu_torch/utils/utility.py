"""Shared numerical utilities: the periodic finite-difference gradient."""

from __future__ import annotations

import torch

__all__ = ["torch_gradient"]

# Fornberg (1988) central-difference weights for the first derivative.
_FD_WEIGHTS = {
    2: ((1, -1 / 2), (-1, 1 / 2)),
    4: ((2, 1 / 12), (1, -2 / 3), (-1, 2 / 3), (-2, -1 / 12)),
    6: ((3, -1 / 60), (2, 3 / 20), (1, -3 / 4),
        (-1, 3 / 4), (-2, -3 / 20), (-3, 1 / 60)),
}


def torch_gradient(f: torch.Tensor, dx=1, order: int = 2) -> torch.Tensor:
    """First derivative of a periodic scalar field along every axis.

    Returns shape ``[ndim, *f.shape]``, at order O(h^2), O(h^4) or O(h^6).
    """
    if order not in _FD_WEIGHTS:
        raise ValueError(f"Unsupported FD order {order}")
    taps = _FD_WEIGHTS[order]
    components = []
    for axis in range(f.ndim):
        acc = torch.zeros_like(f)
        for shift, weight in taps:
            # roll(+s) brings f(x - s) to x: tap (s, w) contributes w*f(x-s)
            acc = acc + weight * torch.roll(f, shift, dims=axis)
        components.append(acc / dx)
    return torch.stack(components)
