"""Shared numerical utilities: the periodic finite-difference gradient, the
Jacobi Poisson solver of the pressure initialisation, and ``append_axes``."""

from __future__ import annotations

import torch

__all__ = ["torch_gradient", "torch_jacobi", "append_axes"]

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


def _laplacian_neighbors(p: torch.Tensor, dim: int) -> torch.Tensor:
    acc = torch.zeros_like(p)
    for axis in range(dim):
        acc = acc + torch.roll(p, 1, dims=axis) + torch.roll(p, -1, dims=axis)
    return acc


def torch_jacobi(f, p, dx, dim, tol_abs=1e-10, max_num_steps=100000):
    """Jacobi solver for the Poisson equation ``lap p = f`` on a periodic
    grid, iterating until the mean squared residual drops below
    ``tol_abs`` or ``max_num_steps`` sweeps have run (at least one sweep).
    The residual is read on the host after every sweep, so the iterate
    that stops is the one ``lettuce_tpu``'s ``jax_jacobi`` stops at."""
    dx2 = dx * dx
    n_nb = 2 * dim
    for _ in range(max_num_steps):
        p = -(f * dx2 - _laplacian_neighbors(p, dim)) / n_nb
        residual = f - (_laplacian_neighbors(p, dim) - n_nb * p) / dx2
        if not float(torch.mean(residual ** 2)) > tol_abs:
            break
    return p


def append_axes(array: torch.Tensor, n: int) -> torch.Tensor:
    """``array`` with ``n`` trailing axes of length 1."""
    return array.reshape(tuple(array.shape) + (1,) * n)
