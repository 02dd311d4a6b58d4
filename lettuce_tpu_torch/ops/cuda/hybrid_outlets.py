"""The outlet window replay: the exact step on the planes an outlet owns,
composed after the fused kernel.

A port of ``lettuce_tpu/ops/pallas/hybrid_outlets.py`` (its single-device
fix-up) in plain torch. The outlets of ``HYBRID_OUTLET_TYPES`` have no
kernel form, but each changes f_post only on the few grid planes it owns.
So the kernel runs the whole domain with their nodes frozen (the
``identity`` kind of its table), and this replay recomputes the exact step
result on the planes the kernel got wrong:

* sources: the planes the outlet owns (their f_post is the outlet's
  replacement, not identity);
* targets: those planes and their neighbours along the face axis up to
  the kernel's span ``n_sub`` (1 for the single-step kernel, n_sub for a
  launch of the blocked kernel, whose error spreads one plane per
  sub-step), including the periodic wrap onto the opposite edge.

The replay takes a periodic window of the owned planes +- 2 n_sub along
the face axis, runs ``n_sub`` steps of the torch step's composition on it
(collision, every boundary through ``window_view``, streaming with the
window's no-streaming mask) and writes the target planes over the kernel
output, in place. Rolls inside the window are right wherever they are
read: the window's edge is wrong after each step by one more plane, so
after n_sub steps the planes n_sub from the edge, the targets, are still
exact. Several outlets compose: each replay includes every boundary, so
each writes exact values even where two overlap. It runs in the state's
dtype (a bfloat16 or float16 state replays in 16 bits, as lettuce_tpu's
does).

The replay is differentiable by autograd: the in-place write passes no
cotangent to the planes it overwrites, so the kernel's adjoint sees the
cotangent with those planes zeroed, and the window's own graph carries
the rest.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ... import tracing
from ..streaming import compose_step

__all__ = ["outlet_window", "build_hybrid_fixup", "nsm_outside_regions"]


def _take_window(x: torch.Tensor, dim: int, lo: int, width: int,
                 n: int) -> torch.Tensor:
    """The periodic window ``[lo, lo + width)`` (mod n) of ``x`` along
    ``dim``: at most two slices."""
    lo %= n
    if lo + width <= n:
        return x.narrow(dim, lo, width)
    return torch.cat([x.narrow(dim, lo, n - lo),
                      x.narrow(dim, 0, lo + width - n)], dim=dim)


def _set_window(x: torch.Tensor, values: torch.Tensor, dim: int, lo: int,
                width: int, n: int) -> torch.Tensor:
    """Write ``values`` over the periodic window ``[lo, lo + width)`` of
    ``x`` along ``dim``, in place; returns ``x``."""
    lo %= n
    if lo + width <= n:
        x.narrow(dim, lo, width).copy_(values)
        return x
    x.narrow(dim, lo, n - lo).copy_(values.narrow(dim, 0, n - lo))
    x.narrow(dim, 0, lo + width - n).copy_(
        values.narrow(dim, n - lo, lo + width - n))
    return x


def outlet_window(no_collision_mask: torch.Tensor, code: int,
                  axis: int, n_sub: int = 1) -> Tuple[int, int]:
    """``(win_lo, width)`` of the replay window of the outlet whose mask
    code is ``code``, along grid ``axis``, for a kernel of span ``n_sub``:
    the owned planes +- 2 n_sub. Raises NotImplementedError when the
    windowed replay cannot express it: the outlet owns no node, its planes
    are not contiguous, or the window spans the whole axis."""
    ncm = no_collision_mask.cpu().numpy()
    owned = np.nonzero(ncm == code)[axis]
    if owned.size == 0:
        raise NotImplementedError("outlet owns no nodes (mask overlap)")
    planes = np.unique(owned)
    lo, hi = int(planes.min()), int(planes.max())
    if hi - lo + 1 != len(planes):
        raise NotImplementedError("outlet planes are not contiguous")
    width = (hi - lo + 1) + 4 * n_sub
    if width >= ncm.shape[axis]:
        raise NotImplementedError(
            f"fix-up window spans the whole axis ({width} planes at span "
            f"{n_sub}, axis of {ncm.shape[axis]})")
    return lo - 2 * n_sub, width


def _build_one_fixup(simulation: "Simulation", code: int,
                     outlet: "Boundary", n_sub: int):
    """The replay of one outlet at span ``n_sub``; see the module
    docstring."""
    flow = simulation.flow
    axis = outlet.face_axis
    n = int(flow.resolution[axis])
    win_lo, width = outlet_window(simulation.no_collision_mask, code, axis,
                                  n_sub)
    ncm_win = _take_window(simulation.no_collision_mask, axis, win_lo,
                           width, n)
    nsm_win = None
    if simulation.no_streaming_mask is not None:
        nsm_win = _take_window(simulation.no_streaming_mask, axis + 1,
                               win_lo, width, n)
    boundaries: List = [
        b.window_view(axis, win_lo, width, n)
        if hasattr(b, "window_view") else b
        for b in simulation.boundaries[1:]]
    collision = simulation.collision

    def fixup(f_pre: torch.Tensor, f_kernel: torch.Tensor) -> torch.Tensor:
        f_win = _take_window(f_pre, axis + 1, win_lo, width, n)
        for _ in range(n_sub):
            f_win = compose_step(f_win, flow, collision, boundaries, ncm_win,
                                 nsm_win)
        # the targets: the owned planes +- n_sub, window-local
        # [n_sub, width - n_sub)
        return _set_window(f_kernel,
                           f_win.narrow(axis + 1, n_sub, width - 2 * n_sub),
                           axis + 1, win_lo + n_sub, width - 2 * n_sub, n)

    rewritten = np.array([(win_lo + n_sub + k) % n
                          for k in range(width - 2 * n_sub)])
    return fixup, axis, rewritten


def build_hybrid_fixup(simulation: "Simulation",
                       hybrid: Tuple[Tuple[int, "Boundary"], ...],
                       n_sub: int = 1):
    """The replay for a simulation whose kernel froze the outlets of
    ``hybrid`` (``(code, outlet)`` pairs, from
    :func:`.stream_collide.gate_fused_params`), for a launch of ``n_sub``
    steps (the blocked kernel's span; 1 for the single-step kernel).

    Returns ``(fixup, regions)``: ``fixup(f_pre, f_kernel)`` writes the
    exact result of ``n_sub`` steps into ``f_kernel`` (the kernel's output
    for the input ``f_pre``) and returns it; ``regions`` lists
    ``(grid_axis, rewritten_plane_indices)``, the planes it rewrites (the
    owned planes +- n_sub). Raises NotImplementedError (from
    :func:`outlet_window`) when a window cannot express an outlet at this
    span.
    """
    parts = [_build_one_fixup(simulation, code, outlet, int(n_sub))
             for code, outlet in hybrid]

    def fixup(f_pre: torch.Tensor, f_kernel: torch.Tensor) -> torch.Tensor:
        tracing.count("replay")
        with tracing.span("replay"):
            for one, _, _ in parts:
                f_kernel = one(f_pre, f_kernel)
            return f_kernel

    return fixup, [(axis, rewritten) for _, axis, rewritten in parts]


def nsm_outside_regions(nsm: torch.Tensor, regions) -> bool:
    """True if a frozen population of ``nsm`` lies outside the planes the
    replay rewrites; when none does, the kernel can run without ``nsm``."""
    outside = nsm.clone()
    for axis, rewritten in regions:
        index = torch.as_tensor(rewritten, device=nsm.device)
        outside.index_fill_(axis + 1, index, False)
    return bool(outside.any())
