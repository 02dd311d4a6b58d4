"""Streaming (advection) step: one periodic ``torch.roll`` per discrete
velocity. ``no_streaming_mask`` (per-(q, node) bool) freezes populations in
place. :func:`compose_step` is the whole plain collide-and-stream step."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["stream", "compose_step"]


def stream(f: torch.Tensor, e: np.ndarray,
           no_streaming_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Periodic streaming: f_q(x + e_q) <- f_q(x) for every q.

    ``e`` is the stencil's numpy [q, d] table: the shifts are static.
    """
    e = np.asarray(e)
    q, d = e.shape
    dims = tuple(range(d))
    rolled = [f[0]]  # e[0] == 0 for all stencils
    for i in range(1, q):
        rolled.append(torch.roll(f[i], tuple(int(s) for s in e[i]),
                                 dims=dims))
    streamed = torch.stack(rolled)
    if no_streaming_mask is not None:
        streamed = torch.where(no_streaming_mask, f, streamed)
    return streamed


def compose_step(f: torch.Tensor, flow, collision, boundaries: Sequence,
                 ncm: Optional[torch.Tensor] = None,
                 nsm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One collide-and-stream step in plain torch: the collision where
    ``ncm`` is 0, each boundary where ``ncm`` holds its code (1, 2, ... in
    the order of ``boundaries``; each reads the field the one before it
    updated), then streaming with ``nsm``. The torch step runs it on the
    full grid, the outlet window replay on a window with window-viewed
    boundaries and windowed masks."""
    if ncm is None:
        f = collision(flow.view(f))
        for boundary in boundaries:
            f = boundary(flow.view(f))
    else:
        f = torch.where(ncm == 0, collision(flow.view(f)), f)
        for code, boundary in enumerate(boundaries, start=1):
            f = torch.where(ncm == code, boundary(flow.view(f)), f)
    return stream(f, flow.stencil.e, nsm)
