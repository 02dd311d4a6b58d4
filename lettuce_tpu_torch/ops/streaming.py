"""Streaming (advection) step: one periodic ``torch.roll`` per discrete
velocity. ``no_streaming_mask`` (per-(q, node) bool) freezes populations in
place."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["stream"]


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
