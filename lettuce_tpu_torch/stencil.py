"""Lattice velocity sets (stencils).

The canonical representation is numpy constant tables: streaming shifts and
the CUDA kernel's unrolled loops are static metadata, never device tensors.
:class:`TorchStencil` is the device-resident mirror used where an op
contracts against ``e``/``w`` at run time (equilibria, moments).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Stencil", "TorchStencil",
           "D1Q3", "D2Q9", "D3Q15", "D3Q19", "D3Q27"]


class Stencil:
    """Velocity set ``e``, weights ``w``, ``opposite`` table, ``cs``."""

    e: np.ndarray          # [q, d] int64
    w: np.ndarray          # [q] float64
    opposite: np.ndarray   # [q] int64
    cs: float = float(1.0 / np.sqrt(3.0))

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # freeze class-level tables as numpy arrays
        if hasattr(cls, "_e"):
            cls.e = np.asarray(cls._e, dtype=np.int64)
            cls.w = np.asarray(cls._w, dtype=np.float64)
            cls.opposite = np.asarray(cls._opposite, dtype=np.int64)

    @property
    def d(self) -> int:
        return int(self.e.shape[1])

    @property
    def q(self) -> int:
        return int(self.e.shape[0])

    def __repr__(self) -> str:
        return f"{type(self).__name__}(d={self.d}, q={self.q})"


class D1Q3(Stencil):
    _e = [[0], [1], [-1]]
    _w = [2 / 3] + [1 / 6] * 2
    _opposite = [0, 2, 1]


class D2Q9(Stencil):
    _e = [[0, 0],
          [1, 0], [0, 1], [-1, 0], [0, -1],
          [1, 1], [-1, 1], [-1, -1], [1, -1]]
    _w = [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4
    _opposite = [0, 3, 4, 1, 2, 7, 8, 5, 6]


class D3Q15(Stencil):
    _e = [[0, 0, 0],
          [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
          [1, 1, 1], [-1, -1, -1], [1, 1, -1], [-1, -1, 1],
          [1, -1, 1], [-1, 1, -1], [1, -1, -1], [-1, 1, 1]]
    _w = [2 / 9] + [1 / 9] * 6 + [1 / 72] * 8
    _opposite = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13]


class D3Q19(Stencil):
    _e = [[0, 0, 0],
          [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
          [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
          [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
          [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0]]
    _w = [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12
    _opposite = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9,
                 12, 11, 14, 13, 16, 15, 18, 17]


class D3Q27(Stencil):
    _e = [[0, 0, 0],
          [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
          [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
          [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
          [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
          [1, 1, 1], [-1, -1, -1], [1, 1, -1], [-1, -1, 1],
          [1, -1, 1], [-1, 1, -1], [1, -1, -1], [-1, 1, 1]]
    _w = [8 / 27] + [2 / 27] * 6 + [1 / 54] * 12 + [1 / 216] * 8
    _opposite = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                 16, 15, 18, 17, 20, 19, 22, 21, 24, 23, 26, 25]


class TorchStencil:
    """Device-resident mirror of a stencil: ``e``/``w`` carry the context's
    dtype and device, so run-time contractions stay in the simulation
    precision."""

    cs: float = float(1.0 / np.sqrt(3.0))

    def __init__(self, stencil: Stencil, context: "Context"):
        self.stencil = stencil
        self.e = torch.as_tensor(stencil.e, dtype=context.dtype,
                                 device=context.device)
        self.w = torch.as_tensor(stencil.w, dtype=context.dtype,
                                 device=context.device)
        self.opposite = torch.as_tensor(stencil.opposite, dtype=torch.long,
                                        device=context.device)

    @property
    def d(self) -> int:
        return int(self.e.shape[1])

    @property
    def q(self) -> int:
        return int(self.e.shape[0])
