"""Device/dtype configuration.

A :class:`Context` binds one explicit ``torch.device``, the floating dtype
of the simulation state, and whether the hand-written CUDA stream-collide
kernel ("native") may be used. The default device is the current CUDA
device, as lettuce_tpu's ``Context()`` takes the accelerator. Asking for a
CUDA device (or for the default) on a machine without one is an error:
nothing silently lands on the CPU, which is asked for by name.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["Context"]

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return getattr(torch, name)


class Context:
    """Resolves device, default float dtype, and the native-kernel flag.

    Parameters
    ----------
    device:
        A device string (``"cpu"``, ``"cuda"``, ``"cuda:1"``) or a
        :class:`torch.device`. The default (None) is the current CUDA
        device; without one it raises, as ``"cuda"`` does. The CPU runs
        only when ``"cpu"`` is asked for.
    dtype:
        Floating dtype of the simulation state (a torch dtype or its name).
    use_native:
        Run the fused CUDA stream-collide kernel when every component of a
        simulation supports it and the device is a CUDA device.
    """

    def __init__(self, device: Union[str, torch.device, None] = None,
                 dtype=torch.float32, use_native: bool = True):
        dtype = _resolve_dtype(dtype)
        if dtype not in _FLOAT_DTYPES:
            raise ValueError(f"dtype must be one of {_FLOAT_DTYPES}, "
                             f"got {dtype}")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} was requested, but "
                                   f"torch.cuda.is_available() is False")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if device.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"device {device} was requested, but only "
                    f"{torch.cuda.device_count()} CUDA device(s) exist")
        elif device.type != "cpu":
            raise ValueError(f"device must be a cpu or cuda device, "
                             f"got {device}")
        self.device = device
        self.dtype = dtype
        self.use_native = use_native

    # ------------------------------------------------------------------
    # tensor factories
    # ------------------------------------------------------------------
    def empty_tensor(self, size: Sequence[int], dtype=None) -> torch.Tensor:
        return torch.empty(tuple(size), dtype=self._resolve(dtype),
                           device=self.device)

    def zero_tensor(self, size: Sequence[int], dtype=None) -> torch.Tensor:
        return torch.zeros(tuple(size), dtype=self._resolve(dtype),
                           device=self.device)

    def one_tensor(self, size: Sequence[int], dtype=None) -> torch.Tensor:
        return torch.ones(tuple(size), dtype=self._resolve(dtype),
                          device=self.device)

    def convert_to_tensor(self, array, dtype=None) -> torch.Tensor:
        """Convert to a tensor on this context's device.

        Bool and integer inputs keep their dtype (mask semantics); floats
        are cast to the context dtype unless an explicit dtype is given.
        """
        if not isinstance(array, torch.Tensor):
            array = torch.as_tensor(np.asarray(array))
        if dtype is None:
            floating = array.is_floating_point() or array.is_complex()
            dtype = self.dtype if floating else array.dtype
        return array.to(device=self.device, dtype=_resolve_dtype(dtype))

    @staticmethod
    def convert_to_ndarray(tensor) -> np.ndarray:
        """A host numpy copy; a 16-bit tensor comes as float32 (exact),
        since numpy has no bfloat16."""
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach()
            if tensor.dtype in (torch.bfloat16, torch.float16):
                tensor = tensor.float()
            return tensor.cpu().numpy()
        return np.asarray(tensor)

    def _resolve(self, dtype):
        return self.dtype if dtype is None else _resolve_dtype(dtype)

    def __repr__(self) -> str:
        return (f"Context(device={self.device}, dtype={self.dtype}, "
                f"use_native={self.use_native})")
