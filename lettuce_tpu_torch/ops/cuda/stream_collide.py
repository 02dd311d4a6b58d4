"""Fused BGK collide-and-stream step: the hand-written CUDA kernel, its
plain PyTorch version, and the simulation gate that selects it.

The kernel (``lettuce_tpu_torch/csrc/stream_collide.cu``) replaces
``lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel`` for
the periodic BGK configuration (no masks, one step per launch) in float32
and float64, for D2Q9, D3Q15, D3Q19 and D3Q27. It is bound by device
memory: D3Q19 in float32 moves 19*4 bytes in and 19*4 bytes out per cell,
152 B per lattice update, and the design reads each population once and
writes it once (see the source for how).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, cached under ``build/lettuce_tpu_torch/`` by a
hash of the source and the flags, and loaded with ``ctypes``. A missing
``nvcc``, a failed build or a failed load raises.

:func:`stream_collide` runs the plain version only for a CPU tensor. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ...stencil import D2Q9, D3Q15, D3Q19, D3Q27
from ..collision import BGKCollision, bgk_relax
from ..equilibrium import QuadraticEquilibrium, quadratic_feq
from ..streaming import stream

__all__ = ["stream_collide", "stream_collide_plain", "load_library",
           "build_library", "gate_fused_params"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "stream_collide.cu"
_BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
              / "lettuce_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# one compiled entry per (stencil, dtype): lt_stream_collide_<name>_<suffix>
_KERNEL_STENCILS = {"d2q9": D2Q9, "d3q15": D3Q15, "d3q19": D3Q19,
                    "d3q27": D3Q27}
KERNEL_STENCILS = tuple(_KERNEL_STENCILS.values())
_DTYPES = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double)}
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's default install


# ----------------------------------------------------------------------
# the plain PyTorch version
# ----------------------------------------------------------------------
def stream_collide_plain(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                         opposite: np.ndarray, cs: float, tau_inv: float
                         ) -> torch.Tensor:
    """One BGK collide-and-stream step in plain PyTorch: the quadratic
    equilibrium, BGK relaxation, then a per-q ``torch.roll``."""
    et = torch.as_tensor(np.asarray(e), dtype=f.dtype, device=f.device)
    wt = torch.as_tensor(np.asarray(w), dtype=f.dtype, device=f.device)
    rho = torch.sum(f, dim=0, keepdim=True)
    u = torch.tensordot(et.T, f, dims=1) / rho
    feq = quadratic_feq(et, wt, cs, rho, u)
    return stream(bgk_relax(f, feq, tau_inv), e)


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------
def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location; raises if none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for nvcc in candidates:
        if os.path.isfile(nvcc) and os.access(nvcc, os.X_OK):
            return nvcc
    raise RuntimeError(f"nvcc not found (looked in $CUDA_HOME/bin, on PATH "
                       f"and at {DEFAULT_NVCC}): the CUDA stream-collide "
                       f"kernel cannot be built")


def library_path() -> Path:
    """Where the library for the current source and flags is cached."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"stream_collide_{digest[:16]}.so"


def build_library() -> Path:
    """Compile the kernel source unless the cached library exists."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: concurrent builders never see
    # a half-written library
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        tmp_so = Path(tmp) / path.name
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_so), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the CUDA kernel failed "
                               f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_so, path)
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ``argtypes`` set
    on every entry."""
    lib = ctypes.CDLL(str(build_library()))
    for name in _KERNEL_STENCILS:
        for suffix, scalar in _DTYPES.values():
            fn = getattr(lib, f"lt_stream_collide_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           scalar, ctypes.c_double, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.lt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lt_cuda_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def kernel_stencil_name(e, w, opposite) -> str:
    """The compiled instance whose tables equal (e, w, opposite); raises
    ValueError if there is none."""
    e, w, opposite = np.asarray(e), np.asarray(w), np.asarray(opposite)
    for name, stencil in _KERNEL_STENCILS.items():
        if (e.shape == stencil.e.shape and np.array_equal(e, stencil.e)
                and np.array_equal(w, stencil.w)
                and np.array_equal(opposite, stencil.opposite)):
            return name
    raise ValueError(f"no compiled stream-collide kernel for the stencil "
                     f"with e of shape {e.shape}: the kernel has "
                     f"{sorted(_KERNEL_STENCILS)}")


def stream_collide(f: torch.Tensor, e: np.ndarray, w: np.ndarray,
                   opposite: np.ndarray, cs: float, tau_inv: float,
                   out: torch.Tensor = None) -> torch.Tensor:
    """One fused BGK collide-and-stream step ``f -> out``.

    ``f`` is ``[q, X, Y]`` or ``[q, X, Y, Z]``. On a CPU tensor this is
    :func:`stream_collide_plain`; on a CUDA tensor it launches the kernel
    (allocating ``out`` with ``torch.empty`` when none is given) or raises.
    ``out`` must not be ``f``: the kernel pushes to neighbours.
    """
    if f.device.type == "cpu":
        result = stream_collide_plain(f, e, w, opposite, cs, tau_inv)
        return result if out is None else out.copy_(result)
    if f.device.type != "cuda":
        raise ValueError(f"stream_collide runs on cpu or cuda tensors, "
                         f"got {f.device}")
    if f.requires_grad:
        raise RuntimeError(
            "stream_collide has no backward kernel: the adjoint of this "
            "step (lettuce_tpu/ops/pallas/adjoint.py::fused_adjoint) is "
            "not ported yet; differentiate through the torch step "
            "(use_native=False) instead")
    if f.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or float64 state, "
                        f"got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("the kernel needs a contiguous state tensor")
    name = kernel_stencil_name(e, w, opposite)
    q, d = np.asarray(e).shape
    if f.dim() != d + 1 or f.shape[0] != q:
        raise ValueError(f"state of shape {tuple(f.shape)} does not fit a "
                         f"D{d}Q{q} stencil")
    n0, n1, n2 = (1, *f.shape[1:]) if d == 2 else tuple(f.shape[1:])
    if min(n0, n1, n2) < 1 or max(n0, n1) > _MAX_GRID_YZ:
        raise ValueError(f"grid {tuple(f.shape[1:])} is outside the "
                         f"kernel's launch grid (leading axes up to "
                         f"{_MAX_GRID_YZ})")
    if out is None:
        out = torch.empty_like(f)
    elif (out.shape != f.shape or out.dtype != f.dtype
          or out.device != f.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of f's shape, "
                         "dtype and device")
    elif out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f")

    lib = load_library()
    suffix = _DTYPES[f.dtype][0]
    launch = getattr(lib, f"lt_stream_collide_{name}_{suffix}")
    rc = launch(f.data_ptr(), out.data_ptr(), n0, n1, n2, float(tau_inv),
                float(cs), f.device.index,
                torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream_collide launch failed: "
                           f"{lib.lt_cuda_error_string(rc).decode()}")
    stream_collide.launches += 1
    return out


stream_collide.launches = 0


# ----------------------------------------------------------------------
# the simulation gate
# ----------------------------------------------------------------------
def gate_fused_params(simulation: "Simulation") -> dict:
    """Static kernel parameters for a Simulation; raises when the
    configuration cannot run inside the kernel, which takes a compiled
    stencil, float32 or float64 state, the quadratic equilibrium, BGK
    without force and no boundaries."""
    flow = simulation.flow
    stencil = flow.stencil
    kernel_stencil_name(stencil.e, stencil.w, stencil.opposite)
    if flow.context.dtype not in _DTYPES:
        raise NotImplementedError(
            f"the CUDA kernel runs float32 and float64 state, not "
            f"{flow.context.dtype}; use_native=False runs the torch step")
    if not isinstance(flow.equilibrium, QuadraticEquilibrium):
        raise NotImplementedError(type(flow.equilibrium).__name__)
    if not isinstance(simulation.collision, BGKCollision):
        raise NotImplementedError(type(simulation.collision).__name__)
    if (simulation.no_collision_mask is not None
            or simulation.no_streaming_mask is not None):
        raise NotImplementedError("boundary masks")
    return dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                cs=float(stencil.cs),
                tau_inv=float(1.0 / simulation.collision.tau))
