"""Build and load the hand-written CUDA kernels of ``lettuce_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, cached under
``build/lettuce_tpu_torch/`` by a hash of its name, every source in
``csrc`` (the 16-bit sources include their fragments' ``.cu``) and the
flags, and loaded with ``ctypes``. The first load
builds every missing library at once, one ``nvcc`` per source, all started
together. A missing ``nvcc``, a failed build or a failed load raises.
``ptxas -v`` reports each kernel's registers and spills; the report is
kept beside the library (:func:`ptxas_log`).

Also here: what every wrapper checks before a launch (the compiled stencil
instance, the dtype, the launch grid), the entry suffix of each state
dtype and storage (:data:`DTYPES`, :data:`STORAGE`), and the tiles of the
blocked kernels (:func:`plan_tile`).
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
from typing import NamedTuple

import numpy as np
import torch

from ...stencil import D2Q9, D3Q15, D3Q19, D3Q27

__all__ = ["SOURCES", "find_nvcc", "library_path", "ptxas_log",
           "build_libraries",
           "open_library", "check_launch", "kernel_stencil_name",
           "launch_dims", "check_out", "KERNEL_STENCILS",
           "KERNEL_STENCIL_NAMES", "DTYPES", "STORAGE", "HALF_DTYPES",
           "storage_suffix", "compute_dtype", "plan_tile", "TilePlan",
           "TILE_SMEM_BYTES",
           "moving_axes", "mask_bytes", "tile_stride"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
# csrc/<name>.cu, one library each: the BGK step (K1a, K1d, K1b), its
# adjoint (K3a, K3c), the other collision fragments (K1c, with emit-u
# instances), their adjoints (K3b, K3d's streaming transpose), and the
# 16-bit forward instances of BGK and of each fragment source (K1e, K1f,
# and K1d on a 16-bit state), the blocked forward of BGK and of each
# fragment source in every storage (K2), the blocked adjoint (K4), and the
# adjoints of a 16-bit state (K3 and K4 at 16 bits)
SOURCES = ("stream_collide", "adjoint", "collide_basic", "collide_moments",
           "collide_mrt", "collide_kbc", "adjoint_fragments",
           "half_stream_collide", "half_basic", "half_moments", "half_mrt",
           "half_kbc", "multi_stream_collide", "multi_basic",
           "multi_moments", "multi_mrt", "multi_kbc", "adjoint_multi",
           "adjoint_half", "adjoint_multi_half")
_BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
              / "lettuce_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's default install

# one compiled entry per (stencil, dtype) in every source
_KERNEL_STENCILS = {"d2q9": D2Q9, "d3q15": D3Q15, "d3q19": D3Q19,
                    "d3q27": D3Q27}
KERNEL_STENCILS = tuple(_KERNEL_STENCILS.values())
KERNEL_STENCIL_NAMES = tuple(_KERNEL_STENCILS)
DTYPES = {torch.float32: ("f32", ctypes.c_float),
          torch.float64: ("f64", ctypes.c_double)}
# the 16-bit storage of the kernels, computed in float32 (so the BGK
# forward entries take tau_inv as a c_float): (state dtype, deviation
# storage) -> entry suffix. K1f stores a bfloat16 or float16 state, K1e the
# bfloat16 deviations g = f - w_q. The adjoints (K3, K4) and the emit-u
# forward take a 16-bit state, never deviations (no gradient).
STORAGE = {(torch.bfloat16, False): "bf16", (torch.float16, False): "f16",
           (torch.bfloat16, True): "bf16_dev"}
HALF_DTYPES = (torch.bfloat16, torch.float16)
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
# the tiles of the blocked kernels (csrc/multi_sweep.cuh): the dynamic
# shared memory a block may opt into on sm_90 (227 KB); a tile is first
# sought within what lets two blocks share an SM (its 228 KB less the 1 KB
# the runtime reserves per block, halved), then within all of it, and
# when none fits, in a global scratch of at most _SCRATCH_TILE_BYTES per
# block with _SCRATCH_BLOCKS blocks looping over the tiles
TILE_SMEM_BYTES = 232448
_TWO_BLOCK_TILE_BYTES = (233472 - 2 * 1024) // 2
_SCRATCH_TILE_BYTES = 4 << 20
_SCRATCH_BLOCKS = 264
_MAX_INTERIOR = (32, 32, 128)  # the interior extents a plan considers


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
                       f"and at {DEFAULT_NVCC}): the CUDA kernels cannot be "
                       f"built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current sources and
    flags is cached."""
    digest = hashlib.sha256(name.encode())
    for source in sorted(CSRC.glob("*.cu*")):
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> Path:
    """The compiler's report (``ptxas -v``: registers, spills) kept beside
    the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def build_libraries(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not cached yet, one
    ``nvcc`` per source, all started together; returns ``{name: path}``.
    Raises if any build fails, after every build has ended."""
    paths = {name: library_path(name) for name in names}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: concurrent builders never see
    # a half-written library
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        jobs = []
        for name in missing:
            tmp_so = Path(tmp) / paths[name].name
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_so),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, cmd, tmp_so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, cmd, tmp_so, proc in jobs:
            output, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"building {name}.cu failed (exit "
                                f"{proc.returncode}): {' '.join(cmd)}\n"
                                f"{output}")
            else:
                ptxas_log(name).write_text(output)
                os.replace(tmp_so, paths[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    return paths


@functools.cache
def open_library(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building every missing
    library first; the error-string entry gets its ``argtypes`` here, the
    kernel entries in their wrapper modules."""
    lib = ctypes.CDLL(str(build_libraries()[name]))
    lib.lt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.lt_cuda_error_string(rc).decode()}")


# ----------------------------------------------------------------------
# what every wrapper checks
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
    raise ValueError(f"no compiled CUDA kernel for the stencil with e of "
                     f"shape {e.shape}: the kernels have "
                     f"{sorted(_KERNEL_STENCILS)}")


def storage_suffix(dtype: torch.dtype, dev_storage: bool = False) -> str:
    """The entry suffix of a forward kernel for a state of ``dtype``
    (``dev_storage``: bfloat16 deviations); raises on a storage no kernel
    has."""
    if not dev_storage and dtype in DTYPES:
        return DTYPES[dtype][0]
    if (dtype, dev_storage) not in STORAGE:
        raise TypeError(f"the kernels store deviations in bfloat16 only, "
                        f"got {dtype}" if dev_storage else
                        f"the kernels take float32, float64, bfloat16 or "
                        f"float16 states, got {dtype}")
    return STORAGE[dtype, dev_storage]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """What the kernels compute in for a state of ``dtype``: float64 for
    float64, else float32 (the 16-bit storage). The emit-u forward writes u
    in it, and the adjoints read it."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def launch_dims(x: torch.Tensor, e) -> tuple:
    """(n0, n1, n2) of the kernels' 3D launch grid for a contiguous CUDA
    tensor ``x`` of shape ``[q, *grid]`` in float32, float64, bfloat16 or
    float16; raises on anything the kernels do not take."""
    if x.dtype not in DTYPES and x.dtype not in HALF_DTYPES:
        raise TypeError(f"these kernels take float32, float64, bfloat16 or "
                        f"float16 tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernels need contiguous tensors")
    q, d = np.asarray(e).shape
    if x.dim() != d + 1 or x.shape[0] != q:
        raise ValueError(f"a tensor of shape {tuple(x.shape)} does not fit "
                         f"a D{d}Q{q} stencil")
    n0, n1, n2 = (1, *x.shape[1:]) if d == 2 else tuple(x.shape[1:])
    if min(n0, n1, n2) < 1 or max(n0, n1) > _MAX_GRID_YZ:
        raise ValueError(f"grid {tuple(x.shape[1:])} is outside the "
                         f"kernels' launch grid (leading axes up to "
                         f"{_MAX_GRID_YZ})")
    return n0, n1, n2


def check_out(out: torch.Tensor, like: torch.Tensor, shape, name: str,
              *inputs: torch.Tensor, dtype: torch.dtype = None
              ) -> torch.Tensor:
    """``out``, or a new tensor of ``shape`` like ``like`` (in ``dtype``
    when given) when it is None; raises when ``out`` does not fit or
    shares memory with an input."""
    dtype = like.dtype if dtype is None else dtype
    if out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous tensor of shape "
                         f"{tuple(shape)}, dtype {dtype} and device "
                         f"{like.device}")
    for x in inputs:
        if out.data_ptr() == x.data_ptr():
            raise ValueError(f"{name} must not alias an input")
    return out


def moving_axes(e) -> tuple:
    """Whether the stencil ``e`` moves along each axis of the kernels' 3D
    launch grid (a 2D grid is ``[1, X, Y]``: never along the first)."""
    e = np.asarray(e)
    moves = tuple(bool(np.any(e[:, a] != 0)) for a in range(e.shape[1]))
    return (False,) * (3 - len(moves)) + moves


class TilePlan(NamedTuple):
    """The tiles of one blocked launch: the ``interior`` extents per axis
    of the 3D launch grid, the ``halo`` on the axes the stencil moves
    along, the tile's ``cells`` and ``bytes``, whether it runs in a global
    ``scratch`` (else shared memory), the number of ``tiles`` and the
    ``blocks`` launched."""
    interior: tuple
    halo: int
    cells: int
    bytes: int
    scratch: bool
    tiles: int
    blocks: int


def mask_bytes(q: int, itemsize: int, masked: bool, frozen: bool) -> int:
    """The bytes per tile cell a masked blocked launch (K2) adds to its q
    values (csrc/multi_sweep.cuh's TileLayout): the cell's code (1 B), and
    when populations are frozen their bits (4 B) and a second buffer of q
    values of ``itemsize`` bytes."""
    return int(masked) + (4 + q * itemsize if frozen else 0)


def tile_stride(nbytes: int) -> int:
    """A block's share of a blocked launch's global scratch: its tile's
    bytes rounded up to 16 (csrc/multi_sweep.cuh's tile_stride)."""
    return -(-int(nbytes) // 16) * 16


@functools.lru_cache(maxsize=256)
def plan_tile(dims: tuple, moving: tuple, halo: int, values_per_cell: int,
              itemsize: int, extra_bytes: int = 0) -> TilePlan:
    """The tile of a blocked launch over the launch grid ``dims`` (n0, n1,
    n2): ``moving`` says on which axes the stencil moves (those get the
    ``halo``), and each tile cell holds ``values_per_cell`` values of
    ``itemsize`` bytes and ``extra_bytes`` more (:func:`mask_bytes`). Of
    the interiors up to 32 x 32 x 128 (and the grid) it takes the one
    whose interior is the largest share of the tile (then the largest),
    within the shared memory of one of two blocks per SM, else within all
    a block may take, else in a global scratch (csrc/multi_sweep.cuh). Raises ValueError when no tile
    holds the halo."""
    halos = [halo if m else 0 for m in moving]
    axes = [np.arange(1, min(int(n), cap) + 1)
            for n, cap in zip(dims, _MAX_INTERIOR)]
    b = np.meshgrid(*axes, indexing="ij")
    interior = b[0] * b[1] * b[2]
    cells = ((b[0] + 2 * halos[0]) * (b[1] + 2 * halos[1])
             * (b[2] + 2 * halos[2]))
    nbytes = cells * (values_per_cell * itemsize + extra_bytes)
    share = interior / cells
    for budget, scratch in ((_TWO_BLOCK_TILE_BYTES, False),
                            (TILE_SMEM_BYTES, False),
                            (_SCRATCH_TILE_BYTES, True)):
        fits = nbytes <= budget
        if not fits.any():
            continue
        best = np.lexsort((np.where(fits, interior, -1).ravel(),
                           np.where(fits, share, -1.0).ravel()))[-1]
        at = np.unravel_index(best, interior.shape)
        extents = tuple(int(x[at]) for x in b)
        tiles = int(np.prod([-(-int(n) // e) for n, e in zip(dims, extents)]))
        return TilePlan(extents, int(halo), int(cells[at]), int(nbytes[at]),
                        scratch, tiles,
                        min(tiles, _SCRATCH_BLOCKS) if scratch else tiles)
    raise ValueError(f"a halo of {halo} cells leaves no tile of "
                     f"{values_per_cell} x {itemsize}-byte values (and "
                     f"{extra_bytes} B) per cell within "
                     f"{_SCRATCH_TILE_BYTES} bytes")
