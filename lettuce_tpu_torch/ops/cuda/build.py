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
dtype and storage (:data:`DTYPES`, :data:`STORAGE`), the cell-flat
geometry of the single-step kernels (:func:`plan_cells`: K1, with the
divisors of its thread index and the cells a thread of a masked 16-bit
launch owns), and the columns of the marched blocked kernels
(:func:`plan_march`: K2, periodic or masked, and K4, with their schedule
:func:`march_steps`).
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

from ... import tracing
from ...stencil import D2Q9, D3Q15, D3Q19, D3Q27

__all__ = ["SOURCES", "find_nvcc", "library_path", "ptxas_log",
           "build_libraries",
           "open_library", "check_launch", "kernel_stencil_name",
           "launch_dims", "check_out", "KERNEL_STENCILS",
           "KERNEL_STENCIL_NAMES", "DTYPES", "STORAGE", "HALF_DTYPES",
           "storage_suffix", "compute_dtype", "TILE_SMEM_BYTES",
           "sm_budget", "moving_axes", "tile_stride", "MarchPlan",
           "plan_march", "march_candidates", "march_steps", "ring_depths",
           "ring_keep", "march_values", "march_bytes", "march_threads",
           "is_row", "BLOCK", "DIVISIONS", "CELL_COUNTS", "SHIPPED_CELLS",
           "TIMED_CELLS", "MIN_BLOCKS", "CellPlan", "magic_of",
           "plan_cells", "cells_of", "min_blocks_of"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
# csrc/<name>.cu, one library each: the BGK step (K1a, K1d, K1b), its
# adjoint (K3a, K3c), the other collision fragments (K1c, with emit-u
# instances), their adjoints (K3b, K3d's streaming transpose), and the
# 16-bit forward instances of BGK and of each fragment source (K1e, K1f,
# and K1d on a 16-bit state), the blocked forward of BGK and of each
# fragment source in every storage (K2), the blocked adjoint (K4), the
# adjoints of a 16-bit state (K3 and K4 at 16 bits), and the velocity
# moment of Flow.u with its adjoint (K5)
SOURCES = ("stream_collide", "adjoint", "collide_basic", "collide_moments",
           "collide_mrt", "collide_kbc", "adjoint_fragments",
           "half_stream_collide", "half_basic", "half_moments", "half_mrt",
           "half_kbc", "multi_stream_collide", "multi_basic",
           "multi_moments", "multi_mrt", "multi_kbc", "adjoint_multi",
           "adjoint_half", "adjoint_multi_half", "moments")
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
# the buffers of the blocked kernels (csrc/multi_sweep.cuh): the dynamic
# shared memory a block may opt into on sm_90 (227 KB) and an SM's 228 KB,
# of which the runtime reserves 1 KB per block (F9: k blocks share an SM
# when each takes at most sm_budget(k)); when no buffer fits, a global
# scratch of at most _SCRATCH_TILE_BYTES per block with _SCRATCH_BLOCKS
# blocks looping over the units
TILE_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
_SCRATCH_TILE_BYTES = 4 << 20
_SCRATCH_BLOCKS = 264
# the marched kernels' columns: an H100 SXM's SMs (the planner fills them
# in whole waves), the cross-section interiors and cells a plan considers,
# and the segment counts along the march axis
SMS = 132
_MAX_CROSS = 1024
_MAX_CROSS_CELLS = 1 << 14
_MAX_SEGMENTS = 64


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
            tracing.count("library_built")
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
    with tracing.span("load"):
        lib = ctypes.CDLL(str(build_libraries()[name]))
        lib.lt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lt_cuda_error_string.restype = ctypes.c_char_p
        tracing.count("library_opened")
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


def sm_budget(blocks: int) -> int:
    """The bytes each of ``blocks`` blocks may take for k of them to share
    an SM (F9): k x (bytes + 1 KB) <= 228 KB; one block, 227 KB."""
    if blocks == 1:
        return TILE_SMEM_BYTES
    return SM_SMEM_BYTES // blocks - 1024


def tile_stride(nbytes: int) -> int:
    """A block's share of a blocked launch's global scratch: its buffer's
    bytes rounded up to 16 (csrc/multi_sweep.cuh's tile_stride)."""
    return -(-int(nbytes) // 16) * 16


# ----------------------------------------------------------------------
# the march of K2 (periodic and masked) and of K4 (csrc/multi_sweep.cuh,
# csrc/adjoint_multi.cuh)
# ----------------------------------------------------------------------
def march_values(q: int, d: int, n_sub: int, adjoint: bool = False,
                 keep: int = 0) -> int:
    """The ring values per cross-section cell of a marched block: K2 keeps
    n_sub rings of 2 q values (the compact ring: a population is kept 1, 2
    or 3 planes as it moves -1, 0, +1 along the march axis), ``keep`` more
    per ring when a masked launch freezes populations (:func:`ring_keep`);
    K4 (``adjoint``) 2 (n_sub - 1) such rings (the replay's post-collision
    values, the cotangents) and the u rings of levels 0 .. n_sub - 2,
    2 (n_sub - 1 - k) + 1 planes of d values each."""
    if adjoint:
        return 2 * (n_sub - 1) * 2 * q + (n_sub * n_sub - 1) * d
    return n_sub * (2 * q + keep)


def ring_depths(e, sign: int = 1, frozen: bool = False) -> tuple:
    """The planes a ring keeps of each population of the stencil ``e``:
    2 + sign e_m, e_m its component along the march axis (the first axis of
    the 3D launch grid it moves along); sign +1 for a forward level's
    post-collision values, -1 for a backward level's cotangents. A forward
    ring of a masked launch with ``frozen`` populations keeps the
    populations with e_m = -1 two planes: a frozen one reads its own plane
    after the next plane was written."""
    e3 = np.asarray(e)
    if e3.shape[1] == 2:
        e3 = np.concatenate([np.zeros((e3.shape[0], 1), int), e3], axis=1)
    axis = moving_axes(e).index(True)
    return tuple(int(2 + sign * x + (frozen and x == -1))
                 for x in e3[:, axis])


def ring_keep(e) -> int:
    """The values a forward ring of a frozen masked launch keeps more per
    cross cell than the compact ring: one per population with e_m = -1
    (csrc/multi_sweep.cuh's ring_keep)."""
    return sum(ring_depths(e, frozen=True)) - sum(ring_depths(e))


def march_steps(n_sub: int, planes: int, adjoint: bool = False) -> list:
    """The order of one marched segment of ``planes`` stored planes, as the
    kernels run it (csrc/multi_sweep.cuh's march_units, adjoint_multi.cuh's
    adjoint_units): per march step a list of phases ``(kind, level,
    plane)``, a barrier after each, planes local to the segment (plane 0
    is its first stored plane less the march halo: n_sub for K2,
    2 (n_sub - 1) for K4).

    K2: ``("collide", k, s - k)`` for k = 0 .. n_sub - 1 (level 0 reads the
    launch input, level k pulls population q from level k - 1's ring at
    plane - e_m), then ``("store", n_sub, s - n_sub)``, which pulls from
    level n_sub - 1's ring. K4 (``adjoint``): ``("replay", k, s - k)`` for
    k = 0 .. n_sub - 2 (pulling as K2's levels; it also keeps u), then
    ``("top", n_sub - 1, s - n_sub + 1)`` (the last u, and g pulled from
    device memory at plane + e_m into the cotangent ring of level
    n_sub - 1), ``("adjoint", kk, s - 2 (n_sub - 1) + kk)`` for
    kk = n_sub - 2 .. 1 (pulling level kk + 1's cotangent at plane + e_m),
    and ``("store", 0, s - 2 (n_sub - 1))``, which writes out; at n_sub 1
    only ``("top", 0, s)``, which reads the launch input itself and writes
    out. A phase appears only on the planes it computes: a level's planes
    shrink by one at each end per level away from the input (K2's level
    k: k .. planes + 2 n_sub - 1 - k)."""
    steps = []
    if not adjoint:
        last = planes + 2 * n_sub - 1
        for s in range(last + 1):
            phases = [("collide", k, s - k) for k in range(n_sub)
                      if k <= s - k <= last - k]
            if n_sub <= s - n_sub < n_sub + planes:
                phases.append(("store", n_sub, s - n_sub))
            steps.append(phases)
        return steps
    lead = 2 * (n_sub - 1)
    last = planes + 2 * lead - 1
    for s in range(last + 1):
        if n_sub == 1:
            steps.append([("top", 0, s)])
            continue
        phases = [("replay", k, s - k) for k in range(n_sub - 1)
                  if k <= s - k <= last - k]
        top = s - (n_sub - 1)
        if n_sub - 1 <= top <= last - (n_sub - 1):
            phases.append(("top", n_sub - 1, top))
        for kk in range(n_sub - 2, 0, -1):
            plane = s - lead + kk
            if lead - kk <= plane <= lead + planes - 1 + kk:
                phases.append(("adjoint", kk, plane))
        if lead <= s - lead < lead + planes:
            phases.append(("store", 0, s - lead))
        steps.append(phases)
    return steps


def march_bytes(cells: int, values_per_cell: int, itemsize: int,
                mask_rows: int = 0, frozen: bool = False) -> int:
    """The buffer of a marched block (csrc/multi_sweep.cuh's march_bytes
    and march_layout): ``values_per_cell`` ring values of ``itemsize``
    bytes per cross cell, rounded up to 8 bytes, then each cross cell's
    8-byte grid offset; a masked launch adds ``mask_rows`` rows of a 1-byte
    code per cross cell and, with ``frozen`` populations, as many rows of
    4-byte frozen bits (4-byte aligned)."""
    codes = -(-cells * values_per_cell * itemsize // 8) * 8 + 8 * cells
    if not frozen:
        return codes + mask_rows * cells
    return -(-(codes + mask_rows * cells) // 4) * 4 + 4 * mask_rows * cells


def march_threads(q: int, itemsize: int, adjoint: bool = False,
                  masked_row: bool = False) -> int:
    """The most threads a marched block of a stencil with ``q``
    populations takes in a compute type of ``itemsize`` bytes (its
    ``__launch_bounds__``): K2 512 for float32 compute on up to 19
    populations, else 256 (csrc/multi_sweep.cuh's kMarchThreads); K4
    (``adjoint``) 256 (csrc/adjoint_multi.cuh's kAdjointThreads); a masked
    K2 on a 2D grid (``masked_row``) 256 (kMaskedThreads)."""
    if masked_row:
        return 256
    return 512 if itemsize == 4 and q <= 19 and not adjoint else 256


class MarchPlan(NamedTuple):
    """The columns of one marched launch (K2, K4): the march
    ``axis`` of the 3D launch grid; ``interior``, what the C entry takes
    as (b0, b1, b2): the cross-section's interior on the two cross axes
    and the ``segment``'s planes on the march axis; the ``halo`` on the
    cross axes the stencil moves along and the ``march_halo`` planes
    collided before and after a segment; the cross-section's ``cells``,
    the buffer ``bytes`` per block (:func:`march_bytes`: rings, grid
    offsets and a masked launch's mask rows); whether it lives in a global
    ``scratch`` (else shared memory within the budget of ``blocks_per_sm``
    blocks per SM, :func:`sm_budget`; 0 with a scratch); the
    ``units`` (columns times segments), the ``blocks`` launched and their
    ``threads``; ``share``, the stored cells per level-0 collision (the
    cross-section's interior share times the segment's share of the
    planes it loads)."""
    axis: int
    interior: tuple
    segment: int
    halo: int
    march_halo: int
    cells: int
    bytes: int
    scratch: bool
    blocks_per_sm: int
    units: int
    blocks: int
    threads: int
    share: float


# the budgets of a marched block, (blocks per SM, threads): two blocks of
# 256 per SM (F9), one of march_threads, a global scratch (0)
_MARCH_BUDGETS = ((2, 256), (1, None), (0, None))
# the budgets of a masked launch whose cross-section is a row (a 2D grid):
# its buffer is small enough for several blocks per SM, whose levels hide
# one another's loads; threads sized to the row. The planner's model counts
# loads, not the latency the other blocks hide, so it cannot rank these:
# the first that fits is the default, six blocks of 128, within 7 % of the
# fastest candidate on the 2048^2 and obstacle launches at x2 and x4 where
# each other budget lost 9-25 % on one of them (chip_smoke.py phase 35
# times them all; PERF.md §6)
_ROW_BUDGETS = ((6, 128), (8, 128), (4, 128), (3, 256), (2, 256))


def is_row(dims: tuple, moving: tuple) -> bool:
    """Whether a march over the launch grid ``dims`` has a row for its
    cross-section: the first cross axis is one the stencil does not move
    along (a 2D grid [1, X, Y], marched along X)."""
    axis = moving.index(True)
    cross = [a for a in range(3) if a != axis]
    return not moving[cross[0]]


def _march_table(dims, moving, halo, march_halo, values_per_cell, itemsize,
                 per_sm, threads, sms, mask_rows=0, frozen=False,
                 by_thread=False):
    """Every (cross-section, segment) of one budget (``per_sm`` blocks per
    SM, :func:`sm_budget`; 0: a global scratch) with its modelled time,
    best first: a list of (est, plan). The model: whole waves of
    ``sms * per_sm`` blocks (a scratch launch's _SCRATCH_BLOCKS), each wave
    a unit's level-0 collisions (cells times loaded planes; with
    ``by_thread``, the cells rounded up to whole passes of the block's
    threads) ``per_sm`` times over, and a row of the fastest cross axis
    costing one 32-byte sector more than its bytes."""
    budget = _SCRATCH_TILE_BYTES if per_sm == 0 else sm_budget(per_sm)
    axis = moving.index(True)
    cross = [a for a in range(3) if a != axis]
    halos = [halo if moving[a] else 0 for a in cross]
    n_m = int(dims[axis])
    b = np.meshgrid(*[np.arange(1, min(int(dims[a]), _MAX_CROSS) + 1)
                      for a in cross], indexing="ij")
    b0, b1 = b[0].ravel(), b[1].ravel()
    cells = (b0 + 2 * halos[0]) * (b1 + 2 * halos[1])
    nbytes = march_bytes(cells, values_per_cell, itemsize, mask_rows, frozen)
    fits = (nbytes <= budget) & (cells <= _MAX_CROSS_CELLS)
    if not fits.any():
        return []
    b0, b1, cells, nbytes = b0[fits], b1[fits], cells[fits], nbytes[fits]
    work = -(-cells // threads) * threads if by_thread else cells
    columns = (-(-int(dims[cross[0]]) // b0)) * (-(-int(dims[cross[1]]) // b1))
    segments = np.unique(-(-n_m // np.arange(1, min(n_m, _MAX_SEGMENTS) + 1)))
    slots = sms * per_sm if per_sm else _SCRATCH_BLOCKS
    row = (b1 + 2 * halos[1]) * itemsize
    rows = []
    for seg in segments:
        units = columns * (-(-n_m // int(seg)))
        loaded = cells * (int(seg) + 2 * march_halo)
        est = ((-(-units // slots)) * max(per_sm, 1) * work
               * (int(seg) + 2 * march_halo) * (1 + 32 / row))
        share = b0 * b1 * min(int(seg), n_m) / loaded
        rows.append((est, share, units, np.full_like(units, int(seg))))
    est, share, units, seg = (np.concatenate(x) for x in zip(*rows))
    k = len(segments)
    b0, b1, cells, nbytes = (np.tile(x, k) for x in (b0, b1, cells, nbytes))
    order = np.lexsort((units, -share, est))
    table = []
    for i in order[:256]:
        interior = [0, 0, 0]
        interior[axis] = int(seg[i])
        interior[cross[0]], interior[cross[1]] = int(b0[i]), int(b1[i])
        plan = MarchPlan(axis, tuple(interior), int(seg[i]), int(halo),
                         int(march_halo), int(cells[i]), int(nbytes[i]),
                         per_sm == 0, per_sm, int(units[i]),
                         min(int(units[i]), _SCRATCH_BLOCKS) if per_sm == 0
                         else int(units[i]), int(threads), float(share[i]))
        table.append((float(est[i]), plan))
    return table


def _cross(plan: MarchPlan) -> tuple:
    """A plan's cross-section interior, the march axis's entry dropped."""
    return tuple(b for a, b in enumerate(plan.interior) if a != plan.axis)


def _row_values(plan: MarchPlan) -> int:
    """The values of a cross-section row along the fastest cross axis (the
    last cross axis, which the stencil moves along)."""
    fastest = [a for a in range(3) if a != plan.axis][1]
    return plan.interior[fastest] + 2 * plan.halo


@functools.lru_cache(maxsize=256)
def march_candidates(dims: tuple, moving: tuple, halo: int, march_halo: int,
                     values_per_cell: int, itemsize: int, q: int,
                     adjoint: bool = False, sms: int = SMS,
                     masked: bool = False, frozen: bool = False,
                     rows: bool = None) -> tuple:
    """The plans a marched launch over the launch grid ``dims`` may take
    (:func:`plan_march`'s arguments), the planner's default first.

    Per budget that fits (two blocks of 256 threads per SM, or one block
    of :func:`march_threads`; a global scratch only when no shared-memory
    plan fits): its best plan by the model, its best with rows of fewer
    than 32 values on the fastest cross axis and its best with rows of at
    least 32 (whole 32-byte sectors in float32), and its best
    cross-section cut into at least twice the units; with one block per SM
    of more than 256 threads, its best plan also at 256; sorted by the
    model.

    With ``rows`` (by default a ``masked`` launch whose cross-section is a
    row, :func:`is_row`): per row budget (3-8 blocks of 128 or 256 threads
    per SM) its best plan by the model, counting the cells in whole passes
    of the block's threads, in the order of the budgets (the first is the
    default); the budgets above only when none fits. A masked launch's
    buffer holds n_sub + 1 (``halo`` + 1) mask rows, with ``frozen``
    populations their bits too (:func:`march_bytes`). Raises ValueError
    when no plan holds the halo."""
    dims = tuple(int(n) for n in dims)
    moving = tuple(moving)
    max_threads = march_threads(int(q), int(itemsize), bool(adjoint),
                                bool(masked) and is_row(dims, moving))
    mask_rows = int(halo) + 1 if masked else 0
    if rows is None:
        rows = masked and is_row(dims, moving)

    def table(per_sm, threads, by_thread=False):
        return _march_table(dims, moving, int(halo), int(march_halo),
                            int(values_per_cell), int(itemsize), per_sm,
                            threads, int(sms), mask_rows, bool(frozen),
                            by_thread)

    if rows:
        found = [plans[0][1] for per_sm, threads in _ROW_BUDGETS
                 if threads <= max_threads
                 for plans in [table(per_sm, threads, True)] if plans]
        if found:
            return tuple(found)
    found = []
    for per_sm, threads in _MARCH_BUDGETS:
        if per_sm == 0 and found:
            break
        threads = threads or max_threads
        plans = table(per_sm, threads)
        if not plans:
            continue
        best = plans[0][1]
        picks = [plans[0]]
        for narrow in (True, False):
            picked = [r for r in plans
                      if (_row_values(r[1]) < 32) == narrow]
            if picked and picked[0] not in picks:
                picks.append(picked[0])
        split = [r for r in plans if _cross(r[1]) == _cross(best)
                 and r[1].units >= 2 * best.units]
        if split:
            picks.append(split[0])
        found += picks
        if threads > 256:
            found.append((plans[0][0] * 1.5, best._replace(threads=256)))
    if not found:
        raise ValueError(f"a halo of {halo} cells leaves no march of "
                         f"{values_per_cell} x {itemsize}-byte values per "
                         f"cross-section cell within "
                         f"{_SCRATCH_TILE_BYTES} bytes")
    found.sort(key=lambda r: r[0])
    return tuple(plan for _, plan in found)


def plan_march(dims: tuple, moving: tuple, halo: int, march_halo: int,
               values_per_cell: int, itemsize: int, q: int,
               adjoint: bool = False, sms: int = SMS, masked: bool = False,
               frozen: bool = False) -> MarchPlan:
    """The columns of a marched launch (K2, periodic or ``masked`` with
    ``frozen`` populations or without; K4 when ``adjoint``) of a stencil
    of ``q`` populations over the launch grid ``dims`` (n0, n1, n2):
    ``moving`` says on which axes the stencil moves (the march takes the
    first; the other two, the cross axes, get the ``halo`` where it
    moves), ``march_halo`` planes are collided before and after each
    segment, and each cross-section cell holds ``values_per_cell`` ring
    values of ``itemsize`` bytes (:func:`march_values`), its grid
    offset and a masked launch's mask rows (:func:`march_bytes`); a block
    takes up to :func:`march_threads` (K4's when ``adjoint``). Of the
    cross-sections and segment lengths that fit two blocks' share of an
    SM's shared memory, or all a block may take, it takes the one the
    model deems fastest (:func:`march_candidates`: whole waves over
    ``sms`` SMs, the level-0 collisions of a unit, a sector per row); when
    none fits, a global scratch. A masked launch on a 2D grid takes the
    first row budget that fits (several blocks per SM). Raises ValueError
    when no plan holds the halo."""
    return march_candidates(tuple(int(n) for n in dims), tuple(moving),
                            int(halo), int(march_halo), int(values_per_cell),
                            int(itemsize), int(q), bool(adjoint), int(sms),
                            bool(masked), bool(frozen))[0]


# ----------------------------------------------------------------------
# the cell-flat launch of the single-step kernels (K1,
# csrc/stream_collide.cuh)
# ----------------------------------------------------------------------
BLOCK = 128  # threads a block (csrc/stencils.cuh's kBlock)
_MAX_BLOCKS = 2 ** 31 - 1  # CUDA's limit on gridDim.x
# how a thread finds its row: a multiply by a magic number, 32-bit division
# (both while the grid has fewer than 2^31 cells), 64-bit division
# (csrc/stream_collide.cuh's Division)
DIVISIONS = ("magic", "div32", "div64")
# the cells a thread of a masked 16-bit launch may own
# (csrc/stream_collide.cuh's masked_cells_kernel; 1 is the one-cell kernel)
CELL_COUNTS = (1, 2, 4)
# the cells a thread of a masked 16-bit launch owns, per (stencil, storage)
# (csrc/half_storage.cuh's kShippedCells): the fastest of 1, 2 and 4 on
# the obstacles (chip_smoke.py phase 36, PERF.md)
SHIPPED_CELLS = {(name, suffix): {"d2q9": 4, "d3q15": 2, "d3q19": 4,
                                  "d3q27": 2}[name]
                 for name in KERNEL_STENCIL_NAMES
                 for suffix in STORAGE.values()}
# the fragments whose masked 16-bit instances compile every cell count, for
# chip_smoke.py phase 36 to time (csrc's TimedCells)
TIMED_CELLS = ("bgk", "bgk_force")
# (fragment, stencil, entry suffix) -> (periodic, masked, compiled): the
# minimum blocks per SM of an instance's __launch_bounds__ where phase 36
# times them (csrc's BlockChoices): the fastest on hermite27's rows; 1
# (none) elsewhere
MIN_BLOCKS = {("mrt_hermite27", "d3q27", "f32"): (4, 3, (1, 2, 3, 4))}


class CellPlan(NamedTuple):
    """The geometry of one single-step launch (K1) over the launch grid
    ``dims`` (n0, n1, n2): a flat line of ``blocks`` blocks of ``block``
    threads over the grid's n0 n1 rows, ``row_threads`` = ceil(n2 /
    ``cells``) threads a row; thread t owns ``cells`` consecutive cells of
    row t // row_threads from k0 = cells (t mod row_threads), and the
    ``threads`` first threads own cells. ``vectors``: a masked 16-bit
    launch moves each population's cells as one aligned vector (every row
    starts on the alignment, nothing frozen, the tensors aligned), else
    element by element. ``division`` says how a thread finds its row and
    column (:data:`DIVISIONS`), by (``row_magic``, ``row_shift``) and
    (``n1_magic``, ``n1_shift``) for "magic" (:func:`magic_of`, 0
    otherwise); ``min_blocks`` picks the instance's ``__launch_bounds__``
    minimum of blocks per SM."""
    dims: tuple
    cells: int
    vectors: bool
    row_threads: int
    threads: int
    blocks: int
    block: int
    division: str
    row_magic: int
    row_shift: int
    n1_magic: int
    n1_shift: int
    min_blocks: int

    def geometry(self) -> np.ndarray:
        """The int64 array a C entry takes (csrc/stream_collide.cuh's
        GeometryField order), read-only and made once per plan."""
        return _geometry(self)


@functools.lru_cache(maxsize=1024)
def _geometry(plan: CellPlan) -> np.ndarray:
    array = np.array([plan.cells, int(plan.vectors), plan.blocks,
                      plan.block, plan.row_threads,
                      DIVISIONS.index(plan.division), plan.row_magic,
                      plan.row_shift, plan.n1_magic, plan.n1_shift,
                      plan.min_blocks], dtype=np.int64)
    array.flags.writeable = False
    return array


def magic_of(d: int) -> tuple:
    """(m, s) with floor(x / d) == (x m) >> s for every 0 <= x < 2^31:
    s = 31 + ceil(log2 d), m = ceil(2^s / d) < 2^32 (Granlund and
    Montgomery 1994, theorem 4.2: m d - 2^s < d <= 2^(s - 31))."""
    d = int(d)
    if d < 1:
        raise ValueError(f"a divisor must be positive, got {d}")
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


@functools.lru_cache(maxsize=1024)
def plan_cells(dims: tuple, cells: int = 1, aligned: bool = True,
               frozen: bool = False, division: str = None,
               min_blocks: int = 1) -> CellPlan:
    """The cell-flat geometry of a single-step launch over the launch grid
    ``dims`` with ``cells`` cells a thread (:class:`CellPlan`): vectors
    when ``cells`` > 1 divides n2, the tensors are ``aligned`` to them and
    nothing is ``frozen``; ``division`` "magic" by default below 2^31
    cells, "div64" from there (the only one it allows there). Raises
    ValueError on a grid past CUDA's grid limit. Cached: a launch plans
    once per grid."""
    n0, n1, n2 = (int(n) for n in dims)
    if min(n0, n1, n2) < 1 or cells not in CELL_COUNTS:
        raise ValueError(f"no single-step launch of {cells} cells a thread "
                         f"over the grid {dims}")
    n = n0 * n1 * n2
    small = n < 2 ** 31
    if division is None:
        division = "magic" if small else "div64"
    if division not in DIVISIONS or (division != "div64" and not small):
        raise ValueError(f"division {division!r} needs fewer than 2^31 "
                         f"cells, the grid {dims} has {n}")
    row_threads = -(-n2 // cells)
    threads = n0 * n1 * row_threads
    blocks = -(-threads // BLOCK)
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"the grid {dims} needs {blocks} blocks, past "
                         f"CUDA's {_MAX_BLOCKS}")
    row_magic = row_shift = n1_magic = n1_shift = 0
    if division == "magic":
        row_magic, row_shift = magic_of(row_threads)
        n1_magic, n1_shift = magic_of(n1)
    vectors = cells > 1 and n2 % cells == 0 and aligned and not frozen
    return CellPlan((n0, n1, n2), int(cells), bool(vectors), row_threads,
                    threads, blocks, BLOCK, division, row_magic, row_shift,
                    n1_magic, n1_shift, int(min_blocks))


def cells_of(fragment: str, stencil: str, suffix: str,
             masked: bool) -> tuple:
    """(shipped, compiled): the cells a thread of a single-step launch of
    ``fragment`` on ``stencil`` with the entry ``suffix`` owns, and every
    count its instance is compiled for: a masked 16-bit launch
    :data:`SHIPPED_CELLS` (every count of :data:`CELL_COUNTS` for
    :data:`TIMED_CELLS`), any other one cell."""
    if not masked or suffix not in STORAGE.values():
        return 1, (1,)
    shipped = SHIPPED_CELLS[stencil, suffix]
    if fragment in TIMED_CELLS:
        return shipped, CELL_COUNTS
    return shipped, (shipped,)


def min_blocks_of(fragment: str, stencil: str, suffix: str,
                  masked: bool) -> tuple:
    """(shipped, compiled): the minimum blocks per SM of the periodic or
    ``masked`` instance's ``__launch_bounds__`` (:data:`MIN_BLOCKS`; 1,
    none, elsewhere)."""
    periodic, masked_m, compiled = MIN_BLOCKS.get(
        (fragment, stencil, suffix), (1, 1, (1,)))
    return (masked_m if masked else periodic), compiled
