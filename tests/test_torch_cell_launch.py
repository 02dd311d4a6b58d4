"""The cell-flat launch of lettuce_tpu_torch's single-step kernels (K1:
csrc/stream_collide.cuh's stream_collide_kernel, masked_stream_collide_kernel
and masked_cells_kernel) on the CPU. What runs here is everything around
the CUDA code:

* the host plan (``build.plan_cells``): the kernels' thread -> (row, first
  cell) arithmetic, replayed in numpy with the planned magic numbers, 32-bit
  and 64-bit division, covers every cell of the grid exactly once; the
  threads that own no cell come after all that do, no block is idle, and
  a grid of 2^31 cells or more is planned with 64-bit division;
* the magic numbers: floor(x / d) == (x m) >> s for every dividend the
  kernels give them;
* the push of the masked 16-bit kernel with several cells a thread, walked
  store by store in numpy as the kernel issues it (the vectors, the warp
  shuffles, the values stored alone at a warp's edge and at the row's
  periodic wrap, the element-wise path of frozen populations and of rows
  that the cell count does not divide): every (population, cell) is
  written exactly once, with the value of cell x - e_q (x itself where
  the population is frozen);
* the wrapper hands each C entry the planned geometry (a recording stub
  stands in for the library), and the geometry array's order is the one
  csrc/stream_collide.cuh reads.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
every instance to its plain version there (phases 2, 9, 13, 19, 22, 32 and
36). The tests that hold the port's plain step against lettuce_tpu are in
the other ``test_torch_*`` files. The file takes a few seconds."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu_torch.ops.cuda import build
from lettuce_tpu_torch.stencil import D2Q9, D3Q19, D3Q27

CSRC = Path(build.__file__).resolve().parents[2] / "csrc"
WARP = 32


# ----------------------------------------------------------------------
# (a) the host plan covers the grid
# ----------------------------------------------------------------------
def thread_cells(plan: build.CellPlan, t: np.ndarray, division=None):
    """(i, j, k0) of threads ``t`` as csrc/stream_collide.cuh's
    thread_cells computes them under the plan's division."""
    division = division or plan.division
    n0, n1, n2 = plan.dims
    t = t.astype(np.uint64)
    if division == "magic":
        row = (t * np.uint64(plan.row_magic)) >> np.uint64(plan.row_shift)
        i = (row * np.uint64(plan.n1_magic)) >> np.uint64(plan.n1_shift)
    else:
        row = t // np.uint64(plan.row_threads)
        i = row // np.uint64(n1)
    j = row - i * np.uint64(n1)
    k0 = (t - row * np.uint64(plan.row_threads)) * np.uint64(plan.cells)
    return i.astype(np.int64), j.astype(np.int64), k0.astype(np.int64)


SHAPES = [(1, 1, 1), (1, 64, 96), (30, 34, 36), (96, 48, 48),
          (320, 160, 160), (1, 2048, 1024), (256, 256, 256)]
COVERAGE = ([(dims, 1) for dims in SHAPES]
            + [(dims, c) for dims in SHAPES[:4] + [(1, 2048, 1024)]
               for c in (2, 4)])


@pytest.mark.parametrize("dims,cells", COVERAGE)
def test_plan_covers_every_cell_once(dims, cells):
    """Every cell of the grid belongs to exactly one thread, the same
    under the magic numbers, 32-bit and 64-bit division; the threads that
    own cells are the first ``threads`` of the launch, so only the last
    warp that owns cells can be partial (a whole idle warp, in the last
    block, ends at once), and no block is idle."""
    plan = build.plan_cells(dims, cells)
    n0, n1, n2 = dims
    assert plan.block == build.BLOCK == 128
    assert plan.row_threads == -(-n2 // cells)
    assert plan.threads == n0 * n1 * plan.row_threads
    assert plan.blocks == -(-plan.threads // plan.block)
    assert (plan.blocks - 1) * plan.block < plan.threads
    assert plan.division == "magic"
    assert plan.vectors == (cells > 1 and n2 % cells == 0)
    t = np.arange(plan.threads, dtype=np.int64)
    i, j, k0 = thread_cells(plan, t)
    for division in ("div32", "div64"):
        for a, b in zip((i, j, k0), thread_cells(plan, t, division)):
            assert np.array_equal(a, b)
    assert i.min() >= 0 and i.max() < n0 and j.max() < n1
    assert np.all(k0 < n2) and np.all(k0 % cells == 0)
    covered = np.zeros(n0 * n1 * n2, np.int64)
    for e in range(cells):
        k = k0 + e
        inside = k < n2
        np.add.at(covered, ((i * n1 + j) * n2 + k)[inside], 1)
    assert np.all(covered == 1)
    idle = plan.blocks * plan.block - plan.threads
    assert 0 <= idle < plan.block
    # a row of n2 cells per block (the replaced launch) left idle all but
    # n2 of 128 threads per row; here only the tail of the last block
    last_warp = (plan.threads - 1) // WARP
    assert all(w * WARP + WARP <= plan.threads for w in range(last_warp))


def test_plan_past_2_31_cells_uses_64_bit_division():
    """A grid of 2^31 cells or more is planned with 64-bit division only
    (no magic numbers), its 64-bit thread -> cell arithmetic exact at the
    ends of the grid; the 32-bit divisions are refused there."""
    dims = (2048, 2048, 1024)  # 2^32 cells
    plan = build.plan_cells(dims)
    assert plan.division == "div64"
    assert (plan.row_magic, plan.row_shift, plan.n1_magic,
            plan.n1_shift) == (0, 0, 0, 0)
    assert plan.threads == 2 ** 32 and plan.blocks == 2 ** 25
    t = np.array([0, 1, 1023, 1024, 2 ** 31, 2 ** 32 - 1], dtype=np.int64)
    i, j, k0 = thread_cells(plan, t)
    flat = (i * 2048 + j) * 1024 + k0
    assert np.array_equal(flat, t)
    assert build.plan_cells((2048, 2048, 1024), 2).blocks == 2 ** 24
    for division in ("magic", "div32"):
        with pytest.raises(ValueError):
            build.plan_cells(dims, division=division)
    assert build.plan_cells((2, 1024, 1024 * 1024 - 1)).division == "magic"


def test_plan_refuses_a_grid_past_the_block_limit():
    with pytest.raises(ValueError):
        build.plan_cells((65535, 65535, 65535))
    with pytest.raises(ValueError):
        build.plan_cells((4, 4, 4), cells=3)


# ----------------------------------------------------------------------
# (b) the magic numbers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 3, 7, 9, 36, 48, 96, 160, 256, 512,
                               1023, 1024, 2047, 65535, 2 ** 20 + 1,
                               2 ** 30 + 3, 2 ** 31 - 1])
def test_magic_numbers_divide_every_dividend_below_2_31(d):
    """(m, s) = magic_of(d): m < 2^32, the bound m d - 2^s in [0, 2^(s -
    31)] of the theorem, and floor(x / d) == (x m) >> s on the ends of the
    range, around every multiple of d near them and on 200,000 random x."""
    m, s = build.magic_of(d)
    assert 0 < m < 2 ** 32 and 31 <= s <= 62
    assert 0 <= m * d - 2 ** s <= 2 ** (s - 31)
    top = 2 ** 31 - 1
    rng = np.random.default_rng(d)
    multiples = np.concatenate([np.arange(0, 64) * d,
                                top // d * d - np.arange(0, 64) * d])
    xs = np.concatenate([np.arange(4096), top - np.arange(4096),
                         multiples, multiples - 1, multiples + 1,
                         rng.integers(0, 2 ** 31, 200_000)])
    xs = xs[(xs >= 0) & (xs <= top)].astype(np.uint64)
    got = (xs * np.uint64(m)) >> np.uint64(s)
    assert np.array_equal(got, xs // np.uint64(d))


# ----------------------------------------------------------------------
# (c) the push of several cells a thread, store by store
# ----------------------------------------------------------------------
def e3(stencil) -> np.ndarray:
    """The velocities on the kernels' 3D launch grid ([1, X, Y] in 2D)."""
    e = np.asarray(stencil.e)
    if e.shape[1] == 2:
        e = np.concatenate([np.zeros((e.shape[0], 1), int), e], axis=1)
    return e


def walk_push(stencil, dims, cells, nsm=None, alone=True):
    """Every store masked_cells_kernel issues for one launch of ``cells``
    cells a thread over ``dims`` (with the frozen populations ``nsm``,
    [q, n] bool), each post-collision value standing for the cell it was
    computed at: ``(plan, written, source)``, the times each (population,
    cell) of the output was written and the cell whose value it holds.
    ``alone=False`` drops the values stored alone (a broken kernel)."""
    plan = build.plan_cells(dims, cells, frozen=nsm is not None)
    assert plan.cells == cells
    n0, n1, n2 = dims
    n = n0 * n1 * n2
    q = stencil.q
    written = np.zeros((q, n), np.int64)
    source = np.full((q, n), -1, np.int64)

    def store(p, where, pos, value):
        np.add.at(written[p], pos[where], 1)
        source[p, pos[where]] = value[where]

    t = np.arange(plan.blocks * plan.block, dtype=np.int64)
    lane = t % WARP
    t = t[t - lane < plan.threads]  # a warp past the owners ends at once
    lane = t % WARP
    active = t < plan.threads
    i, j, k0 = thread_cells(plan, np.minimum(t, plan.threads - 1))
    row = (i * n1 + j) * n2
    # the cells each thread owns; a cell past the row's end is the row's
    # last, computed and never stored
    own = [row + np.minimum(k0 + e, n2 - 1) for e in range(cells)]
    owned = np.minimum(n2 - k0, cells)
    for p, (ex, ey, ez) in enumerate(e3(stencil)):
        base = (((i + ex) % n0) * n1 + (j + ey) % n1) * n2
        if plan.vectors:
            head = (lane == 0) | (k0 == 0)
            tail = (lane == WARP - 1) | (k0 + cells == n2)
            if ez == 0:
                for e in range(cells):
                    store(p, active, base + k0 + e, own[e])
            elif ez == 1:
                # __shfl_up_sync: lane - 1's last value, lane 0 its own
                below = np.where(lane > 0, np.roll(own[-1], 1), own[-1])
                vector = [below] + own[:-1]
                for e in range(cells):
                    store(p, active & ~head, base + k0 + e, vector[e])
                for e in range(cells - 1):
                    store(p, active & head, base + k0 + 1 + e, own[e])
                store(p, active & tail & alone,
                      base + np.where(k0 + cells == n2, 0, k0 + cells),
                      own[-1])
            else:
                # __shfl_down_sync: lane + 1's first value, lane 31 its own
                above = np.where(lane < WARP - 1, np.roll(own[0], -1),
                                 own[0])
                vector = own[1:] + [above]
                for e in range(cells):
                    store(p, active & ~tail, base + k0 + e, vector[e])
                for e in range(1, cells):
                    store(p, active & tail, base + k0 + e - 1, own[e])
                store(p, active & head & alone,
                      base + np.where(k0 == 0, n2 - 1, k0 - 1), own[0])
            continue
        for e in range(cells):
            mine = active & (e < owned)
            k = k0 + e
            dst = base + (k + ez) % n2
            if nsm is None:
                store(p, mine, dst, own[e])
                continue
            here = own[e]
            store(p, mine & nsm[p, here], here, own[e])
            store(p, mine & ~nsm[p, dst], dst, own[e])
    return plan, written, source


def pushed_from(stencil, dims, nsm=None):
    """The cell whose value lands at each (population, cell) in one plain
    step: x - e_q, periodic; x itself where the population is frozen."""
    n0, n1, n2 = dims
    idx = np.arange(n0 * n1 * n2).reshape(dims)
    want = np.stack([np.roll(idx, tuple(e), axis=(0, 1, 2)).ravel()
                     for e in e3(stencil)])
    if nsm is not None:
        want = np.where(nsm, np.arange(idx.size)[None], want)
    return want


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("n2", [1, 2, 3, 31, 32, 33, 64, 65, 2048])
@pytest.mark.parametrize("cells", [2, 4])
@pytest.mark.parametrize("stencil", [D2Q9, D3Q19, D3Q27],
                         ids=lambda s: s.__name__)
def test_push_of_several_cells_writes_each_output_once(stencil, cells, n2,
                                                       frozen):
    """The masked 16-bit kernel's stores, walked as the kernel issues them
    for every lane of every warp: vectors when ``cells`` divides the row
    and nothing is frozen (the population moving along the row assembled
    from the lane's own values and the neighbouring lane's by a shuffle,
    stored alone where it crosses a warp's edge or wraps around the row),
    element-wise otherwise (a row's last thread owning n2 mod cells
    cells; store_masked's frozen test). Each output is written exactly
    once, with the plain step's value."""
    stencil = stencil()
    dims = (1, 5, n2) if stencil.d == 2 else (3, 4, n2)
    nsm = None
    if frozen:
        nsm = np.random.default_rng(n2 * cells).random(
            (stencil.q, int(np.prod(dims)))) < 0.3
    plan, written, source = walk_push(stencil, dims, cells, nsm)
    assert plan.vectors == (n2 % cells == 0 and not frozen)
    assert np.all(written == 1)
    assert np.array_equal(source, pushed_from(stencil, dims, nsm))


@pytest.mark.parametrize("cells", [2, 4])
def test_walk_finds_a_push_without_its_lone_values(cells):
    """The walk is sharp: without the values stored alone, the cells at
    every warp's edge and at the row's periodic wrap stay unwritten for
    each population moving along the row, and nothing else does."""
    stencil = D3Q19()
    dims = (2, 3, 256)
    plan, written, _ = walk_push(stencil, dims, cells, alone=False)
    assert plan.vectors
    moving = e3(stencil)[:, 2] != 0
    assert np.all(written[~moving] == 1)
    missing = written[moving] == 0
    assert np.all(written[moving] <= 1) and missing.any()
    k = np.arange(int(np.prod(dims))) % dims[2]
    per_warp = WARP * cells
    edges = (k % per_warp == 0) | (k % per_warp == per_warp - 1)
    assert np.all(edges[np.nonzero(missing)[1]])


# ----------------------------------------------------------------------
# (d) the wrapper hands each entry the planned geometry
# ----------------------------------------------------------------------
GEOMETRY_FIELDS = ["kCellsField", "kVectorsField", "kBlocksField",
                   "kThreadsField", "kRowThreadsField", "kDivisionField",
                   "kRowMagicField", "kRowShiftField", "kN1MagicField",
                   "kN1ShiftField", "kMinBlocksField"]


def test_geometry_order_is_the_kernels():
    """CellPlan.geometry() lists the fields in the order of
    csrc/stream_collide.cuh's GeometryField, which the C entries read."""
    text = (CSRC / "stream_collide.cuh").read_text()
    body = re.search(r"enum GeometryField : int \{(.*?)\};", text, re.S)
    names = re.findall(r"\b(k\w+Field)\b", body.group(1))
    assert names == GEOMETRY_FIELDS
    divisions = re.search(r"enum Division : int \{(.*?)\};", text, re.S)
    assert re.findall(r"\b(k\w+) = (\d)", divisions.group(1)) == [
        ("kMagic", "0"), ("kDiv32", "1"), ("kDiv64", "2")]
    assert build.DIVISIONS == ("magic", "div32", "div64")
    plan = build.plan_cells((3, 5, 64), 4, min_blocks=3)
    geometry = dict(zip(GEOMETRY_FIELDS, plan.geometry().tolist()))
    assert geometry == {
        "kCellsField": 4, "kVectorsField": 1, "kBlocksField": 2,
        "kThreadsField": 128, "kRowThreadsField": 16, "kDivisionField": 0,
        "kRowMagicField": plan.row_magic, "kRowShiftField": plan.row_shift,
        "kN1MagicField": plan.n1_magic, "kN1ShiftField": plan.n1_shift,
        "kMinBlocksField": 3}
    assert (plan.row_magic, plan.row_shift) == build.magic_of(16)
    assert (plan.n1_magic, plan.n1_shift) == build.magic_of(5)


def test_shipped_cells_are_the_ones_the_sources_compile():
    """build.SHIPPED_CELLS is csrc/half_storage.cuh's table of cells a
    thread per stencil and storage, and build.TIMED_CELLS the policies
    whose masked 16-bit instances compile every count (TimedCells)."""
    text = (CSRC / "half_storage.cuh").read_text()
    table = re.search(r"kShippedCells\[4\]\[3\] = \{(.*?)\};", text, re.S)
    rows = [[int(x) for x in re.findall(r"\d+", r)]
            for r in re.findall(r"\{([^{}]*)\}", table.group(1))]
    for r, name in zip(rows, build.KERNEL_STENCIL_NAMES):
        assert r == [build.SHIPPED_CELLS[name, s]
                     for s in ("bf16", "f16", "bf16_dev")]
    timed = re.findall(r"struct TimedCells<(\w+)<S, T>>",
                       "".join(p.read_text() for p in CSRC.glob("*.cu*")))
    assert sorted(timed) == ["Bgk", "BgkForce"]
    assert build.TIMED_CELLS == ("bgk", "bgk_force")
    assert all(c in build.CELL_COUNTS for c in build.SHIPPED_CELLS.values())


class Recorder:
    """A stand-in for a loaded library: every entry records its arguments
    and the geometry array it is handed, and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            # the geometry follows the grid's three extents
            at = next(k for k in range(len(args) - 2)
                      if all(isinstance(a, int) and not isinstance(a, bool)
                             for a in args[k:k + 3])
                      and args[k:k + 3] == self.dims)
            geometry = np.ctypeslib.as_array(
                (ctypes.c_int64 * len(GEOMETRY_FIELDS)).from_address(
                    args[at + 3])).copy()
            self.calls.append((name, args, geometry))
            return 0
        return entry


class Stream:
    cuda_stream = 0


@pytest.fixture
def recorder(monkeypatch):
    lib = Recorder()
    for loader in ("load_library", "load_fragment_library",
                   "load_half_library"):
        monkeypatch.setattr(sc, loader, lambda *source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return lib


STORAGES = {"f32": (torch.float32, False), "f64": (torch.float64, False),
            "bf16": (torch.bfloat16, False), "f16": (torch.float16, False),
            "bf16_dev": (torch.bfloat16, True)}


VARIANTS = [(False, False, False), (False, False, True),
            (True, False, False), (True, True, False), (True, False, True)]


@pytest.mark.parametrize("storage,masked,frozen,emit_u", [
    (storage, *variant) for storage in STORAGES for variant in VARIANTS
    if not (variant[2] and storage == "bf16_dev")])
@pytest.mark.parametrize("name,shape", [("D2Q9", (40, 24)),
                                        ("D3Q19", (6, 10, 33))])
def test_k1_launch_takes_the_cell_plan(recorder, name, shape, storage,
                                       masked, frozen, emit_u):
    """A single-step launch hands its entry the grid and the cell plan's
    geometry: one cell a thread periodic and in float32/float64; a masked
    16-bit launch the cells its stencil and storage ship, as vectors
    unless populations are frozen or the row is not a multiple of them; a
    given plan (a phase-36 candidate) replaces the default."""
    dtype, dev = STORAGES[storage]
    stencil = {"D2Q9": D2Q9, "D3Q19": D3Q19}[name]()
    f = torch.zeros((stencil.q, *shape), dtype=dtype)
    masks = {}
    if masked:
        masks = dict(ncm=torch.zeros(shape, dtype=torch.uint8),
                     table=[("collide", None)],
                     nsm=torch.zeros((stencil.q, *shape), dtype=torch.bool)
                     if frozen else None)
    u = (torch.zeros((stencil.d, *shape), dtype=build.compute_dtype(dtype))
         if emit_u else None)
    dims = build.launch_dims(f, stencil.e)
    recorder.dims = tuple(int(n) for n in dims)
    suffix = build.storage_suffix(dtype, dev)
    half = suffix in build.STORAGE.values()
    cells = build.SHIPPED_CELLS[name.lower(), suffix] if masked and half \
        else 1
    want = build.plan_cells(dims, cells, frozen=frozen)
    assert want.vectors == (cells > 1 and shape[-1] % cells == 0
                            and not frozen)
    spec = ("bgk", 1 / 0.6)
    candidate = sc.cell_plan(f, stencil.e, "bgk", masked, dev,
                             frozen=frozen, division="div32")
    for given in (None, candidate):
        recorder.calls.clear()
        sc._launch(f, None, u, spec, stencil.e, stencil.w,
                   stencil.opposite, stencil.cs, dev, plan=given, **masks)
        ((entry, args, geometry),) = recorder.calls
        variant = ("masked_" if masked else "") + ("emit_u_" if emit_u
                                                   else "")
        assert entry == f"lt_stream_collide_{variant}{name.lower()}_{suffix}"
        expected = want if given is None else given
        assert np.array_equal(geometry, expected.geometry())
        assert args[0] == f.data_ptr()
    assert candidate.division == "div32" and candidate.cells == want.cells


@pytest.mark.parametrize("suffix", ["bf16", "f16", "bf16_dev"])
def test_timed_fragment_takes_each_candidate(recorder, suffix):
    """The forced-BGK fragment (a phase-36 row) compiles every count of
    cells a thread: each candidate plan reaches its masked 16-bit entry,
    with vectors on a row of 2048 cells; a fragment that is not timed
    compiles the shipped count alone."""
    stencil = D2Q9()
    dtype, dev = STORAGES[suffix]
    f = torch.zeros((9, 8, 2048), dtype=dtype)
    ncm = torch.zeros((8, 2048), dtype=torch.uint8)
    recorder.dims = (1, 8, 2048)
    spec = ("bgk_force", 1 / 0.6, (1e-5, 0.0), 0.5, 1 - 1 / 1.2)
    assert build.cells_of("bgk_force", "d2q9", suffix, True)[1] == (1, 2, 4)
    assert build.cells_of("trt", "d2q9", suffix, True)[1] == (
        build.SHIPPED_CELLS["d2q9", suffix],)
    assert build.cells_of("trt", "d2q9", "f32", True) == (1, (1,))
    for cells in build.CELL_COUNTS:
        plan = sc.cell_plan(f, stencil.e, "bgk_force", True, dev,
                            cells=cells)
        assert plan.vectors == (cells > 1)
        recorder.calls.clear()
        sc._launch(f, None, None, spec, stencil.e, stencil.w,
                   stencil.opposite, stencil.cs, dev, ncm=ncm,
                   table=[("collide", None)], plan=plan)
        ((entry, _, geometry),) = recorder.calls
        assert entry == f"lt_collide_bgk_force_masked_d2q9_{suffix}"
        assert geometry[0] == cells and geometry[1] == int(cells > 1)


def test_misaligned_tensors_take_the_element_wise_path():
    """A state that does not start on the vectors' alignment (a view at
    an odd offset) is planned element by element."""
    stencil = D2Q9()
    whole = torch.zeros(9 * 8 * 64 + 1, dtype=torch.bfloat16)
    f = whole[1:].view(9, 8, 64)
    plan = sc.cell_plan(f, stencil.e, "bgk", True)
    assert plan.cells == build.SHIPPED_CELLS["d2q9", "bf16"]
    assert not plan.vectors
    aligned = sc.cell_plan(whole[:-1].view(9, 8, 64), stencil.e, "bgk", True)
    assert aligned.vectors == (plan.cells > 1)


def test_hermite27_plans_its_shipped_launch_bounds():
    """The float32 D3Q27 hermite27 instances compile each minimum of
    blocks per SM phase 36 times; the plan takes the shipped one, and
    every other instance one (none)."""
    f = torch.zeros((27, 4, 4, 4), dtype=torch.float32)
    for masked in (False, True):
        shipped, compiled = build.min_blocks_of("mrt_hermite27", "d3q27",
                                                "f32", masked)
        assert compiled == (1, 2, 3, 4) and shipped in compiled
        assert sc.cell_plan(f, D3Q27().e, "mrt_hermite27",
                            masked).min_blocks == shipped
        assert sc.cell_plan(f.double(), D3Q27().e, "mrt_hermite27",
                            masked).min_blocks == 1
        assert sc.cell_plan(f, D3Q27().e, "kbc", masked).min_blocks == 1
    text = (CSRC / "collide_mrt.cu").read_text()
    assert re.search(r"BlockChoices<MrtHermite<D3Q27, float>, Same<float>> "
                     r"\{\s*using type = Ints<1, 2, 3, 4>;", text)
