"""The marched blocked kernels of lettuce_tpu_torch on the CPU: the periodic
K2 and K4 march a column along the grid's slowest moving axis with a
rolling window of planes per level (csrc/multi_sweep.cuh,
csrc/adjoint_multi.cuh). What runs here is everything around the CUDA
code:

* the planner's budgets (``build.plan_march``): every plan fits two
  blocks' share of an SM, or one block's 227 KB, or else says it runs in a
  global scratch; at full width it stores at least as much per loaded
  cell as the cube tile it replaced (:func:`cube_share`);
* the schedule (``build.march_steps``, the kernels' documented order):
  walked with tagged ring slots for n_sub 1-4 and segments shorter and
  longer than the warm-up, every read must find the (level, plane) the
  plain n_sub steps read there;
* the march executed with real data in plain torch, slot by slot and cell
  by cell, against lettuce_tpu's blocked Pallas kernel in interpret mode
  (float64, 1e-12);
* the wrappers hand the C entries the plan's geometry (a recording stub
  stands in for the library). The masked march has its own file,
  tests/test_torch_masked_march.py.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` phases
26-28, 34 and 35 hold them to their plain versions there. The file takes
about 25 s in one process, most of it the slot-by-slot march and
lettuce_tpu's interpret-mode kernel."""

import warnings

import numpy as np
import pytest
import torch

import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda import build
from lettuce_tpu_torch.stencil import D2Q9, D3Q15, D3Q19, D3Q27

STENCILS = {"D2Q9": D2Q9, "D3Q15": D3Q15, "D3Q19": D3Q19, "D3Q27": D3Q27}
# the launch grids of each stencil: the main path's and the 2D cells'
# full width, phase 26's grid, and one smaller than the deepest halo
GRIDS = {2: [(2048, 2048), (64, 96), (8, 8)],
         3: [(256, 256, 256), (30, 34, 36), (8, 8, 8)]}
FULL_WIDTH = {(2048, 2048), (256, 256, 256)}
# itemsize of the rings: float32 and the 16-bit states (float32 rings),
# float64
ITEMSIZES = {"float32": 4, "bfloat16": 4, "float64": 8}
TWO_BLOCKS = 228 * 1024  # an SM's shared memory; 1 KB reserved per block


def launch_grid(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


def k2_plan(stencil, shape, span, itemsize):
    return build.plan_march(launch_grid(shape), build.moving_axes(stencil.e),
                            span, span,
                            build.march_values(stencil.q, stencil.d, span),
                            itemsize, stencil.q)


def k4_plan(stencil, shape, span, itemsize):
    return build.plan_march(launch_grid(shape), build.moving_axes(stencil.e),
                            ad.adjoint_multi_halo(span), 2 * (span - 1),
                            build.march_values(stencil.q, stencil.d, span,
                                               adjoint=True), itemsize,
                            stencil.q, adjoint=True)


def cube_share(dims, moving, halo, q, itemsize):
    """The interior share of the cube tile the blocked kernel ran before
    the march: of the interiors up to 32 x 32 x 128,
    the largest share of its tile whose q values per cell fit two blocks
    per SM, else one block, else a 4 MB scratch."""
    halos = [halo if m else 0 for m in moving]
    b = np.meshgrid(*[np.arange(1, min(int(n), cap) + 1)
                      for n, cap in zip(dims, (32, 32, 128))], indexing="ij")
    cells = np.prod([x + 2 * h for x, h in zip(b, halos)], axis=0)
    share = np.prod(b, axis=0) / cells
    for budget in (build.sm_budget(2), build.TILE_SMEM_BYTES, 4 << 20):
        fits = cells * q * itemsize <= budget
        if fits.any():
            return float(share[fits].max())
    return 0.0


def fits_budget(plan):
    """The plan's bytes (rings and grid offsets) and threads fit the
    budget it names: two blocks of 256 threads per SM beside the 1 KB the
    runtime reserves per block, one block, or a global scratch."""
    if plan.scratch:
        return plan.blocks_per_sm == 0 and plan.bytes <= 4 << 20
    if plan.blocks_per_sm == 2:
        return (2 * (plan.bytes + 1024) <= TWO_BLOCKS
                and plan.threads == 256)
    return plan.blocks_per_sm == 1 and plan.bytes <= build.TILE_SMEM_BYTES


# ----------------------------------------------------------------------
# (a) the budgets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("span", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(STENCILS))
def test_march_plan_fits_its_budget(name, span, dtype):
    """Every K2 and K4 plan fits the budget it names, covers the grid with
    its units, and (K2, at full width) stores at least as many cells per
    level-0 collision as the cube tile stores per tile cell."""
    stencil = STENCILS[name]()
    itemsize = ITEMSIZES[dtype]
    for shape in GRIDS[stencil.d]:
        dims = launch_grid(shape)
        for kind, plan in (("K2", k2_plan(stencil, shape, span, itemsize)),
                           ("K4", k4_plan(stencil, shape, span, itemsize))):
            what = f"{kind} {name} {shape} x{span} {dtype}: {plan}"
            assert fits_budget(plan), what
            assert plan.threads <= build.march_threads(stencil.q, itemsize,
                                                       kind == "K4")
            values = build.march_values(stencil.q, stencil.d, span,
                                        kind == "K4")
            assert plan.bytes == build.march_bytes(plan.cells, values,
                                                   itemsize), what
            assert plan.axis == build.moving_axes(stencil.e).index(True)
            assert plan.interior[plan.axis] == plan.segment
            units = int(np.prod([-(-n // b)
                                 for n, b in zip(dims, plan.interior)]))
            assert plan.units == units and 1 <= plan.blocks <= units, what
            if kind == "K2" and shape in FULL_WIDTH:
                cube = cube_share(dims, build.moving_axes(stencil.e), span,
                                  stencil.q, itemsize)
                assert plan.share >= cube, (what, cube)


def test_march_plan_without_shared_memory_takes_the_scratch():
    """A column no shared-memory budget holds (K4 float64 D3Q27 at span
    4: 369 values of 8 bytes per cross cell, a halo of 6) runs in a global
    scratch, and the plan says so; the smallest cross-section would have
    needed more than a block may take."""
    stencil = D3Q27()
    plan = k4_plan(stencil, (256, 256, 256), 4, 8)
    assert plan.scratch and plan.blocks_per_sm == 0 and fits_budget(plan)
    halo = ad.adjoint_multi_halo(4)
    smallest = build.march_bytes((1 + 2 * halo) ** 2,
                                 build.march_values(27, 3, 4, True), 8)
    assert smallest > build.TILE_SMEM_BYTES
    # the same launch at span 2 fits shared memory
    assert not k4_plan(stencil, (256, 256, 256), 2, 8).scratch


def test_span_beyond_every_march_raises():
    """A span whose halo no march holds raises with the halo's size."""
    with pytest.raises(ValueError, match="halo of 40"):
        k2_plan(D3Q19(), (8, 8, 8), 40, 4)


def test_march_candidates_offer_both_budgets_at_full_width():
    """Phase 35's candidates for the main path (D3Q19 256^3 float32 at
    span 2): the default first, both shared-memory budgets, rows narrower
    and wider than a sector, a cross-section cut into more segments."""
    stencil = D3Q19()
    plans = build.march_candidates(
        (256, 256, 256), build.moving_axes(stencil.e), 2, 2,
        build.march_values(19, 3, 2), 4, 19)
    assert plans[0] == k2_plan(stencil, (256, 256, 256), 2, 4)
    assert plans[0].threads == 512
    assert {p.blocks_per_sm for p in plans} == {1, 2}
    assert plans[0]._replace(threads=256) in plans
    rows = {p.interior[2] + 2 * p.halo >= 32 for p in plans}
    assert rows == {True, False}
    assert any(p.units >= 2 * plans[0].units
               and p.interior[1:] == plans[0].interior[1:] for p in plans)
    assert all(fits_budget(p) for p in plans)


# ----------------------------------------------------------------------
# (b) the schedule, walked with tagged ring slots
# ----------------------------------------------------------------------
def march_stencil(stencil):
    """The (march, fastest cross) components of each population."""
    e = np.asarray(stencil.e)
    e3 = np.concatenate([np.zeros((len(e), 3 - e.shape[1]), int), e], 1)
    axis = build.moving_axes(stencil.e).index(True)
    return e3[:, axis], e3[:, 2]


class Rings:
    """Tagged slots: ring -> {(slot, cross cell): (level, plane)}."""

    def __init__(self, stencil, sign):
        self.em, self.ec = march_stencil(stencil)
        self.depth = build.ring_depths(stencil.e, sign)
        self.base = np.concatenate([[0], np.cumsum(self.depth)[:-1]])
        assert sum(self.depth) == 2 * stencil.q
        self.slots = {}

    def slot(self, q, plane):
        return int(self.base[q] + plane % self.depth[q])

    def write(self, level, plane, cells):
        for q in range(len(self.depth)):
            for c in cells:
                self.slots[level, self.slot(q, plane), c] = (level, plane)

    def read(self, level, plane, cells, sign):
        """Population q of each cell: the value level ``level`` computed on
        plane ``plane - sign e_m`` at cell ``c - sign e_c``."""
        for q in range(len(self.depth)):
            src = plane - sign * self.em[q]
            for c in cells:
                cell = c - sign * self.ec[q]
                got = self.slots.get((level, self.slot(q, src), cell))
                assert got == (level, src), (level, plane, q, c, got)


def region(width, distance):
    return range(distance, width - distance)


@pytest.mark.parametrize("planes", [1, 2, 3, 9])
@pytest.mark.parametrize("n_sub", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["D2Q9", "D3Q19", "D3Q27"])
def test_k2_schedule_reads_what_the_plain_steps_read(name, n_sub, planes):
    """K2: level k at (plane i, cell c) pulls population q from level
    k - 1 at (i - e_m, c - e_c); the store pulls from level n_sub - 1;
    every plane of the segment is stored once, after level 0 loaded the
    segment and n_sub planes on either side."""
    stencil = STENCILS[name]()
    rings = Rings(stencil, 1)
    interior = 3
    width = interior + 2 * n_sub
    stored, loaded = [], []
    for phases in build.march_steps(n_sub, planes):
        for kind, level, plane in phases:
            if kind == "collide":
                cells = region(width, level)
                if level == 0:
                    loaded.append(plane)
                else:
                    rings.read(level - 1, plane, cells, 1)
                rings.write(level, plane, cells)
            else:
                assert kind == "store" and level == n_sub
                rings.read(n_sub - 1, plane, region(width, n_sub), 1)
                stored.append(plane - n_sub)
    assert stored == list(range(planes))
    assert loaded == list(range(planes + 2 * n_sub))


@pytest.mark.parametrize("planes", [1, 2, 3, 9])
@pytest.mark.parametrize("n_sub", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["D2Q9", "D3Q19", "D3Q27"])
def test_k4_schedule_reads_what_the_plain_adjoint_reads(name, n_sub,
                                                        planes):
    """K4: the replay pulls as K2 and keeps u; backward level kk at (plane
    i, cell c) pulls the cotangent of level kk + 1 at (i + e_m, c + e_c)
    and level kk's u at (i, c) from a ring of 2 (n_sub - 1 - kk) + 1
    planes; level 0 stores each plane of the segment once."""
    stencil = STENCILS[name]()
    fwd, cot = Rings(stencil, 1), Rings(stencil, -1)
    halo = ad.adjoint_multi_halo(n_sub)
    lead = 2 * (n_sub - 1)
    width = 3 + 2 * halo
    u = {}
    stored = []
    loaded = []

    def read_u(level, plane, cells):
        depth = 2 * (n_sub - 1 - level) + 1
        for c in cells:
            assert u.get((level, plane % depth, c)) == (level, plane)

    for phases in build.march_steps(n_sub, planes, adjoint=True):
        for kind, level, plane in phases:
            if kind == "replay":
                if level == 0:
                    loaded.append(plane)
                cells = region(width, level)
                if level > 0:
                    fwd.read(level - 1, plane, cells, 1)
                fwd.write(level, plane, cells)
                depth = 2 * (n_sub - 1 - level) + 1
                for c in cells:
                    u[level, plane % depth, c] = (level, plane)
            elif kind == "top":
                assert level == n_sub - 1
                if n_sub == 1:
                    stored.append(plane)
                    continue
                cells = region(width, halo - level)
                fwd.read(level - 1, plane, cells, 1)
                cot.write(level, plane, cells)
            elif kind == "adjoint":
                cells = region(width, halo - level)
                cot.read(level + 1, plane, cells, -1)
                read_u(level, plane, cells)
                cot.write(level, plane, cells)
            else:
                assert kind == "store" and level == 0
                cells = region(width, halo)
                cot.read(1, plane, cells, -1)
                read_u(0, plane, cells)
                stored.append(plane - lead)
    assert stored == list(range(planes))
    if n_sub > 1:
        assert loaded == list(range(planes + 4 * (n_sub - 1)))


# ----------------------------------------------------------------------
# (c) the march with real data against lettuce_tpu's blocked kernel
# ----------------------------------------------------------------------
def march_plain(f, spec, stencil, n_sub, plan):
    """The periodic K2 march of ``plan`` in plain torch: per unit, the
    schedule of :func:`build.march_steps`, each level's post-collision
    values in its compact ring (``build.ring_depths``), populations pulled
    from slot ``base_q + (plane - e_m) % depth_q`` and cross cell
    ``c - e``, level 0 read from the wrapped grid, the store from the top
    ring; the collision is the plain per-cell map (``collide_plain``)."""
    e, w, opp, cs = stencil.e, stencil.w, stencil.opposite, stencil.cs
    x = f.reshape(f.shape[0], *launch_grid(f.shape[1:]))
    dims = x.shape[1:]
    axis = plan.axis
    cross = [a for a in range(3) if a != axis]
    moving = build.moving_axes(e)
    halos = [plan.halo if moving[a] else 0 for a in cross]
    e3 = np.concatenate([np.zeros((len(e), 3 - len(e[0])), int),
                         np.asarray(e)], 1)
    depth = build.ring_depths(e)
    base = np.concatenate([[0], np.cumsum(depth)[:-1]])
    dim = [plan.interior[a] + 2 * h for a, h in zip(cross, halos)]
    out = torch.full_like(x, float("nan"))
    for o_m in range(0, dims[axis], plan.segment):
        n_planes = min(plan.segment, dims[axis] - o_m)
        for o0 in range(0, dims[cross[0]], plan.interior[cross[0]]):
            for o1 in range(0, dims[cross[1]], plan.interior[cross[1]]):
                g0 = (o0 - halos[0] + np.arange(dim[0])) % dims[cross[0]]
                g1 = (o1 - halos[1] + np.arange(dim[1])) % dims[cross[1]]
                rings = torch.full((n_sub, 2 * len(e), dim[0], dim[1]),
                                   float("nan"), dtype=x.dtype)
                for phases in build.march_steps(n_sub, n_planes):
                    for kind, level, plane in phases:
                        lo = [level if h else 0 for h in halos]
                        if kind == "store":
                            lo = halos
                        r0 = np.arange(lo[0], dim[0] - lo[0])
                        r1 = np.arange(lo[1], dim[1] - lo[1])
                        if kind == "collide" and level == 0:
                            xm = (o_m - n_sub + plane) % dims[axis]
                            at = [None] * 3
                            at[axis] = xm
                            at[cross[0]] = g0[r0][:, None]
                            at[cross[1]] = g1[r1][None, :]
                            fv = x[:, at[0], at[1], at[2]]
                        else:
                            src = level - 1
                            fv = torch.stack([
                                rings[src, base[q] + (plane - e3[q, axis])
                                      % depth[q]][
                                    (r0 - e3[q, cross[0]])[:, None],
                                    (r1 - e3[q, cross[1]])[None, :]]
                                for q in range(len(e))])
                        if kind == "store":
                            keep0 = o0 + r0 - halos[0] < dims[cross[0]]
                            keep1 = o1 + r1 - halos[1] < dims[cross[1]]
                            at = [None] * 3
                            at[axis] = o_m + plane - n_sub
                            at[cross[0]] = (o0 + r0 - halos[0])[keep0][:, None]
                            at[cross[1]] = (o1 + r1 - halos[1])[keep1][None, :]
                            out[:, at[0], at[1], at[2]] = \
                                fv[:, keep0][:, :, keep1]
                            continue
                        post = sc.collide_plain(fv, spec, e, w, opp, cs)
                        for q in range(len(e)):
                            rings[level, base[q] + plane % depth[q],
                                  r0[:, None], r1[None, :]] = post[q]
    return out.reshape(f.shape)


def march_case(name, shape, interior, n_sub, seed):
    """A float64 BGK state near equilibrium and the march of ``interior``
    (the segment's planes on the march axis)."""
    stencil = STENCILS[name]()
    axis = build.moving_axes(stencil.e).index(True)
    plan = build.MarchPlan(axis, tuple(interior), interior[axis], n_sub,
                           n_sub, 0, 0, False, 1, 0, 0, 256, 0.0)
    rng = np.random.default_rng(seed)
    wq = np.asarray(stencil.w).reshape(-1, *([1] * len(shape)))
    f = wq * (1 + 1e-2 * rng.standard_normal((stencil.q, *shape)))
    return stencil, plan, f


@pytest.mark.parametrize("name,shape,interior,n_sub", [
    ("D3Q19", (16, 16, 128), (7, 6, 50), 2),
    ("D3Q19", (16, 16, 128), (16, 5, 128), 4),
    ("D2Q9", (32, 256), (1, 13, 100), 4),
    ("D2Q9", (32, 256), (1, 32, 256), 2)])
def test_march_plain_matches_lettuce_tpu_blocked_kernel(name, shape,
                                                        interior, n_sub):
    """The march, executed slot by slot with float64 BGK data (partial
    columns and segments), equals lettuce_tpu's
    ``fused_stream_collide(n_sub=)`` in interpret mode (at the grids its
    Pallas kernel takes, tests/test_torch_multi_step.py's) to 1e-12."""
    import jax.numpy as jnp
    stencil, plan, f = march_case(name, shape, interior, n_sub, 17 + n_sub)
    tau_inv = 1 / 0.8
    got = march_plain(torch.as_tensor(f), ("bgk", tau_inv), stencil, n_sub,
                      plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fused_stream_collide(
            jnp.asarray(f), np.asarray(stencil.e), np.asarray(stencil.w),
            np.asarray(stencil.opposite), stencil.cs, tau_inv,
            n_sub=n_sub, interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


@pytest.mark.parametrize("name,shape,interior,n_sub", [
    ("D3Q19", (5, 3, 7), (2, 2, 3), 4),
    ("D3Q27", (4, 6, 5), (3, 4, 2), 3),
    ("D2Q9", (3, 5), (1, 2, 2), 4)])
def test_march_plain_on_a_grid_narrower_than_the_halo(name, shape,
                                                      interior, n_sub):
    """The march on a grid narrower than its halo along every axis (the
    periodic wrap loads a plane or a cell several times) equals n_sub
    plain steps (``stream_collide_plain``) to 1e-12."""
    stencil, plan, f = march_case(name, shape, interior, n_sub, 5)
    x = torch.as_tensor(f)
    args = (stencil.e, stencil.w, stencil.opposite, stencil.cs, 1 / 0.8)
    got = march_plain(x, ("bgk", 1 / 0.8), stencil, n_sub, plan)
    want = sc.stream_collide_plain(x, *args, n_sub=n_sub)
    assert (got - want).abs().max().item() <= 1e-12


# ----------------------------------------------------------------------
# (d) the wrappers hand the C entries the plan's geometry
# ----------------------------------------------------------------------
class Recorder:
    """A stand-in for a loaded library: every entry records its
    arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class Stream:
    cuda_stream = 0


@pytest.fixture
def recorder(monkeypatch):
    lib = Recorder()
    monkeypatch.setattr(sc, "load_multi_library", lambda source: lib)
    monkeypatch.setattr(ad, "load_multi_library", lambda half=False: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return lib


@pytest.mark.parametrize("dtype,dev", [(torch.float32, False),
                                       (torch.float64, False),
                                       (torch.bfloat16, True)])
@pytest.mark.parametrize("n_sub", [2, 4])
def test_periodic_k2_launch_takes_the_march_plan(recorder, n_sub, dtype,
                                                 dev):
    """A periodic K2 launch hands the entry the grid, n_sub, the march
    plan's interior (the segment on the march axis), blocks and threads,
    and a
    null scratch when the plan runs in shared memory; a given plan (a
    phase-35 candidate) replaces the default."""
    stencil = D3Q19()
    f = torch.zeros((19, 12, 10, 14), dtype=dtype)
    spec = sc.pack_spec(("bgk", 1.2), stencil.e, stencil.w,
                        stencil.opposite)
    plan = sc.march_plan(f, stencil.e, n_sub)
    assert plan == k2_plan(stencil, (12, 10, 14), n_sub,
                           8 if dtype == torch.float64 else 4)
    suffix = build.storage_suffix(dtype, dev)
    itemsize = 8 if dtype == torch.float64 else 4
    for given in (None, build.march_candidates(
            (12, 10, 14), (True,) * 3, n_sub, n_sub,
            build.march_values(19, 3, n_sub), itemsize, 19)[-1]):
        recorder.calls.clear()
        sc._launch_multi(f, None, spec, n_sub, stencil.e, stencil.cs, dev,
                         plan=given)
        ((name, args),) = recorder.calls
        want = plan if given is None else given
        assert name == f"lt_multi_bgk_d3q19_{suffix}"
        assert args[2] is None and args[3:8] == (None,) * 5
        assert args[8:12] == (12, 10, 14, n_sub)
        assert args[12:17] == (*want.interior, want.blocks, want.threads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sub", [2, 3])
def test_k4_launch_takes_the_march_plan(recorder, n_sub, dtype):
    """A K4 launch hands the entry the grid, n_sub, the halo
    max(n_sub, 2 (n_sub - 1)), the march plan's interior, blocks and
    threads."""
    stencil = D3Q19()
    f = torch.zeros((19, 9, 11, 10), dtype=dtype)
    g = torch.zeros_like(f)
    out = torch.empty_like(f)
    spec = sc.pack_spec(("bgk", 1.2), stencil.e, stencil.w,
                        stencil.opposite)
    ad._launch_adjoint_multi(f, g, out, spec, n_sub, stencil.e, stencil.cs)
    ((name, args),) = recorder.calls
    plan = k4_plan(stencil, (9, 11, 10), n_sub, 4)
    assert name == f"lt_adjoint_multi_bgk_d3q19_{build.storage_suffix(dtype)}"
    assert args[:3] == (f.data_ptr(), g.data_ptr(), out.data_ptr())
    assert args[3] is None or plan.scratch
    assert args[4:9] == (9, 11, 10, n_sub, ad.adjoint_multi_halo(n_sub))
    assert args[9:14] == (*plan.interior, plan.blocks, plan.threads)
