"""The masked march of lettuce_tpu_torch's blocked kernel (K2 with boundary
codes, the per-node field and frozen populations:
csrc/multi_sweep.cuh's masked_march_kernel) on the CPU. What runs here is
everything around the CUDA code:

* the schedule (``build.march_steps``, the kernels' order) walked with
  tagged ring slots and code rows: every pull, every frozen read of a
  population moving -1, 0 or +1 along the march axis and every code row
  must find the (level, plane) the plain n_sub steps read there; the
  compact ring without the kept plane loses a frozen value;
* the masked march executed with real data in plain torch, slot by slot
  (codes read into rows by level 0, the frozen select, every code kind,
  the per-node field), against lettuce_tpu's masked
  ``fused_stream_collide(n_sub=)`` in interpret mode (float64, 1e-12), and
  against n_sub plain steps on grids narrower than the halo;
* the planner's masked budgets: every plan fits k blocks per SM
  (k x (bytes + 1 KB) <= 228 KB, F9), 3-8 small blocks on a 2D row;
* the wrapper hands a masked entry the march plan (a recording stub
  stands in for the library).

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` phases 29-31
and 35 hold it to its plain version there. The file takes about 30 s in
one process, most of it lettuce_tpu's interpret-mode kernel."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda import build
from lettuce_tpu_torch.stencil import D2Q9, D3Q19
from tests.test_torch_bounded_kernel import JAX_KINDS, bounded_case
from tests.test_torch_march_plan import (STENCILS, launch_grid,
                                         march_stencil, recorder, region)

assert recorder  # the fixture, used by name below

SM_BYTES = 228 * 1024  # an SM's shared memory; 1 KB reserved per block


# ----------------------------------------------------------------------
# (a) the masked schedule, walked with tagged ring slots and code rows
# ----------------------------------------------------------------------
class MaskedRings:
    """Tagged forward rings of a frozen launch, ring slot -> (level,
    plane), and the mask rows, row -> plane."""

    def __init__(self, stencil, n_sub, keep=True):
        self.em, self.ec = march_stencil(stencil)
        self.depth = build.ring_depths(stencil.e, 1, frozen=keep)
        self.base = np.concatenate([[0], np.cumsum(self.depth)[:-1]])
        assert sum(self.depth) == 2 * stencil.q + (
            build.ring_keep(stencil.e) if keep else 0)
        self.rows = [None] * (n_sub + 1)
        self.slots = {}

    def slot(self, q, plane):
        return int(self.base[q] + plane % self.depth[q])

    def load(self, plane):
        """Level 0 reads the plane's codes and frozen bits into its row."""
        self.rows[plane % len(self.rows)] = plane

    def write(self, level, plane, cells):
        for q in range(len(self.depth)):
            for c in cells:
                self.slots[level, self.slot(q, plane), c] = (level, plane)

    def read(self, level, plane, cells):
        """Population q of each cell at ``plane``: pulled from level
        ``level`` at (plane - e_m, c - e_c), frozen from (plane, c); the
        row of the plane's masks. Returns the reads that missed."""
        assert self.rows[plane % len(self.rows)] == plane
        missed = []
        for q in range(len(self.depth)):
            src = plane - self.em[q]
            for c in cells:
                pulled = self.slots.get((level, self.slot(q, src),
                                         c - self.ec[q]))
                assert pulled == (level, src), (level, plane, q, c, pulled)
                frozen = self.slots.get((level, self.slot(q, plane), c))
                if frozen != (level, plane):
                    missed.append((level, plane, q, int(self.em[q])))
        return missed


def walk(stencil, n_sub, planes, keep=True):
    """The masked schedule of one segment; returns the stored planes, the
    loaded planes and the frozen reads that missed."""
    rings = MaskedRings(stencil, n_sub, keep)
    width = 3 + 2 * n_sub
    stored, loaded, missed = [], [], []
    for phases in build.march_steps(n_sub, planes):
        for kind, level, plane in phases:
            if kind == "collide":
                cells = region(width, level)
                if level == 0:
                    rings.load(plane)
                    loaded.append(plane)
                else:
                    missed += rings.read(level - 1, plane, cells)
                rings.write(level, plane, cells)
            else:
                assert kind == "store" and level == n_sub
                missed += rings.read(n_sub - 1, plane, region(width, n_sub))
                stored.append(plane - n_sub)
    return stored, loaded, missed


@pytest.mark.parametrize("planes", [1, 2, 3, 9])
@pytest.mark.parametrize("n_sub", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["D2Q9", "D3Q19", "D3Q27"])
def test_masked_schedule_reads_what_the_plain_steps_read(name, n_sub,
                                                         planes):
    """Level k at (plane i, cell c) pulls population q from level k - 1 at
    (i - e_m, c - e_c), a frozen one from (i, c), whatever its e_m; the
    store does so from level n_sub - 1; every level and the store read the
    code row of their own plane, which level 0 filled; every plane of the
    segment is stored once."""
    stored, loaded, missed = walk(STENCILS[name](), n_sub, planes)
    assert not missed
    assert stored == list(range(planes))
    assert loaded == list(range(planes + 2 * n_sub))


@pytest.mark.parametrize("name", ["D2Q9", "D3Q19", "D3Q27"])
def test_compact_ring_loses_frozen_values_moving_back(name):
    """Without the kept plane, a frozen population moving -1 along the
    march axis finds its own plane overwritten by the next one (so a
    frozen launch keeps that class two planes); the others are found."""
    stencil = STENCILS[name]()
    _, _, missed = walk(stencil, 2, 4, keep=False)
    assert missed and {em for *_, em in missed} == {-1}
    em, _ = march_stencil(stencil)
    assert {q for _, _, q, _ in missed} == set(np.flatnonzero(em == -1))


# ----------------------------------------------------------------------
# (b) the masked march with real data
# ----------------------------------------------------------------------
def masked_march_plain(f, spec, stencil, n_sub, interior, ncm, nsm, feq,
                       table):
    """The masked K2 march over columns of ``interior`` in plain torch:
    per unit the schedule of :func:`build.march_steps`; level 0 reads the
    wrapped grid and the plane's codes (and frozen bits) into row
    plane % (n_sub + 1); a level above and the store pull population q
    from slot ``base_q + (plane - e_m) % depth_q`` (the depths of
    ``build.ring_depths(frozen=)``) at cross cell ``c - e``, a frozen one
    from its own plane and cell; each level's cells run the plain
    pre-streaming map of their codes (``prestream_plain``: the collision or
    the replacement, the field read at the grid index)."""
    e, w, opp, cs = stencil.e, stencil.w, stencil.opposite, stencil.cs
    q = len(e)
    dims = launch_grid(f.shape[1:])
    x = f.reshape(q, *dims)
    codes = ncm.reshape(dims)
    field = feq.reshape(q, *dims)
    bits = None if nsm is None else nsm.reshape(q, *dims)
    moving = build.moving_axes(e)
    axis = moving.index(True)
    cross = [a for a in range(3) if a != axis]
    halos = [n_sub if moving[a] else 0 for a in cross]
    e3 = np.concatenate([np.zeros((q, 3 - len(e[0])), int),
                         np.asarray(e)], 1)
    depth = build.ring_depths(e, 1, frozen=bits is not None)
    base = np.concatenate([[0], np.cumsum(depth)[:-1]])
    dim = [interior[a] + 2 * h for a, h in zip(cross, halos)]
    rows = n_sub + 1
    out = torch.full_like(x, float("nan"))
    for o_m in range(0, dims[axis], interior[axis]):
        n_planes = min(interior[axis], dims[axis] - o_m)
        for o0 in range(0, dims[cross[0]], interior[cross[0]]):
            for o1 in range(0, dims[cross[1]], interior[cross[1]]):
                g0 = (o0 - halos[0] + np.arange(dim[0])) % dims[cross[0]]
                g1 = (o1 - halos[1] + np.arange(dim[1])) % dims[cross[1]]
                rings = torch.full((n_sub, sum(depth), *dim), float("nan"),
                                   dtype=x.dtype)
                code_rows = torch.zeros((rows, *dim), dtype=torch.uint8)
                bit_rows = torch.zeros((rows, q, *dim), dtype=torch.bool)
                row_plane = [None] * rows
                for phases in build.march_steps(n_sub, n_planes):
                    for kind, level, plane in phases:
                        lo = (halos if kind == "store"
                              else [level if h else 0 for h in halos])
                        r0 = np.arange(lo[0], dim[0] - lo[0])
                        r1 = np.arange(lo[1], dim[1] - lo[1])
                        at = [None] * 3
                        at[axis] = (o_m - n_sub + plane) % dims[axis]
                        at[cross[0]] = g0[r0][:, None]
                        at[cross[1]] = g1[r1][None, :]
                        row = plane % rows
                        if kind == "collide" and level == 0:
                            fv = x[:, at[0], at[1], at[2]]
                            code_rows[row] = codes[at[0], at[1], at[2]]
                            if bits is not None:
                                bit_rows[row] = bits[:, at[0], at[1], at[2]]
                            row_plane[row] = plane
                        else:
                            assert row_plane[row] == plane
                            src = level - 1
                            fv = torch.stack([
                                rings[src, base[p] + (plane - e3[p, axis])
                                      % depth[p]][
                                    (r0 - e3[p, cross[0]])[:, None],
                                    (r1 - e3[p, cross[1]])[None, :]]
                                for p in range(q)])
                            here = torch.stack([
                                rings[src, base[p] + plane % depth[p]][
                                    r0[:, None], r1[None, :]]
                                for p in range(q)])
                            frozen = bit_rows[row][:, r0[:, None],
                                                   r1[None, :]]
                            fv = torch.where(frozen, here, fv)
                        if kind == "store":
                            keep0 = o0 + r0 - halos[0] < dims[cross[0]]
                            keep1 = o1 + r1 - halos[1] < dims[cross[1]]
                            at[axis] = o_m + plane - n_sub
                            at[cross[0]] = (o0 + r0 - halos[0])[keep0][:, None]
                            at[cross[1]] = (o1 + r1 - halos[1])[keep1][None, :]
                            out[:, at[0], at[1], at[2]] = \
                                fv[:, keep0][:, :, keep1]
                            continue
                        post = sc.prestream_plain(
                            fv, spec, e, w, opp, cs,
                            ncm=code_rows[row][r0[:, None], r1[None, :]],
                            table=table,
                            feq_field=field[:, at[0], at[1], at[2]])
                        for p in range(q):
                            rings[level, base[p] + plane % depth[p],
                                  r0[:, None], r1[None, :]] = post[p]
    return out.reshape(f.shape)


def masked_case(name, shape, n_sub, frozen):
    """A float64 state near rest with every code kind (tests/
    test_torch_bounded_kernel.py's masks) as numpy, and its torch masks."""
    stencil = STENCILS[name]()
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 40 + n_sub,
                                           frozen)
    masks = dict(ncm=torch.as_tensor(ncm),
                 nsm=None if nsm is None else torch.as_tensor(nsm),
                 feq=torch.as_tensor(feq), table=table)
    return stencil, f, (ncm, nsm, feq, table), masks


@pytest.mark.parametrize("name,shape,interior,n_sub,frozen,spec", [
    ("D2Q9", (16, 128), (1, 5, 50), 2, True, ("bgk", 1 / 0.8)),
    ("D2Q9", (16, 128), (1, 7, 30), 4, True, ("bgk", 1 / 0.8)),
    ("D2Q9", (16, 128), (1, 16, 128), 2, False, ("trt", 0.8, 1.1)),
    ("D3Q19", (16, 16, 128), (7, 6, 50), 2, True, ("bgk", 1 / 0.8))])
def test_masked_march_matches_lettuce_tpu_masked_kernel(
        name, shape, interior, n_sub, frozen, spec):
    """The masked march, slot by slot in float64 (bounce back, a constant
    and a per-node equilibrium, identity; with ``frozen`` a frozen plane
    across the march axis and frozen odd populations; partial columns and
    segments), equals lettuce_tpu's ``fused_stream_collide(n_sub=)`` with
    the same masks in interpret mode to 1e-12."""
    stencil, f, (ncm, nsm, feq, table), masks = masked_case(
        name, shape, n_sub, frozen)
    got = masked_march_plain(torch.as_tensor(f), spec, stencil, n_sub,
                             interior, masks["ncm"], masks["nsm"],
                             masks["feq"], table)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fused_stream_collide(
            jnp.asarray(f), np.asarray(stencil.e), np.asarray(stencil.w),
            np.asarray(stencil.opposite), stencil.cs,
            spec[1] if spec[0] == "bgk" else None, collision_spec=spec,
            no_collision_mask=jnp.asarray(ncm),
            no_streaming_mask=None if nsm is None else jnp.asarray(nsm),
            boundary_kinds=JAX_KINDS,
            feq_boundary=(None, table[2][1], None, None),
            feq_field=jnp.asarray(feq), n_sub=n_sub, interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


@pytest.mark.parametrize("name,shape,interior,n_sub,frozen", [
    ("D3Q19", (5, 3, 7), (2, 2, 3), 4, True),
    ("D3Q27", (4, 6, 5), (3, 4, 2), 3, True),
    ("D2Q9", (3, 5), (1, 2, 2), 4, True),
    ("D2Q9", (6, 9), (1, 4, 5), 2, False)])
def test_masked_march_on_a_grid_narrower_than_the_halo(name, shape,
                                                       interior, n_sub,
                                                       frozen):
    """The masked march on a grid narrower than its halo (the wrap loads a
    plane, its codes and its frozen bits several times) equals n_sub plain
    masked steps (``stream_collide_plain``) to 1e-12."""
    stencil, f, _, masks = masked_case(name, shape, n_sub, frozen)
    x = torch.as_tensor(f)
    got = masked_march_plain(x, ("bgk", 1 / 0.7), stencil, n_sub, interior,
                             masks["ncm"], masks["nsm"], masks["feq"],
                             masks["table"])
    want = sc.stream_collide_plain(
        x, stencil.e, stencil.w, stencil.opposite, stencil.cs, 1 / 0.7,
        ncm=masks["ncm"], nsm=masks["nsm"], table=masks["table"],
        feq_field=masks["feq"], n_sub=n_sub)
    assert (got - want).abs().max().item() <= 1e-12


# ----------------------------------------------------------------------
# (c) the planner's masked budgets
# ----------------------------------------------------------------------
# the launch grids at full width: the 2048^2 cells (Poiseuille, Couette,
# cavity), the obstacle, the 3D main path's grid
FULL_WIDTH = {"2048x2048": (D2Q9, (1, 2048, 2048)),
              "obstacle": (D2Q9, (1, 2048, 1024)),
              "256^3": (D3Q19, (256, 256, 256))}


def masked_plans(stencil, dims, span, itemsize, frozen):
    keep = build.ring_keep(stencil.e) if frozen else 0
    values = build.march_values(stencil.q, stencil.d, span, keep=keep)
    plans = build.march_candidates(dims, build.moving_axes(stencil.e), span,
                                   span, values, itemsize, stencil.q,
                                   masked=True, frozen=frozen)
    return values, plans


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("span", [2, 3, 4])
@pytest.mark.parametrize("grid", sorted(FULL_WIDTH))
def test_masked_plan_fits_k_blocks_per_sm(grid, span, frozen, itemsize):
    """F9 per block: every masked candidate at full width fits the k
    blocks per SM it names, k x (bytes + 1 KB) <= 228 KB (one block: 227
    KB), its bytes the rings (one plane more of the e_m = -1 populations
    when frozen), the grid offsets and n_sub + 1 rows of codes (and of
    frozen bits); its threads at most the kernel's launch bound; its units
    cover the grid. A 2D row takes 2-8 blocks of 128 or 256 threads, the
    first row budget that fits (six of 128) by default."""
    make, dims = FULL_WIDTH[grid]
    stencil = make()
    values, plans = masked_plans(stencil, dims, span, itemsize, frozen)
    row = build.is_row(dims, build.moving_axes(stencil.e))
    assert row == (stencil.d == 2)
    for plan in plans:
        what = f"{grid} x{span} frozen={frozen} {itemsize} B: {plan}"
        assert not plan.scratch and plan.blocks_per_sm >= 1, what
        assert plan.blocks_per_sm * (plan.bytes + 1024) <= SM_BYTES or (
            plan.blocks_per_sm == 1
            and plan.bytes <= build.TILE_SMEM_BYTES), what
        assert plan.bytes == build.march_bytes(plan.cells, values, itemsize,
                                               span + 1, frozen), what
        assert plan.threads <= build.march_threads(stencil.q, itemsize,
                                                   masked_row=row)
        units = int(np.prod([-(-n // b) for n, b in zip(dims,
                                                        plan.interior)]))
        assert plan.units == units == plan.blocks, what
        if row:
            assert plan.blocks_per_sm in (2, 3, 4, 6, 8), what
            assert plan.threads in (128, 256) and plan.interior[0] == 1
    if row:
        assert (plans[0].blocks_per_sm, plans[0].threads) == (6, 128)
        assert len({p.blocks_per_sm for p in plans}) == len(plans) >= 4
    else:
        assert {p.blocks_per_sm for p in plans} <= {1, 2}


def test_masked_bytes_count_the_mask_rows():
    """A masked buffer adds n_sub + 1 rows of 1-byte codes to the
    periodic one's rings and grid offsets, and with frozen populations as
    many 4-byte-aligned rows of frozen bits and a kept plane of the
    e_m = -1 populations per level (D2Q9: 3 values)."""
    cells, span = 131, 2
    periodic = build.march_bytes(cells, build.march_values(9, 2, span), 4)
    assert periodic == cells * 18 * 2 * 4 + 8 * cells
    assert build.march_bytes(cells, build.march_values(9, 2, span), 4,
                             span + 1) == periodic + 3 * cells
    assert build.ring_keep(D2Q9().e) == 3 and build.ring_keep(
        D3Q19().e) == 5
    values = build.march_values(9, 2, span, keep=3)
    codes = cells * values * 4 + 8 * cells + 3 * cells
    assert build.march_bytes(cells, values, 4, span + 1, True) == (
        -(-codes // 4) * 4 + 4 * 3 * cells)


def test_periodic_2d_plan_keeps_its_budget():
    """The periodic 2D march keeps its plan (one block of 512 threads
    per SM); its row budgets are offered only when asked for (phase 35's
    record)."""
    stencil = D2Q9()
    args = ((1, 2048, 2048), build.moving_axes(stencil.e), 2, 2,
            build.march_values(9, 2, 2), 4, 9)
    plan = build.plan_march(*args)
    assert (plan.blocks_per_sm, plan.threads) == (1, 512)
    rows = build.march_candidates(*args, rows=True)
    assert rows[0].blocks_per_sm == 6 and rows[0].threads == 128
    assert plan not in rows


# ----------------------------------------------------------------------
# (d) the wrapper hands a masked entry the march plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,dev", [(torch.float32, False),
                                       (torch.float64, False),
                                       (torch.bfloat16, True)])
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name,shape", [("D2Q9", (40, 24)),
                                        ("D3Q19", (12, 10, 14))])
def test_masked_k2_launch_takes_the_march_plan(recorder, name, shape,
                                               frozen, dtype, dev):
    """A masked K2 launch hands the entry the masks' pointers, the grid,
    n_sub, and the masked march plan's interior, blocks and threads (the
    row budgets in 2D), a null scratch in shared memory; a given plan
    (a phase-35 candidate) replaces the default."""
    stencil = STENCILS[name]()
    f = torch.zeros((stencil.q, *shape), dtype=dtype)
    ncm = torch.zeros(shape, dtype=torch.uint8)
    nsm = torch.zeros((stencil.q, *shape), dtype=torch.bool) if frozen \
        else None
    spec = sc.pack_spec(("bgk", 1.2), stencil.e, stencil.w,
                        stencil.opposite)
    plans = sc.march_plan(f, stencil.e, 2, masked=True, frozen=frozen,
                          candidates=True)
    assert plans[0] == sc.march_plan(f, stencil.e, 2, masked=True,
                                     frozen=frozen)
    suffix = build.storage_suffix(dtype, dev)
    for given in (None, plans[-1]):
        recorder.calls.clear()
        sc._launch_multi(f, None, spec, 2, stencil.e, stencil.cs, dev,
                         ncm=ncm, nsm=nsm, table=[("collide", None)],
                         plan=given)
        ((entry, args),) = recorder.calls
        want = plans[0] if given is None else given
        assert entry == f"lt_multi_bgk_{name.lower()}_{suffix}"
        assert args[2] is None and args[3] == ncm.data_ptr()
        assert args[4] == (None if nsm is None else nsm.data_ptr())
        assert args[8:12] == (*launch_grid(shape), 2)
        assert args[12:17] == (*want.interior, want.blocks, want.threads)
        if stencil.d == 2:
            assert want.blocks_per_sm in (2, 3, 4, 6, 8)
