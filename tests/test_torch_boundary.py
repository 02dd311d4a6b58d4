"""The boundaries and bounded flows of lettuce_tpu_torch against
lettuce_tpu on the CPU: every boundary's masks, replacement field and
``window_view``, the combined per-node equilibrium field, the flow cases
(obstacle, lid-driven cavity, Couette) and the torch step of bounded flows
against lettuce_tpu's jnp step.

Each comparison hands one seeded numpy state to both packages. float64
agrees to 1e-12, float32 to 5e-6 (the tolerance tests/test_native.py
holds the Pallas kernel to against the jnp step)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from lettuce_tpu.models._ext_flow import closed_grid as jax_closed_grid
from lettuce_tpu.models._ext_flow import face_mask as jax_face_mask
from lettuce_tpu.ops.boundary import combined_equilibrium_field
from tests.torch_helpers import (DTYPES, boundary_flow_pair, contexts,
                                 hand_state, noisy_state, to_numpy)

SHAPES = {"D2Q9": [16, 128], "D3Q19": [16, 16, 128]}


def assert_close(got, want, dtype_name):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DTYPES[dtype_name][2])


def _per_node_velocity(shape):
    rng = np.random.default_rng(3)
    return 0.05 * rng.uniform(size=(len(shape), *shape))


def _pressure_field(shape):
    return 0.001 * np.random.default_rng(4).uniform(size=tuple(shape))


def _face(shape, axis, end):
    m = np.zeros(tuple(shape), dtype=bool)
    sel = [slice(None)] * len(shape)
    sel[axis] = end
    m[tuple(sel)] = True
    return m


def _blob(shape):
    grid = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    r2 = sum((x - n / 3) ** 2 for x, n in zip(grid, shape))
    return r2 < 9


# (package, flow, context) -> boundary, the same code for both packages
BOUNDARIES = {
    "bounce_back": lambda pkg, flow, ctx: pkg.BounceBackBoundary(
        _blob(flow.resolution)),
    "equilibrium_uniform": lambda pkg, flow, ctx: pkg.EquilibriumBoundaryPU(
        ctx, _face(flow.resolution, 0, 0),
        [0.05] + [0.0] * (len(flow.resolution) - 1), 0.001),
    "equilibrium_per_node": lambda pkg, flow, ctx: pkg.EquilibriumBoundaryPU(
        ctx, _face(flow.resolution, 0, 0),
        _per_node_velocity(flow.resolution),
        _pressure_field(flow.resolution)),
    "anti_bounce_back_+x": lambda pkg, flow, ctx: pkg.AntiBounceBackOutlet(
        [1] + [0] * (len(flow.resolution) - 1), flow),
    "anti_bounce_back_-y": lambda pkg, flow, ctx: pkg.AntiBounceBackOutlet(
        [0, -1] + [0] * (len(flow.resolution) - 2), flow),
    "equilibrium_outlet_p": lambda pkg, flow, ctx: pkg.EquilibriumOutletP(
        [1] + [0] * (len(flow.resolution) - 1), flow, rho_outlet=1.001),
    "sponge_-x": lambda pkg, flow, ctx: pkg.SpongeOutlet(
        [-1] + [0] * (len(flow.resolution) - 1), flow, depth=4),
    "periodic_pressure": lambda pkg, flow, ctx: pkg.PeriodicPressureBC(
        flow, 1e-3, pkg.BGKCollision(0.8), axis=0,
        exclude_mask=_face(flow.resolution, 1, 0)),
}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_boundary_matches_lettuce_tpu(name, stencil_name, dtype_name):
    """Masks and the replacement field on one seeded state."""
    jflow, tflow = boundary_flow_pair(dtype_name, SHAPES[stencil_name],
                                      stencil_name)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=31))
    jb = BOUNDARIES[name](lt, jflow, jflow.context)
    tb = BOUNDARIES[name](ltt, tflow, tflow.context)
    shape = list(tflow.resolution)
    q_shape = [tflow.stencil.q, *shape]
    for make, size in (("make_no_collision_mask", shape),
                       ("make_no_streaming_mask", q_shape)):
        jm = getattr(jb, make)(size, jflow.context)
        tm = getattr(tb, make)(size, tflow.context)
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert tm.dtype == torch.bool and tm.device == tflow.f.device
            np.testing.assert_array_equal(to_numpy(tm), np.asarray(jm))
    assert tb.native_available() == jb.native_available()
    got = tb(tflow)
    assert got.dtype == tflow.f.dtype
    assert_close(got, jb(jflow), dtype_name)


def test_boundary_is_differentiable():
    """The replacement fields carry autograd through the torch step."""
    _, tflow = boundary_flow_pair("float64", [8, 12], "D2Q9")
    for name in ("anti_bounce_back_+x", "sponge_-x", "bounce_back",
                 "equilibrium_outlet_p"):
        b = BOUNDARIES[name](ltt, tflow, tflow.context)
        f = tflow.f.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(b(tflow.view(f)).pow(2).sum(), f)
        assert bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("win_lo,width", [(5, 6), (-2, 5), (120, 12)],
                         ids=["inside", "wraps-low", "wraps-high"])
def test_window_view_matches(win_lo, width):
    """Per-node equilibrium fields and the sponge's ramp re-slice into a
    periodic window along their axis; other axes pass through."""
    jflow, tflow = boundary_flow_pair("float64", [16, 128], "D2Q9")
    n = 128
    pairs = [(BOUNDARIES["equilibrium_per_node"](lt, jflow, jflow.context),
              BOUNDARIES["equilibrium_per_node"](ltt, tflow, tflow.context),
              ("velocity", "pressure")),
             (lt.SpongeOutlet([0, 1], jflow, depth=6),
              ltt.SpongeOutlet([0, 1], tflow, depth=6),
              ("_sigma", "_face_field"))]
    for jb, tb, fields in pairs:
        for axis in (0, 1):
            jv = jb.window_view(axis, win_lo, width, n if axis else 16)
            tv = tb.window_view(axis, win_lo, width, n if axis else 16)
            for field in fields:
                np.testing.assert_array_equal(to_numpy(getattr(tv, field)),
                                              np.asarray(getattr(jv, field)))


def test_combined_equilibrium_field_matches():
    jflow, tflow = boundary_flow_pair("float64", [16, 128], "D2Q9")
    wall = _face([16, 128], 1, -1)
    jb = [BOUNDARIES["equilibrium_per_node"](lt, jflow, jflow.context),
          BOUNDARIES["equilibrium_uniform"](lt, jflow, jflow.context),
          lt.EquilibriumBoundaryPU(jflow.context, wall,
                                   _per_node_velocity([16, 128]))]
    tb = [BOUNDARIES["equilibrium_per_node"](ltt, tflow, tflow.context),
          BOUNDARIES["equilibrium_uniform"](ltt, tflow, tflow.context),
          ltt.EquilibriumBoundaryPU(tflow.context, wall,
                                    _per_node_velocity([16, 128]))]
    jflow._boundaries, tflow._boundaries = jb, tb
    jsim = lt.Simulation(jflow, lt.BGKCollision(0.9), [])
    tsim = ltt.Simulation(tflow, ltt.BGKCollision(0.9), [])
    want, want_idx = combined_equilibrium_field(
        jflow, jsim.boundaries, jsim.no_collision_mask)
    got, got_idx = ltt.combined_equilibrium_field(
        tflow, tsim.boundaries, tsim.no_collision_mask)
    assert got_idx == want_idx == (1, 3)
    assert got.device == tflow.f.device and got.dtype == tflow.f.dtype
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("resolution,axis,end,exclude",
                         [([16, 128], 1, -1, ()), ([6, 7, 8], 0, 0, (2,)),
                          ([9, 10], 0, -1, (1,))])
def test_grid_and_face_helpers_match(resolution, axis, end, exclude):
    np.testing.assert_array_equal(
        ltt.face_mask(resolution, axis, end, exclude_corners=exclude),
        jax_face_mask(resolution, axis, end, exclude_corners=exclude))
    for got, want in zip(ltt.closed_grid(resolution, 1.0, torch.float64,
                                         "cpu"),
                         jax_closed_grid(resolution, 1.0, jnp.float64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)


# ----------------------------------------------------------------------
# the flow cases
# ----------------------------------------------------------------------
def _obstacle(pkg, ctx, resolution=(32, 128)):
    flow = pkg.Obstacle(ctx, list(resolution), reynolds_number=80,
                        mach_number=0.1, domain_length_x=3.2)
    centre = (1.0, 6.0) if len(resolution) == 2 else (1.0, 1.6, 6.0)
    r2 = sum((to_numpy(x) - c) ** 2 for x, c in zip(flow.grid, centre))
    flow.mask = r2 < 0.3
    flow.initialize()
    return flow


FLOWS = {
    "obstacle": _obstacle,
    "obstacle3d": lambda pkg, ctx: _obstacle(pkg, ctx, (16, 16, 128)),
    "cavity": lambda pkg, ctx: pkg.Cavity2D(ctx, [32, 128],
                                            reynolds_number=100,
                                            mach_number=0.1),
    "couette": lambda pkg, ctx: pkg.CouetteFlow2D(ctx, [16, 128],
                                                  reynolds_number=10,
                                                  mach_number=0.05),
}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_case_matches(name):
    """Initial state, grid, units and the Simulation's masks."""
    jctx, tctx = contexts("float64")
    jflow, tflow = FLOWS[name](lt, jctx), FLOWS[name](ltt, tctx)
    np.testing.assert_allclose(to_numpy(tflow.f), np.asarray(jflow.f),
                               rtol=0, atol=1e-15)
    for got, want in zip(tflow.grid, jflow.grid):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                   atol=1e-12)
    assert (tflow.units.relaxation_parameter_lu
            == pytest.approx(jflow.units.relaxation_parameter_lu, rel=1e-15))
    jsim = lt.Simulation(jflow, lt.BGKCollision(1.0), [])
    tsim = ltt.Simulation(tflow, ltt.BGKCollision(1.0), [])
    assert ([type(b).__name__ for b in tsim.boundaries[1:]]
            == [type(b).__name__ for b in jsim.boundaries[1:]])
    assert tsim.no_collision_mask.dtype == torch.uint8
    np.testing.assert_array_equal(to_numpy(tsim.no_collision_mask),
                                  np.asarray(jsim.no_collision_mask))
    np.testing.assert_array_equal(to_numpy(tsim.no_streaming_mask),
                                  np.asarray(jsim.no_streaming_mask))


def test_couette_analytic_solution_matches():
    jctx, tctx = contexts("float64")
    jflow = FLOWS["couette"](lt, jctx)
    tflow = FLOWS["couette"](ltt, tctx)
    for got, want in zip(tflow.analytic_solution(), jflow.analytic_solution()):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("name,resolution", [("Obstacle2D", [20, 10]),
                                             ("Obstacle3D", [8, 6, 4])])
def test_deprecated_obstacle_aliases(name, resolution):
    stencil = "D2Q9" if len(resolution) == 2 else "D3Q19"
    jctx, tctx = contexts("float64")
    with pytest.warns(DeprecationWarning, match=name):
        tflow = getattr(ltt, name)(tctx, resolution, 100, 0.1,
                                   getattr(ltt, stencil)(), 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jflow = getattr(lt, name)(jctx, resolution, 100, 0.1,
                                  getattr(lt, stencil)(), 5)
    assert isinstance(tflow, ltt.Obstacle)
    assert tflow.char_length_lu == jflow.char_length_lu
    assert tflow.char_length_lu == pytest.approx(5)
    np.testing.assert_allclose(to_numpy(tflow.f), np.asarray(jflow.f),
                               rtol=0, atol=1e-15)


def test_flow_registry_and_checks():
    assert ltt.flow_by_name["couette2d"] == (ltt.CouetteFlow2D, ltt.D2Q9)
    _, tflow = boundary_flow_pair("float64", [8, 8], "D2Q9")
    with pytest.raises(ValueError, match="direction"):
        ltt.AntiBounceBackOutlet([1, 1], tflow)
    obstacle = ltt.Obstacle(ltt.Context(device="cpu"), [8, 6], 100, 0.1, 8.0)
    with pytest.raises(ValueError, match="mask shape"):
        obstacle.mask = np.zeros((6, 8), dtype=bool)
    obstacle.mask = torch.ones((8, 6), dtype=torch.bool)
    assert obstacle.mask.dtype == bool and obstacle.mask.all()


# ----------------------------------------------------------------------
# the torch step of bounded flows against the jnp step
# ----------------------------------------------------------------------
def _with_boundaries(names, resolution):
    def make(pkg, ctx):
        if pkg is lt:
            from tests.conftest import TestFlow
            flow = TestFlow(ctx, list(resolution), stencil=lt.D2Q9())
        else:
            from tests.torch_helpers import TorchTestFlow
            flow = TorchTestFlow(ctx, list(resolution), stencil=ltt.D2Q9())
        flow._boundaries = [BOUNDARIES[n](pkg, flow, ctx) for n in names]
        return flow
    return make


STEP_FLOWS = dict(FLOWS, **{
    "inlet_sponge_bounce_back": _with_boundaries(
        ["equilibrium_per_node", "sponge_-x", "bounce_back"], [32, 128]),
    "periodic_pressure": _with_boundaries(
        ["periodic_pressure", "bounce_back"], [16, 128]),
})


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(STEP_FLOWS))
def test_torch_step_matches_jnp_step(name, dtype_name):
    """Ten steps of the torch step against lettuce_tpu's jnp step from one
    seeded state."""
    jctx, tctx = contexts(dtype_name)
    jflow, tflow = STEP_FLOWS[name](lt, jctx), STEP_FLOWS[name](ltt, tctx)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=32, scale=1e-4))
    tau = float(jflow.units.relaxation_parameter_lu)
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), [])
    tsim = ltt.Simulation(tflow, ltt.BGKCollision(tau), [])
    assert jsim._step_kind == "jnp" and tsim._step_kind == "torch"
    jsim(10)
    tsim(10)
    assert tflow.f.dtype == DTYPES[dtype_name][1]
    assert_close(tflow.f, jflow.f, dtype_name)
