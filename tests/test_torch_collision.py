"""lettuce_tpu_torch's collision operators, forces and moment transforms
against lettuce_tpu's on the CPU.

The same seeded numpy state goes to both packages; float64 agrees to
1e-12, float32 to 5e-6 (the tolerance tests/test_native.py holds the
Pallas kernel to against the jnp step)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from tests.torch_helpers import (DTYPES, contexts, hand_state, noisy_state,
                                 tgv_pair, to_numpy)

GRIDS = {"D2Q9": [12, 10], "D3Q15": [6, 5, 4], "D3Q19": [6, 5, 4],
         "D3Q27": [6, 5, 4]}
ACCEL = {2: [1e-4, -5e-5], 3: [1e-4, -5e-5, 2e-5]}


def _mrt(pkg, name, taus):
    def make(flow):
        transform = getattr(pkg, name)(flow.stencil, flow.context)
        return pkg.MRTCollision(transform, taus, flow.context)
    return make


# collision name -> (stencils, factory(pkg, flow))
COLLISIONS = {
    "bgk": (tuple(GRIDS), lambda pkg, flow: pkg.BGKCollision(0.8)),
    "none": (tuple(GRIDS), lambda pkg, flow: pkg.NoCollision()),
    "guo": (tuple(GRIDS), lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.Guo(flow, 0.8, ACCEL[flow.stencil.d]))),
    "shanchen": (tuple(GRIDS), lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.ShanChen(flow, 0.8, ACCEL[flow.stencil.d]))),
    "trt": (tuple(GRIDS), lambda pkg, flow: pkg.TRTCollision(0.8, 1.1)),
    "reg": (tuple(GRIDS), lambda pkg, flow: pkg.RegularizedCollision(0.8)),
    "reg_units": (("D2Q9",), lambda pkg, flow: pkg.RegularizedCollision()),
    "smag": (tuple(GRIDS), lambda pkg, flow: pkg.SmagorinskyCollision(
        0.6, 0.3)),
    "smag_guo": (("D2Q9",), lambda pkg, flow: pkg.SmagorinskyCollision(
        0.6, 0.3, force=pkg.Guo(flow, 0.6, ACCEL[2]))),
    "kbc": (("D2Q9", "D3Q27"), lambda pkg, flow: pkg.KBCCollision(0.52)),
    "kbc_units": (("D2Q9",), lambda pkg, flow: pkg.KBCCollision()),
    "mrt_lallemand": (("D2Q9",), lambda pkg, flow: _mrt(
        pkg, "D2Q9Lallemand", [1, 1, 1, 1.3, 1.3, 1.2, 1.1, 1.1, 1.2])(flow)),
    "mrt_dellar": (("D2Q9",), lambda pkg, flow: _mrt(
        pkg, "D2Q9Dellar", [1, 1, 1, 1.3, 1.3, 1.2, 1.1, 1.1, 1.2])(flow)),
    "mrt_dhumieres": (("D3Q19",), lambda pkg, flow: _mrt(
        pkg, "D3Q19DHumieres", [1.0] * 3 + [1.1, 1.2] * 8)(flow)),
    "mrt_hermite": (("D3Q27",), lambda pkg, flow: _mrt(
        pkg, "D3Q27Hermite", [1.0] * 4 + [0.9] * 6 + [1.2] * 17)(flow)),
}
CASES = [(name, stencil) for name, (stencils, _) in COLLISIONS.items()
         for stencil in stencils]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name,stencil", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_collision_matches_lettuce_tpu(name, stencil, dtype_name):
    """Each torch collision operator against lettuce_tpu's jnp operator
    on one seeded state."""
    jflow, tflow = tgv_pair(dtype_name, GRIDS[stencil], stencil,
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=11))
    make = COLLISIONS[name][1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = make(lt, jflow)(jflow)
        got = make(ltt, tflow)(tflow)
    assert got.dtype == DTYPES[dtype_name][1]
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=DTYPES[dtype_name][2])


def test_kbc_guards_an_equilibrium_cell():
    """At equilibrium sum_h is 0: gamma falls back to 2 (0/0 guarded), so
    the state is kept, as lettuce_tpu keeps it."""
    jflow, tflow = tgv_pair("float64", [12, 10], "D2Q9",
                            initialize_fneq=False)
    got = ltt.KBCCollision(0.6)(tflow)
    want = lt.KBCCollision(0.6)(jflow)
    assert np.all(np.isfinite(to_numpy(got)))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(to_numpy(got), to_numpy(tflow.f), rtol=0,
                               atol=1e-12)


def test_kbc_refuses_other_stencils():
    _, tflow = tgv_pair("float64", [6, 5, 4], "D3Q19",
                        initialize_fneq=False)
    with pytest.raises(ValueError, match="D2Q9 and D3Q27"):
        ltt.KBCCollision(0.6)(tflow)


@pytest.mark.parametrize("cls", ["KBCCollision2D", "KBCCollision3D"])
def test_kbc_aliases_warn_and_match(cls):
    with pytest.warns(UserWarning, match="deprecated"):
        collision = getattr(ltt, cls)(0.6)
    assert isinstance(collision, ltt.KBCCollision) and collision.tau == 0.6


# ----------------------------------------------------------------------
# forces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("force", ["Guo", "ShanChen"])
def test_force_terms_match_lettuce_tpu(force, dtype_name):
    jflow, tflow = tgv_pair(dtype_name, [12, 10], "D2Q9",
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=12))
    jforce = getattr(lt, force)(jflow, 0.8, ACCEL[2])
    tforce = getattr(ltt, force)(tflow, 0.8, ACCEL[2])
    atol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(to_numpy(tforce.u_eq(tflow)),
                               np.asarray(jforce.u_eq(jflow)), rtol=0,
                               atol=atol)
    want = jforce.source_term(jflow.u())
    got = tforce.source_term(tflow.u())
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=0, atol=atol)
    assert tforce.native_available()
    assert tforce.ueq_scaling_factor == jforce.ueq_scaling_factor


def test_guo_source_sums_to_zero():
    """The Guo source conserves mass: sum_q S_q = 0."""
    _, tflow = tgv_pair("float64", [12, 10], "D2Q9", initialize_fneq=False)
    si = ltt.Guo(tflow, 0.8, ACCEL[2]).source_term(tflow.u())
    assert tuple(si.shape) == tuple(tflow.f.shape)
    np.testing.assert_allclose(to_numpy(si.sum(dim=0)), 0, atol=1e-12)


def test_per_node_acceleration_matches_a_uniform_one():
    """A per-node acceleration that is the same everywhere gives the
    uniform one's step (the torch step takes both; only the uniform one
    runs on the kernel)."""
    _, tflow = tgv_pair("float64", [12, 10], "D2Q9", initialize_fneq=False)
    field = np.broadcast_to(np.asarray(ACCEL[2])[:, None, None],
                            (2, 12, 10)).copy()
    uniform = ltt.BGKCollision(0.8, force=ltt.Guo(tflow, 0.8, ACCEL[2]))
    per_node = ltt.BGKCollision(0.8, force=ltt.Guo(tflow, 0.8, field))
    assert not per_node.native_available()
    np.testing.assert_allclose(to_numpy(per_node(tflow)),
                               to_numpy(uniform(tflow)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("force", ["Guo", "ShanChen"])
def test_force_poiseuille_profile(force):
    """tests/test_force.py's gate on the port: 16^2, Re 1, Ma 0.02, 500
    steps of the torch step, profile error under 0.06, and the same
    velocity as lettuce_tpu's run."""
    jctx, tctx = contexts("float64")
    flows = {}
    for pkg, ctx in ((lt, jctx), (ltt, tctx)):
        flow = pkg.PoiseuilleFlow2D(ctx, resolution=16, reynolds_number=1,
                                    mach_number=0.02,
                                    initialize_with_zeros=True)
        acc = flow.units.convert_acceleration_to_lu(flow.acceleration)
        tau = flow.units.relaxation_parameter_lu
        collision = pkg.BGKCollision(tau, force=getattr(pkg, force)(
            flow, tau, acc))
        pkg.Simulation(flow, collision, [])(500)
        flows[pkg] = (flow, acc)
    flow, acc = flows[ltt]
    u = to_numpy(flow.units.convert_velocity_to_pu(
        flow.u(acceleration=acc)))[:, 1:-1, 1:-1]
    u_ref = to_numpy(flow.analytic_solution()[1])[:, 1:-1, 1:-1]
    err = np.abs(u - u_ref).max() / np.abs(u_ref).max()
    assert err < 0.06, f"profile error {err}"
    jflow, jacc = flows[lt]
    np.testing.assert_allclose(
        to_numpy(flow.u(acceleration=acc)),
        np.asarray(jflow.u(acceleration=jacc)), rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# moment transforms
# ----------------------------------------------------------------------
TRANSFORMS = [("D1Q3Transform", "D1Q3"), ("D2Q9Lallemand", "D2Q9"),
              ("D2Q9Dellar", "D2Q9"), ("D3Q27Hermite", "D3Q27"),
              ("D3Q19DHumieres", "D3Q19")]


@pytest.mark.parametrize("name,stencil", TRANSFORMS,
                         ids=[t for t, _ in TRANSFORMS])
def test_transform_matrices_match_lettuce_tpu(name, stencil):
    jctx, tctx = contexts("float64")
    want = getattr(lt, name)(getattr(lt, stencil)(), jctx)
    got = getattr(ltt, name)(getattr(ltt, stencil)(), tctx)
    np.testing.assert_allclose(to_numpy(got.matrix), np.asarray(want.matrix),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(to_numpy(got.inverse),
                               np.asarray(want.inverse), rtol=0, atol=1e-12)
    assert got.names == want.names
    f = np.random.default_rng(3).uniform(0.05, 0.15,
                                         (got.stencil.q, 4, 3))
    np.testing.assert_allclose(
        to_numpy(got.transform(torch.as_tensor(f))),
        np.asarray(want.transform(jnp.asarray(f))), rtol=0, atol=1e-13)


@pytest.mark.parametrize("name,stencil", TRANSFORMS[1:4],
                         ids=[t for t, _ in TRANSFORMS[1:4]])
def test_closed_form_equilibria_match_lettuce_tpu(name, stencil):
    jflow, tflow = tgv_pair("float64", GRIDS[stencil], stencil,
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=13))
    jtr = getattr(lt, name)(jflow.stencil, jflow.context)
    ttr = getattr(ltt, name)(tflow.stencil, tflow.context)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jtr.equilibrium(jtr.transform(jflow.f), jflow)
        got = ttr.equilibrium(ttr.transform(tflow.f), tflow)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_default_moment_transforms():
    _, tctx = contexts("float64")
    for stencil, cls in (("D1Q3", "D1Q3Transform"),
                         ("D2Q9", "D2Q9Lallemand"),
                         ("D3Q19", "D3Q19DHumieres")):
        transform = ltt.get_default_moment_transform(
            getattr(ltt, stencil)(), tctx)
        assert type(transform) is getattr(ltt, cls)
    with pytest.raises(ValueError):
        ltt.get_default_moment_transform(ltt.D3Q27(), tctx)
    np.testing.assert_array_equal(
        ltt.moment_tensor(ltt.D2Q9.e, [[1, 0], [1, 1]]),
        lt.moment_tensor(lt.D2Q9.e, [[1, 0], [1, 1]]))


def test_dhumieres_equal_rates_is_bgk():
    """With every rate equal to tau, MRT in the d'Humieres basis is BGK
    (its equilibrium moments are the exact image of feq)."""
    _, tflow = tgv_pair("float64", [6, 5, 4], "D3Q19",
                        initialize_fneq=False)
    tflow.f = tflow.f + torch.as_tensor(
        noisy_state(tflow.f.numpy(), seed=14) - tflow.f.numpy())
    transform = ltt.D3Q19DHumieres(tflow.stencil, tflow.context)
    mrt = ltt.MRTCollision(transform, [0.8] * 19, tflow.context)
    np.testing.assert_allclose(to_numpy(mrt(tflow)),
                               to_numpy(ltt.BGKCollision(0.8)(tflow)),
                               rtol=0, atol=1e-13)
