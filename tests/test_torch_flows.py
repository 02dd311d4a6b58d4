"""The turbulence and forced flows of lettuce_tpu_torch, their observables
and the pressure-Poisson initialisation, against lettuce_tpu on the CPU.

Both packages draw the same random fields (``np.random.RandomState`` for
the decaying turbulence, ``np.random.default_rng`` for the mixing layer),
so the initial states agree: float64 to 1e-12, float32 to 5e-6."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from lettuce_tpu_torch import cli
from tests.torch_helpers import (DTYPES, contexts, hand_state, noisy_state,
                                 tgv_pair, to_numpy)

# name -> factory(pkg, ctx): the forced and turbulence flows, small
FLOWS = {
    "poiseuille": lambda pkg, ctx: pkg.PoiseuilleFlow2D(ctx, 16, 10, 0.05),
    "poiseuille_parabola": lambda pkg, ctx: pkg.PoiseuilleFlow2D(
        ctx, [16, 12], 10, 0.05, initialize_with_zeros=False),
    "doublyshear": lambda pkg, ctx: pkg.DoublyPeriodicShear2D(
        ctx, 24, 1000, 0.05),
    "decay2d": lambda pkg, ctx: pkg.DecayingTurbulence(
        ctx, [24, 20], 1000, 0.05, k0=4, randseed=3),
    "decay3d": lambda pkg, ctx: pkg.DecayingTurbulence(
        ctx, [8, 10, 6], 1000, 0.05, k0=3, randseed=4),
    "decay2d_no_pressure": lambda pkg, ctx: pkg.DecayingTurbulence(
        ctx, [16, 16], 1000, 0.05, k0=4, randseed=5,
        initialize_pressure=False, initialize_fneq=False),
    "mixing2d": lambda pkg, ctx: pkg.MixingLayer(ctx, [24, 16], 1000, 0.05,
                                                 randseed=6),
    "mixing3d": lambda pkg, ctx: pkg.MixingLayer(
        ctx, [8, 10, 6], 1000, 0.05, stencil=pkg.D3Q19(), randseed=7),
}


def flow_pair(name, dtype_name):
    jctx, tctx = contexts(dtype_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FLOWS[name](lt, jctx), FLOWS[name](ltt, tctx)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_initial_state_matches_lettuce_tpu(name, dtype_name):
    jflow, tflow = flow_pair(name, dtype_name)
    assert tflow.f.dtype == DTYPES[dtype_name][1]
    assert type(tflow.stencil).__name__ == type(jflow.stencil).__name__
    assert [type(b).__name__ for b in tflow.boundaries] == \
        [type(b).__name__ for b in jflow.boundaries]
    np.testing.assert_allclose(to_numpy(tflow.f), np.asarray(jflow.f),
                               rtol=0, atol=DTYPES[dtype_name][2])
    assert tflow.units.relaxation_parameter_lu == pytest.approx(
        float(jflow.units.relaxation_parameter_lu), rel=1e-12)


def test_decaying_turbulence_spectrum_matches_lettuce_tpu():
    jflow, tflow = flow_pair("decay3d", "float64")
    spectrum, wavenumbers = tflow.energy_spectrum
    want, want_k = jflow.energy_spectrum
    np.testing.assert_array_equal(wavenumbers, want_k)
    np.testing.assert_allclose(spectrum, want, rtol=1e-12, atol=1e-18)
    assert tflow.initialize_pressure is False  # 2D only


def test_poiseuille_acceleration_and_analytic_solution():
    jflow, tflow = flow_pair("poiseuille", "float64")
    np.testing.assert_array_equal(to_numpy(tflow.acceleration),
                                  np.asarray(jflow.acceleration))
    for got, want in zip(tflow.analytic_solution(),
                         jflow.analytic_solution()):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                   atol=1e-14)


# ----------------------------------------------------------------------
# the flow additions: forced velocity, shear tensor, pressure Poisson
# ----------------------------------------------------------------------
def test_forced_velocity_and_shear_tensor_match_lettuce_tpu():
    jflow, tflow = tgv_pair("float64", [12, 10], "D2Q9",
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=31))
    for acc in ([1e-3, -2e-3], np.full((2, 12, 10), 1e-3)):
        np.testing.assert_allclose(
            to_numpy(tflow.u(acceleration=acc)),
            np.asarray(jflow.u(acceleration=jnp.asarray(acc))), rtol=0,
            atol=1e-15)
    np.testing.assert_allclose(to_numpy(tflow.shear_tensor()),
                               np.asarray(jflow.shear_tensor()), rtol=0,
                               atol=1e-14)


def test_pressure_poisson_matches_lettuce_tpu():
    jflow, tflow = flow_pair("decay2d_no_pressure", "float64")
    want = lt.flow.pressure_poisson(jflow.units, jflow.u(), jflow.rho(),
                                    tol_abs=1e-8)
    got = ltt.pressure_poisson(tflow.units, tflow.u(), tflow.rho(),
                               tol_abs=1e-8)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    want = lt.flow.initialize_pressure_poisson(jflow, tol_pressure=1e-6)
    got = ltt.initialize_pressure_poisson(tflow, tol_pressure=1e-6)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_torch_jacobi_solves_the_poisson_equation():
    """A manufactured periodic solution: lap p = f with f from p; at a
    loose tolerance the solver stops at lettuce_tpu's iterate."""
    n = 16
    x = np.arange(n) * 2 * np.pi / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    p = np.sin(X) * np.cos(2 * Y)
    dx = 2 * np.pi / n
    lap = (np.roll(p, 1, 0) + np.roll(p, -1, 0) + np.roll(p, 1, 1)
           + np.roll(p, -1, 1) - 4 * p) / dx ** 2
    zero = torch.zeros(n, n, dtype=torch.float64)
    got = ltt.torch_jacobi(torch.as_tensor(lap), zero, dx, dim=2,
                           tol_abs=1e-20, max_num_steps=20000)
    np.testing.assert_allclose(to_numpy(got), p, atol=1e-6)
    want = lt.utils.utility.jax_jacobi(jnp.asarray(lap), jnp.zeros((n, n)),
                                       dx, dim=2, tol_abs=1e-3,
                                       max_num_steps=20000)
    got = ltt.torch_jacobi(torch.as_tensor(lap), zero, dx, dim=2,
                           tol_abs=1e-3, max_num_steps=20000)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=1e-12)


# ----------------------------------------------------------------------
# observables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil,grid", [("D2Q9", [16, 12]),
                                          ("D3Q19", [8, 6, 10])])
def test_enstrophy_and_spectrum_match_lettuce_tpu(stencil, grid, dtype_name):
    jflow, tflow = tgv_pair(dtype_name, grid, stencil,
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=32))
    tol = DTYPES[dtype_name][2]
    got = ltt.Enstrophy(tflow)()
    want = lt.Enstrophy(jflow)()
    assert float(got) == pytest.approx(float(want), rel=max(tol, 1e-12))
    got = ltt.EnergySpectrum(tflow)()
    want = lt.EnergySpectrum(jflow)()
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=max(tol, 1e-12), atol=1e-14)
    # on a state the flow does not hold
    f2 = noisy_state(jflow.f, seed=33)
    assert float(ltt.Enstrophy(tflow)(torch.as_tensor(
        f2, dtype=tflow.f.dtype))) == pytest.approx(
        float(lt.Enstrophy(jflow)(jnp.asarray(f2, dtype=jflow.f.dtype))),
        rel=max(tol, 1e-12))


# ----------------------------------------------------------------------
# the CLI: the registry and the force the benchmark wires
# ----------------------------------------------------------------------
def test_cli_registry_matches_lettuce_tpu():
    assert sorted(ltt.flow_by_name) == sorted(lt.flow_by_name)
    for name, (flow_cls, stencil) in ltt.flow_by_name.items():
        jflow_cls, jstencil = lt.flow_by_name[name]
        assert flow_cls.__name__ == jflow_cls.__name__
        assert stencil.__name__ == jstencil.__name__


@pytest.mark.parametrize("flow_name", ["poiseuille2d", "shear2d", "decay2d",
                                       "mixing2d"])
def test_cli_benchmark_runs_the_new_flows(flow_name, capsys):
    mlups = cli.main(["--device", "cpu", "-p", "single", "benchmark", "-r",
                      "16", "-s", "3", "-f", flow_name])
    assert mlups == 0
    out = capsys.readouterr().out
    assert "Finished 3 steps in float32 on cpu (torch x1 path)" in out


def test_cli_benchmark_wires_guo_for_a_forced_flow(monkeypatch):
    seen = {}
    original = ltt.Simulation.__init__

    def spy(self, flow, collision, reporter, **options):
        seen["collision"] = collision
        original(self, flow, collision, reporter, **options)

    monkeypatch.setattr(ltt.Simulation, "__init__", spy)
    context = ltt.Context(device="cpu", dtype=torch.float32,
                          use_native=False)
    cli.benchmark(context, 2, 16, "poiseuille2d")
    force = seen["collision"].force
    assert isinstance(force, ltt.Guo)
    assert float(force.acceleration[0]) > 0
    cli.benchmark(context, 2, 16, "taylor2d")
    assert seen["collision"].force is None
