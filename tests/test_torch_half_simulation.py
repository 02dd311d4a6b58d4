"""Half storage through lettuce_tpu_torch.Simulation on the CPU, against
lettuce_tpu's, and ``Simulation.rollout``.

The port's kernel path runs on the CPU through ``_use_kernel()`` and
``_use_half_storage()`` with the plain versions inside; lettuce_tpu's half
storage runs its Pallas kernel on a ``use_native=True`` CPU context, as
tests/test_native.py does, and its float32 reference on the jnp step."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.simulation as simulation_module
from tests.torch_helpers import to_numpy

# tests/test_native.py:160-187's half-storage case
GRID = [16, 16, 128]


def _tgv(pkg, ctx, grid=GRID, stencil="D3Q19"):
    return pkg.TaylorGreenVortex(ctx, grid, 100, 0.05,
                                 stencil=getattr(pkg, stencil)(),
                                 initialize_fneq=False)


def port_half(flow):
    """A port Simulation on the kernel path with half storage engaged."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        sim = ltt.Simulation(flow, ltt.BGKCollision(
            flow.units.relaxation_parameter_lu), [], half_storage=True)
    sim._use_kernel()
    sim._use_half_storage()
    assert sim.half_storage_engaged and sim.step_path == "cuda x1"
    return sim


def _u_rel(u, ref):
    u, ref = np.asarray(u, dtype=np.float64), np.asarray(ref, np.float64)
    return float(np.abs(u - ref).max() / np.abs(ref).max())


def test_half_storage_matches_lettuce_tpu(monkeypatch):
    """D3Q19 TGV, 10 steps: the port's half run against lettuce_tpu's
    (measured 3.9e-3 of max|u| apart, under the 5e-3 bound: two bf16
    trajectories round apart at the size of their drift), each within 2 %
    of its own float32 run (measured 0.46 % and 0.49 %), mass to 1e-4.
    One deviation step per step, and the state stays float32."""
    jflow = _tgv(lt, lt.Context(dtype=jnp.float32, use_native=True))
    jsim = lt.Simulation(jflow, lt.BGKCollision(
        jflow.units.relaxation_parameter_lu), [], half_storage=True)
    assert jsim._step_dev is not None
    jsim(10)
    jref = _tgv(lt, lt.Context(dtype=jnp.float32, use_native=False))
    lt.Simulation(jref, lt.BGKCollision(
        jref.units.relaxation_parameter_lu), [])(10)

    tflow = _tgv(ltt, ltt.Context(device="cpu", dtype=torch.float32))
    tsim = port_half(tflow)
    calls = []
    real = simulation_module.stream_collide

    def counted(f, **kwargs):
        calls.append((f.dtype, kwargs.get("dev_storage", False)))
        return real(f, **kwargs)

    monkeypatch.setattr(simulation_module, "stream_collide", counted)
    tsim(10)
    assert calls == [(torch.bfloat16, True)] * 10
    assert tflow.f.dtype == torch.float32 and tflow.i == 10
    tref = _tgv(ltt, ltt.Context(device="cpu", dtype=torch.float32))
    ltt.Simulation(tref, ltt.BGKCollision(
        tref.units.relaxation_parameter_lu), [])(10)

    assert _u_rel(to_numpy(tflow.u()), jflow.u()) < 5e-3
    assert _u_rel(jflow.u(), jref.u()) < 0.02
    assert _u_rel(to_numpy(tflow.u()), to_numpy(tref.u())) < 0.02
    for half, ref in ((float(jflow.rho().sum()), float(jref.rho().sum())),
                      (float(tflow.rho().sum()), float(tref.rho().sum()))):
        np.testing.assert_allclose(half, ref, rtol=1e-4)


def test_gradients_run_at_full_precision():
    """Half storage is a throughput mode: the step function and the
    segment stay the full-precision kernel step."""
    sim = port_half(_tgv(ltt, ltt.Context(device="cpu",
                                          dtype=torch.float64),
                         grid=[8, 8], stencil="D2Q9"))
    f0 = sim.flow.f.clone().requires_grad_(True)
    out = sim.make_segment_fn(2)(f0)
    assert out.dtype == torch.float64
    out.pow(2).sum().backward()
    assert f0.grad is not None and bool(torch.isfinite(f0.grad).all())
    # a state that requires grad skips the deviations in a call too
    sim.flow.f = f0
    sim(1)
    assert sim.flow.f.requires_grad and sim.flow.f.dtype == torch.float64


# ----------------------------------------------------------------------
# rollout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_rollout_matches_the_reporters(dtype):
    """tests/test_reporters.py:178-205 for the port: rollout's records
    against an ObservableReporter run, and the same final state."""
    def make():
        return ltt.TaylorGreenVortex(ltt.Context(device="cpu", dtype=dtype),
                                     16, 100, 0.05, stencil=ltt.D2Q9())

    flow_a = make()
    sim_a = ltt.Simulation(flow_a, ltt.BGKCollision(
        flow_a.units.relaxation_parameter_lu), [])
    records = sim_a.rollout(6, observables=[
        ltt.IncompressibleKineticEnergy(flow_a),
        ltt.MaximumVelocity(flow_a)], interval=2)
    assert tuple(records.shape) == (3, 2) and records.dtype == dtype
    assert flow_a.i == 6

    flow_b = make()
    rep = ltt.ObservableReporter(ltt.IncompressibleKineticEnergy(flow_b),
                                 interval=2, out=[])
    sim_b = ltt.Simulation(flow_b, ltt.BGKCollision(
        flow_b.units.relaxation_parameter_lu), [rep])
    sim_b(6)
    energies = [row[2] for row in rep.out[1:]]  # skip the step-0 row
    np.testing.assert_allclose(to_numpy(records)[:, 0], energies, rtol=1e-6)
    assert torch.equal(flow_a.f, flow_b.f)


@pytest.mark.parametrize("steps,interval", [(6, 2), (7, 2)],
                         ids=["6-by-2", "7-by-2"])
def test_rollout_half_storage_equals_a_call(steps, interval):
    """Under half storage rollout steps in deviations throughout and
    decodes only for the observables: its final state is bitwise that of
    ``simulation(steps)``, and each record is the observable of the
    decoded state of its step."""
    def make():
        return port_half(_tgv(ltt, ltt.Context(device="cpu"),
                              grid=[8, 8, 16]))

    sim = make()
    observables = [ltt.IncompressibleKineticEnergy(sim.flow),
                   ltt.MaximumVelocity(sim.flow), ltt.Enstrophy(sim.flow),
                   ltt.Mass(sim.flow)]
    records = sim.rollout(steps, observables, interval=interval)
    assert tuple(records.shape) == (steps // interval, 4)
    assert bool(torch.isfinite(records).all()) and sim.flow.i == steps

    plain = make()
    plain(steps)
    assert torch.equal(sim.flow.f, plain.flow.f)

    last = make()
    last(interval * (steps // interval))
    want = [float(obs(last.flow.f)) for obs in observables]
    np.testing.assert_allclose(to_numpy(records[-1]), want, rtol=1e-6)


def test_rollout_without_observables():
    sim = port_half(_tgv(ltt, ltt.Context(device="cpu"), grid=[8, 8],
                         stencil="D2Q9"))
    records = sim.rollout(5)
    assert tuple(records.shape) == (5, 0) and sim.flow.i == 5
