"""lettuce_tpu_torch.Simulation against lettuce_tpu.Simulation (jnp step)
on the CPU: ten steps from one seeded state, the reporters, and the step
path selection."""

import io

import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.simulation as simulation_module
from tests.torch_helpers import (DTYPES, hand_state, noisy_state, tgv_pair,
                                 to_numpy)

CASES = [("D2Q9", [32, 32]), ("D3Q19", [16, 16, 16])]


def simulations(dtype_name, stencil_name, resolution, reporters=None):
    jflow, tflow = tgv_pair(dtype_name, resolution, stencil_name,
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=21))
    tau = jflow.units.relaxation_parameter_lu
    jrep, trep = reporters(jflow, tflow) if reporters else ([], [])
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), jrep)
    tsim = ltt.Simulation(tflow, ltt.BGKCollision(tau), trep)
    return jsim, tsim


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name,resolution", CASES,
                         ids=["tgv2d-32", "tgv3d-16"])
def test_ten_steps_match_jnp_path(dtype_name, stencil_name, resolution):
    jsim, tsim = simulations(dtype_name, stencil_name, resolution)
    assert jsim._step_kind == "jnp"
    assert tsim._step_kind == "torch"
    jsim(10)
    mlups = tsim(10)
    assert mlups > 0 and tsim.flow.i == 10 == jsim.flow.i
    assert tsim.flow.f.dtype == DTYPES[dtype_name][1]
    np.testing.assert_allclose(to_numpy(tsim.flow.f), to_numpy(jsim.flow.f),
                               rtol=0, atol=DTYPES[dtype_name][2])


def test_cpu_context_runs_torch_step_even_with_native():
    ctx = ltt.Context(device="cpu", dtype=torch.float32, use_native=True)
    flow = ltt.TaylorGreenVortex(ctx, [8, 8, 8], 1600, 0.05,
                                 stencil=ltt.D3Q19())
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [])
    assert sim._step_kind == "torch"
    assert sim.step_path == "torch x1"
    assert sim.no_collision_mask is None and sim.no_streaming_mask is None


def test_cuda_context_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the error path cannot be reached")
    with pytest.raises(RuntimeError, match="cuda"):
        ltt.Context(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ltt.Context(device="cuda:0", dtype=torch.float64)


def test_default_context_is_the_card_and_raises_without_one(monkeypatch):
    # Context() takes the current CUDA device, as lettuce_tpu's takes the
    # accelerator; it never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ltt.Context()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ltt.Context(dtype=torch.float64, use_native=False)
    assert ltt.Context(device="cpu").device == torch.device("cpu")


def test_reporters_match():
    def reporters(jflow, tflow):
        jout, tout = [], []
        jrep = [lt.ObservableReporter(cls(jflow), interval=iv, out=jout)
                for cls, iv in ((lt.MaximumVelocity, 2),
                                (lt.IncompressibleKineticEnergy, 3),
                                (lt.Mass, 4))]
        trep = [ltt.ObservableReporter(cls(tflow), interval=iv, out=tout)
                for cls, iv in ((ltt.MaximumVelocity, 2),
                                (ltt.IncompressibleKineticEnergy, 3),
                                (ltt.Mass, 4))]
        jrep.append(lt.ErrorReporter(jflow.analytic_solution, interval=5,
                                     out=jout))
        trep.append(ltt.ErrorReporter(tflow.analytic_solution, interval=5,
                                      out=tout))
        return jrep, trep

    jsim, tsim = simulations("float64", "D2Q9", [24, 24], reporters)
    jsim(12)
    tsim(12)
    jout, tout = jsim.reporter[0].out, tsim.reporter[0].out
    assert len(tout) == len(jout) > 10
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_reporter_prints_to_stream():
    ctx = ltt.Context(device="cpu", dtype=torch.float64)
    tflow = ltt.TaylorGreenVortex(ctx, [16, 16], 1600, 0.05,
                                  stencil=ltt.D2Q9())
    out = io.StringIO()
    sim = ltt.Simulation(tflow, ltt.BGKCollision(0.6),
                         [ltt.ObservableReporter(ltt.Mass(tflow), interval=2,
                                                 out=out)])
    sim(4)
    rows = [line.split() for line in out.getvalue().splitlines()]
    assert [int(r[0]) for r in rows] == [0, 2, 4]


def test_mean_analytic_error_matches():
    jsim, tsim = simulations("float64", "D2Q9", [16, 16])
    want = lt.mean_analytic_error(jsim, 20)
    got = ltt.mean_analytic_error(tsim, 20)
    assert tsim.flow.i == 20
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_torch_path_is_differentiable():
    ctx = ltt.Context(device="cpu", dtype=torch.float64)
    tflow = ltt.TaylorGreenVortex(ctx, [8, 8], 1600, 0.05,
                                  stencil=ltt.D2Q9(), initialize_fneq=False)
    sim = ltt.Simulation(tflow, ltt.BGKCollision(0.6), [])
    f0 = tflow.f.clone().requires_grad_(True)
    tflow.f = f0
    sim(3)
    tflow.f.pow(2).sum().backward()
    assert f0.grad is not None and bool(torch.isfinite(f0.grad).all())


@pytest.mark.parametrize("interval", [None, 2], ids=["one-run", "reported"])
def test_kernel_path_never_writes_a_state_the_caller_holds(interval):
    """The kernel path's throughput loop on the CPU: ``_cuda_step``'s
    wrapper copies into ``out`` exactly as the kernel writes it. Neither
    the state a run starts from nor the one it ends with is written by a
    later step, and the states equal the torch step's."""
    def run(kernel):
        jflow, tflow = tgv_pair("float64", [12, 10], "D2Q9",
                                initialize_fneq=False)
        hand_state(jflow, tflow, noisy_state(jflow.f, seed=23))
        reporters = ([] if interval is None else
                     [ltt.ObservableReporter(ltt.Mass(tflow),
                                             interval=interval, out=[])])
        sim = ltt.Simulation(tflow, ltt.BGKCollision(0.6), reporters)
        if kernel:
            sim._use_kernel()
        return sim

    sim, reference = run(kernel=True), run(kernel=False)
    steps = []
    real_step = sim._cuda_step
    sim._cuda_step = lambda f, out=None: steps.append(out) or real_step(
        f, out)
    f0 = sim.flow.f
    kept0 = f0.clone()
    sim(3)
    f1 = sim.flow.f
    kept1 = f1.clone()
    sim(4)
    assert len(steps) == 7 and any(out is not None for out in steps)
    assert torch.equal(f0, kept0)
    assert torch.equal(f1, kept1)
    owned = {b.data_ptr() for b in sim._buffers if b is not None}
    assert owned and f1.data_ptr() not in owned
    assert sim.flow.f.data_ptr() not in owned
    reference(7)
    np.testing.assert_allclose(to_numpy(sim.flow.f),
                               to_numpy(reference.flow.f), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_probe_takes_kernel_path_for_16_bit_state(dtype, monkeypatch,
                                                  capsys):
    """A CUDA context with 16-bit state: the probe takes the kernel path
    (the 16-bit instances, K1f) and prints nothing; the gate's parameters
    run the 16-bit storage. The context is made on the CPU and then says
    ``cuda``, so no card is needed: the loaders only record their call."""
    ctx = ltt.Context(device="cpu", dtype=dtype, use_native=True)
    flow = ltt.TaylorGreenVortex(ctx, [8, 8], 1600, 0.05,
                                 stencil=ltt.D2Q9(), initialize_fneq=False)
    ctx.device = torch.device("cuda", 0)
    loaded = []
    monkeypatch.setattr(simulation_module, "load_libraries",
                        lambda: loaded.append("forward"))
    monkeypatch.setattr(simulation_module.adjoint, "load_libraries",
                        lambda: loaded.append("adjoint"))
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [])
    ctx.device = torch.device("cpu")
    assert sim._step_kind == "cuda" and sim.step_path == "cuda x1"
    assert loaded == ["forward", "adjoint"]
    assert capsys.readouterr().out == ""
    from lettuce_tpu_torch.ops.cuda.build import storage_suffix
    assert storage_suffix(sim.flow.f.dtype) == {
        torch.bfloat16: "bf16", torch.float16: "f16"}[dtype]
    # the kernel path's step keeps the 16-bit state
    assert sim.make_step_fn()(sim.flow.f).dtype == dtype


# ----------------------------------------------------------------------
# the reporters on a 16-bit state (F6), and Mass with a numpy mask (F7)
# ----------------------------------------------------------------------
# a 16-bit observable against float32 on the same values: bfloat16 sums
# came within 0.6 % (Enstrophy), float16 within 0.05 %
HALF_RTOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3}
OBSERVABLES = (ltt.MaximumVelocity, ltt.IncompressibleKineticEnergy,
               ltt.Enstrophy, ltt.EnergySpectrum, ltt.Mass)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_reporters_run_on_16_bit_state(dtype):
    """Every observable through ObservableReporter inside a run on a
    16-bit state, against the same observable on a float32 flow holding
    the same values."""
    ctx = ltt.Context(device="cpu", dtype=dtype)
    flow = ltt.TaylorGreenVortex(ctx, [16, 16], 100, 0.05,
                                 stencil=ltt.D2Q9())
    wide = ltt.TaylorGreenVortex(ltt.Context(device="cpu"), [16, 16], 100,
                                 0.05, stencil=ltt.D2Q9())
    outs = [[] for _ in OBSERVABLES]
    reporters = [ltt.ObservableReporter(cls(flow), interval=2, out=out)
                 for cls, out in zip(OBSERVABLES, outs)]
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.8), reporters)
    sim(4)
    ltt.state_from_numpy(wide, ctx.convert_to_ndarray(flow.f), i=4)
    for cls, out in zip(OBSERVABLES, outs):
        assert [row[0] for row in out] == [0, 2, 4]
        got = np.asarray(out[-1][2:])
        want = np.atleast_1d(to_numpy(cls(wide)()))
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=HALF_RTOL[dtype] * np.abs(want).max())


def test_mass_takes_a_numpy_mask():
    """Mass(flow, no_mass_mask=<numpy bool>) as lettuce_tpu's, on the 16^2
    TGV in float64, with the mask in numpy and in torch."""
    jflow, tflow = tgv_pair("float64", [16, 16], "D2Q9")
    mask = np.zeros((16, 16), dtype=bool)
    mask[3:6, 4:9] = True
    want = float(lt.Mass(jflow, no_mass_mask=mask)())
    for given in (mask, torch.as_tensor(mask)):
        got = float(ltt.Mass(tflow, no_mass_mask=given)())
        np.testing.assert_allclose(got, want, rtol=1e-12)
