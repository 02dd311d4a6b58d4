"""Temporal blocking of lettuce_tpu_torch on the CPU: the blocked kernel's
(K2) plain version (``stream_collide_plain(..., n_sub=n)``) against
lettuce_tpu's Pallas kernel with ``n_sub`` sub-steps in interpret mode,
one case per fragment kind, at the JAX suite's sizes (D3Q19 16x16x128 at
n_sub 2, D2Q9 32x256 at n_sub 4); ``Simulation`` with ``LETTUCE_NSUB``
against lettuce_tpu's blocked Simulation, under half storage too, and
``rollout``; and what the blocked path refuses.

Tolerances: float64 to 1e-12 and float32 to 5e-6 (tests/test_native.py's
bound for the Pallas kernel against the jnp step). A 16-bit state within
one storage ulp of the larger magnitude plus ``n_sub`` times the float32
floor of tests/test_torch_half_storage.py (2^-23): both packages keep the
state in float32 between sub-steps and round once per launch, so only
their float32 roundoff of up to ``n_sub`` steps (the port's plain version
runs deviations in float64) can move an entry across a rounding boundary.
The CUDA kernels run only on a card; ``chip_smoke.py`` (phase 26) holds
each against these plain versions there."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
import lettuce_tpu_torch.simulation as simulation_module
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from tests.test_torch_half_storage import (DEV_FLOOR,
                                           assert_within_storage_ulp,
                                           kernel_args, tgv_case)
from tests.torch_helpers import to_numpy

TAU = 0.8
D3 = ("D3Q19", [16, 16, 128], 2)  # tests/test_native.py:464-491
D2 = ("D2Q9", [32, 256], 4)       # tests/test_adjoint.py:512-515
# fragment kind -> (stencil, grid, n_sub, collision factory)
CASES = {
    "bgk_d3q19": (*D3, lambda flow: ltt.BGKCollision(TAU)),
    "bgk_d2q9": (*D2, lambda flow: ltt.BGKCollision(TAU)),
    "bgk_force": (*D2, lambda flow: ltt.BGKCollision(
        TAU, force=ltt.Guo(flow, TAU, [1e-4, 0.0]))),
    "trt": (*D2, lambda flow: ltt.TRTCollision(TAU, 1.1)),
    "none": (*D2, lambda flow: ltt.NoCollision()),
    "kbc": (*D2, lambda flow: ltt.KBCCollision(TAU)),
    "reg": (*D2, lambda flow: ltt.RegularizedCollision(TAU)),
    "smag": (*D2, lambda flow: ltt.SmagorinskyCollision(TAU)),
    "mrt_lallemand": (*D2, lambda flow: ltt.MRTCollision(
        ltt.D2Q9Lallemand(flow.stencil, flow.context),
        [1.0, 1.0, 1.0, TAU, TAU, 1.2, 1.1, 1.1, 1.2], flow.context)),
    "mrt_from_feq": (*D3, lambda flow: ltt.MRTCollision(
        ltt.D3Q19DHumieres(flow.stencil, flow.context),
        [1.0] * 3 + [1.1, 1.2] * 8, flow.context)),
}
ATOL = {"float64": 1e-12, "float32": 5e-6}
# lettuce_tpu's MRT fragment is not float64-exact (one float64 step of the
# Pallas kernel differs from the port's plain step by 5.7e-10 for
# D'Humieres and 3.3e-9 for Lallemand, measured): the MRT kinds compare in
# float32, as tests/test_torch_fragments.py compares them
F32_ONLY = ("mrt_from_feq", "mrt_lallemand")
NP = {"float64": np.float64, "float32": np.float32}
TORCH = {"float64": torch.float64, "float32": torch.float32}


def pallas(x, st, spec, n_sub, dev_storage=False):
    """lettuce_tpu's fused kernel with ``n_sub`` sub-steps, interpreted."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fused_stream_collide(
            x, *kernel_args(st, spec), collision_spec=tuple(spec),
            dev_storage=dev_storage, n_sub=n_sub, interpret=True)


def case(name, seed):
    stencil_name, grid, n_sub, make = CASES[name]
    st, spec, f = tgv_case(stencil_name, grid, make, seed)
    return st, spec, f, n_sub


# ----------------------------------------------------------------------
# (a) the plain blocked step against the Pallas kernel with n_sub
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name,name",
                         [("float64", name) for name in sorted(CASES)
                          if name not in F32_ONLY]
                         + [("float32", name) for name in F32_ONLY]
                         + [("float32", "bgk_d3q19"), ("float32", "bgk_d2q9"),
                            ("float32", "trt")])
def test_plain_blocked_step_matches_pallas(dtype_name, name):
    st, spec, f, n_sub = case(name, seed=41)
    f = f.astype(NP[dtype_name])
    want = pallas(jnp.asarray(f), st, spec, n_sub)
    got = sc.stream_collide_plain(torch.as_tensor(f), *kernel_args(st, spec),
                                  collision_spec=spec, n_sub=n_sub)
    assert got.dtype == TORCH[dtype_name]
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=ATOL[dtype_name])


@pytest.mark.parametrize("storage,name", [("bf16_dev", "bgk_d3q19"),
                                          ("bf16_dev", "trt"),
                                          ("bf16_dev", "reg"),
                                          ("bf16", "bgk_d2q9")])
def test_plain_blocked_16_bit_matches_pallas(storage, name):
    """One launch of n_sub sub-steps on a bfloat16 state or bfloat16
    deviations: both round once, at the end."""
    st, spec, f, n_sub = case(name, seed=43)
    dev = storage == "bf16_dev"
    w = np.asarray(st.w, dtype=np.float32).reshape((-1,) + (1,) * st.d)
    x = (jnp.asarray(f) - jnp.asarray(w)) if dev else jnp.asarray(f)
    x = x.astype(jnp.bfloat16)
    want = pallas(x, st, spec, n_sub, dev_storage=dev)
    got = sc.stream_collide_plain(
        torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16),
        *kernel_args(st, spec), collision_spec=spec, dev_storage=dev,
        n_sub=n_sub)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_within_storage_ulp(got, np.asarray(want, dtype=np.float32),
                              torch.bfloat16, floor=n_sub * DEV_FLOOR)


def test_plain_blocked_step_is_n_single_steps():
    """In float64 the plain blocked step is n_sub plain steps, and the
    wrapper on a CPU tensor is the plain version."""
    st, spec, f, _ = case("trt", seed=45)
    x = torch.as_tensor(f.astype(np.float64))
    want = x
    for _ in range(3):
        want = sc.stream_collide_plain(want, *kernel_args(st, spec),
                                       collision_spec=spec)
    got = sc.stream_collide(x, *kernel_args(st, spec), collision_spec=spec,
                            n_sub=3)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# (b) Simulation's blocked bulk against lettuce_tpu's
# ----------------------------------------------------------------------
def _tgv(pkg, ctx, grid, stencil):
    return pkg.TaylorGreenVortex(ctx, grid, 100, 0.05,
                                 stencil=getattr(pkg, stencil)(),
                                 initialize_fneq=False)


def counted_launches(monkeypatch):
    """The span of every stream_collide call the Simulation makes, and
    whether it stepped deviations."""
    calls = []
    real = simulation_module.stream_collide

    def counted(f, **kwargs):
        calls.append((kwargs.get("n_sub", 1),
                      kwargs.get("dev_storage", False)))
        return real(f, **kwargs)

    monkeypatch.setattr(simulation_module, "stream_collide", counted)
    return calls


def port_kernel(flow, collision, half_storage=False):
    """A port Simulation on the kernel path (its wrappers run their plain
    versions on CPU tensors), half storage engaged if asked for."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        sim = ltt.Simulation(flow, collision, [], half_storage=half_storage)
    sim._use_kernel()
    if half_storage:
        sim._use_half_storage()
        assert sim.half_storage_engaged
    return sim


@pytest.mark.parametrize("dtype_name,stencil,grid",
                         [("float32", "D3Q19", [16, 16, 128]),
                          ("float64", "D2Q9", [32, 256])],
                         ids=["d3q19-float32", "d2q9-float64"])
def test_blocked_simulation_matches_lettuce_tpu(dtype_name, stencil, grid,
                                                monkeypatch):
    """5 steps with LETTUCE_NSUB=2: two blocked launches and one
    single-step launch, as lettuce_tpu's _run_mixed, ending where its
    blocked Simulation ends."""
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    jflow = _tgv(lt, lt.Context(dtype=getattr(jnp, dtype_name),
                                use_native=True), grid, stencil)
    jsim = lt.Simulation(jflow, lt.BGKCollision(
        jflow.units.relaxation_parameter_lu), [])
    assert jsim.step_path == "pallas x2"
    jsim(5)

    tflow = _tgv(ltt, ltt.Context(device="cpu", dtype=TORCH[dtype_name]),
                 grid, stencil)
    tsim = port_kernel(tflow, ltt.BGKCollision(
        tflow.units.relaxation_parameter_lu))
    assert tsim.step_path == "cuda x2"
    calls = counted_launches(monkeypatch)
    tsim(5)
    assert calls == [(2, False), (2, False), (1, False)]
    assert tflow.i == 5
    np.testing.assert_allclose(to_numpy(tflow.f), np.asarray(jflow.f),
                               rtol=0, atol=ATOL[dtype_name])


def _u_rel(u, ref):
    u, ref = np.asarray(u, dtype=np.float64), np.asarray(ref, np.float64)
    return float(np.abs(u - ref).max() / np.abs(ref).max())


def test_blocked_half_storage_matches_lettuce_tpu(monkeypatch):
    """tests/test_torch_half_simulation.py's bounds for the blocked half
    path: 6 steps in three bf16-dev launches of span 2, u within 5e-3 of
    max|u| of lettuce_tpu's blocked half run, mass to 1e-4."""
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    grid = [16, 16, 128]
    jflow = _tgv(lt, lt.Context(dtype=jnp.float32, use_native=True), grid,
                 "D3Q19")
    jsim = lt.Simulation(jflow, lt.BGKCollision(
        jflow.units.relaxation_parameter_lu), [], half_storage=True)
    assert jsim._step_dev_multi is not None and jsim.step_path == "pallas x2"
    jsim(6)

    tflow = _tgv(ltt, ltt.Context(device="cpu", dtype=torch.float32), grid,
                 "D3Q19")
    tsim = port_kernel(tflow, ltt.BGKCollision(
        tflow.units.relaxation_parameter_lu), half_storage=True)
    assert tsim.step_path == "cuda x2"
    mass0 = float(tflow.rho().sum())
    calls = counted_launches(monkeypatch)
    tsim(6)
    assert calls == [(2, True)] * 3
    assert tflow.f.dtype == torch.float32
    assert _u_rel(to_numpy(tflow.u()), jflow.u()) < 5e-3
    np.testing.assert_allclose(float(tflow.rho().sum()), mass0, rtol=1e-4)
    np.testing.assert_allclose(float(tflow.rho().sum()),
                               float(jflow.rho().sum()), rtol=1e-4)


@pytest.mark.parametrize("half", [False, True], ids=["float32", "half"])
def test_blocked_rollout_equals_a_call(half, monkeypatch):
    """rollout(20, [energy], interval=4) at span 2 (every chunk a whole
    number of spans) ends bitwise where simulation(20) does, and both run
    ten blocked launches."""
    monkeypatch.setenv("LETTUCE_NSUB", "2")

    def make():
        flow = _tgv(ltt, ltt.Context(device="cpu", dtype=torch.float32),
                    [8, 8, 16], "D3Q19")
        return port_kernel(flow, ltt.BGKCollision(
            flow.units.relaxation_parameter_lu), half_storage=half)

    calls = counted_launches(monkeypatch)
    a = make()
    records = a.rollout(20, [ltt.IncompressibleKineticEnergy(a.flow)],
                        interval=4)
    assert tuple(records.shape) == (5, 1)
    assert bool(torch.isfinite(records).all())
    assert calls == [(2, half)] * 10
    b = make()
    b(20)
    assert torch.equal(a.flow.f, b.flow.f) and a.flow.i == b.flow.i == 20


# ----------------------------------------------------------------------
# (c) what the blocked path refuses
# ----------------------------------------------------------------------
def test_blocking_is_off_by_default(monkeypatch):
    monkeypatch.delenv("LETTUCE_NSUB", raising=False)
    flow = _tgv(ltt, ltt.Context(device="cpu"), [8, 8], "D2Q9")
    sim = port_kernel(flow, ltt.BGKCollision(0.8))
    assert sim._step_multi is None and sim.step_path == "cuda x1"
    assert sc.build_fused_multi_step(sim) is None
    assert sc.build_fused_multi_step(sim, n_sub=3)[1] == 3
    monkeypatch.setenv("LETTUCE_NSUB", "0")
    assert sc.build_fused_multi_step(sim, n_sub=3) is None
    sim._use_kernel()
    assert sim.step_path == "cuda x1"


def test_masked_flow_keeps_the_single_step_kernel(monkeypatch, capsys):
    """What the blocked path still refuses for a bounded flow keeps the
    single-step (masked) kernel, and the reason is printed, as the
    capability probe prints its reasons: an outlet whose replay window at
    the span covers its whole axis (lettuce_tpu :2328-2331), and an outlet
    under deviation storage (:2220). A masked flow otherwise blocks."""
    from tests.test_torch_hybrid import obstacle
    monkeypatch.setenv("LETTUCE_NSUB", "4")
    flow = obstacle(ltt, ltt.Context(device="cpu", dtype=torch.float64),
                    resolution=(16, 128))
    sim = port_kernel(flow, ltt.BGKCollision(
        flow.units.relaxation_parameter_lu))
    assert sim._step_multi is None and sim.step_path == "cuda+hybrid x1"
    printed = capsys.readouterr().out
    assert ("temporal blocking (span 4) was requested, but outlet "
            "'AntiBounceBackOutlet' has no window replay at span 4 (fix-up "
            "window spans the whole axis (17 planes at span 4, axis of 16))"
            in printed)
    calls = counted_launches(monkeypatch)
    sim(3)
    assert calls == [(1, False)] * 3
    assert sc.build_fused_multi_step(sim, dev_storage=True, n_sub=2) is None
    assert "the window replay operates on f, not on deviations" in \
        capsys.readouterr().out
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    sim._use_kernel()
    assert sim.step_path == "cuda+hybrid x2"
    couette = ltt.CouetteFlow2D(ltt.Context(device="cpu",
                                            dtype=torch.float64),
                                [16, 32], reynolds_number=10,
                                mach_number=0.05)
    assert port_kernel(couette, ltt.BGKCollision(0.8)).step_path == "cuda x2"


def test_blocked_wrapper_refusals():
    st = ltt.D2Q9()
    flow = _tgv(ltt, ltt.Context(device="cpu", dtype=torch.float64), [6, 8],
                "D2Q9")
    f = flow.f
    args = (st.e, st.w, st.opposite, st.cs, 1.0 / TAU)
    u = torch.empty((2, 6, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="emit_u"):
        sc.stream_collide(f, *args, u_out=u, n_sub=2)
    with pytest.raises(ValueError, match="emit_u"):
        sc.stream_collide_plain(f, *args, emit_u=True, n_sub=2)
    # masks run at any span: n_sub masked steps
    masks = dict(ncm=torch.zeros((6, 8), dtype=torch.uint8),
                 table=[("collide", None)])
    assert torch.equal(sc.stream_collide(f, *args, **masks, n_sub=2),
                       sc.stream_collide_plain(f, *args, n_sub=2))
    with pytest.raises(ValueError, match="requires grad"):
        sc.stream_collide(f.clone().requires_grad_(True), *args, n_sub=2)
    with pytest.raises(ValueError, match="positive integer"):
        sc.stream_collide(f, *args, n_sub=0)
    # without grad mode a state that requires grad steps as any other
    with torch.no_grad():
        out = sc.stream_collide(f.clone().requires_grad_(True), *args,
                                n_sub=2)
    assert torch.equal(out, sc.stream_collide_plain(f, *args, n_sub=2))


def test_span_beyond_the_tile_raises(monkeypatch):
    """A span whose halo no tile holds raises when the step is built."""
    monkeypatch.setenv("LETTUCE_NSUB", "40")
    flow = _tgv(ltt, ltt.Context(device="cpu"), [8, 8, 8], "D3Q19")
    with pytest.raises(ValueError, match="halo of 40"):
        port_kernel(flow, ltt.BGKCollision(0.8))
