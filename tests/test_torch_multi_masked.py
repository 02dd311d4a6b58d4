"""Temporal blocking of bounded flows in lettuce_tpu_torch on the CPU: the
masked blocked kernel's (K2 masked) plain version against lettuce_tpu's
Pallas kernel with ``n_sub`` sub-steps and masks in interpret mode, one
case per fragment kind; ``Simulation`` under ``LETTUCE_NSUB=2`` on the
kernel path (boundary codes, frozen populations, the per-node inlet, the
outlets' window replay at span 2) against lettuce_tpu's blocked
``Simulation`` at the JAX suite's sizes (tests/test_native.py:494-770);
and what the blocked path of a bounded flow keeps single-step.

A CPU simulation is routed through the kernel path with
``sim._use_kernel()``; its wrappers run their plain versions on CPU
tensors, so the wiring (gate, table, masks, both replays, which of the
two kernels reads the no-streaming mask) is the one the card runs.
Tolerances: float64 to 1e-12 (the outlets to 1e-13, as
tests/test_native.py holds lettuce_tpu's blocked hybrid path) and float32
to 5e-6; half storage within tests/test_torch_half_simulation.py's
bounds. The CUDA kernel runs only on a card; ``chip_smoke.py`` holds each
masked K2 instance against these plain versions there. The file takes
about 125 s in one process, most of it lettuce_tpu's interpret-mode
compiles."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.fused_step as fused_step_module
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from tests.conftest import TestFlow
from tests.test_torch_bounded_kernel import JAX_KINDS, bounded_case
from tests.test_torch_half_storage import kernel_args, tgv_case
from tests.test_torch_hybrid import OUTLETS, obstacle
from tests.test_torch_multi_step import (CASES, counted_launches,
                                         port_kernel)
from tests.torch_helpers import (DTYPES, TorchTestFlow, hand_state,
                                 launch_counts, noisy_state, to_numpy)

NSUB = "2"


def pallas_masked(x, st, spec, ncm, nsm, feq, table, n_sub):
    """lettuce_tpu's fused kernel with masks and ``n_sub`` sub-steps,
    interpreted."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fused_stream_collide(
            x, *kernel_args(st, spec), collision_spec=tuple(spec),
            no_collision_mask=jnp.asarray(ncm),
            no_streaming_mask=None if nsm is None else jnp.asarray(nsm),
            boundary_kinds=JAX_KINDS,
            feq_boundary=(None, table[2][1], None, None),
            feq_field=jnp.asarray(feq, dtype=x.dtype), n_sub=n_sub,
            interpret=True)


# ----------------------------------------------------------------------
# (a) the plain masked blocked step against the Pallas kernel with n_sub
# ----------------------------------------------------------------------
# one fragment per kind at D2Q9 16x128, with the codes and frozen
# populations, in float64 but MRT in float32
# (tests/test_torch_multi_step.py:58-62); BGK also in float32 and with the
# codes alone (the blocked launch without the no-streaming mask)
MASKED_CASES = ([("float64", name, True) for name in
                 ("bgk_d2q9", "bgk_force", "trt", "none", "kbc", "reg",
                  "smag")]
                + [("float32", "mrt_lallemand", True),
                   ("float32", "bgk_d2q9", True),
                   ("float64", "bgk_d2q9", False)])


@pytest.mark.parametrize("dtype_name,name,frozen", MASKED_CASES)
def test_plain_masked_blocked_step_matches_pallas(dtype_name, name, frozen):
    """Two sub-steps of the boundary codes (bounce back, a constant and a
    per-node equilibrium, identity) and, with ``frozen``, a frozen plane
    and frozen odd populations, on the TGV state: every kind applied on
    every sub-step in both packages."""
    grid = (16, 128)
    st, spec, f = tgv_case(CASES[name][0], list(grid), CASES[name][3],
                           seed=7)
    _, ncm, nsm, feq, table = bounded_case(st, grid, 8, frozen)
    jax_dtype, torch_dtype, atol = DTYPES[dtype_name]
    want = pallas_masked(jnp.asarray(f, dtype=jax_dtype), st, spec, ncm, nsm,
                         feq, table, 2)
    got = sc.stream_collide_plain(
        torch.as_tensor(f, dtype=torch_dtype), *kernel_args(st, spec),
        collision_spec=spec, ncm=torch.as_tensor(ncm),
        nsm=None if nsm is None else torch.as_tensor(nsm), table=table,
        feq_field=torch.as_tensor(feq, dtype=torch_dtype), n_sub=2)
    assert got.dtype == torch_dtype
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_wrapper_takes_masks_at_any_span():
    """On a CPU tensor the wrapper's masked blocked step is n_sub plain
    masked steps, bitwise, and counts no launch."""
    st = ltt.D2Q9()
    f, ncm, nsm, feq, table = bounded_case(st, (16, 32), 9, True)
    x = torch.as_tensor(f)
    masks = dict(ncm=torch.as_tensor(ncm), nsm=torch.as_tensor(nsm),
                 table=table, feq_field=torch.as_tensor(feq))
    args = (st.e, st.w, st.opposite, st.cs, 1.0 / 0.7)
    want = x
    for _ in range(3):
        want = sc.stream_collide_plain(want, *args, **masks)
    before = launch_counts("K2")
    assert torch.equal(sc.stream_collide(x, *args, **masks, n_sub=3), want)
    assert launch_counts("K2") == before


# ----------------------------------------------------------------------
# (b) the blocked Simulation of a bounded flow against lettuce_tpu's
# ----------------------------------------------------------------------
def blocked_pair(make, monkeypatch, dtype_name="float64", seed=71):
    """lettuce_tpu's blocked Simulation (interpret mode) and the port's on
    the kernel path, both under LETTUCE_NSUB=2, from one noisy state."""
    monkeypatch.setenv("LETTUCE_NSUB", NSUB)
    jax_dtype, torch_dtype, _ = DTYPES[dtype_name]
    jflow = make(lt, lt.Context(dtype=jax_dtype, use_native=True))
    tflow = make(ltt, ltt.Context(device="cpu", dtype=torch_dtype,
                                  use_native=False))
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=seed, scale=1e-4))
    tau = float(jflow.units.relaxation_parameter_lu)
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), [])
    assert jsim._step_multi is not None and jsim._step_multi[1] == 2
    tsim = port_kernel(tflow, ltt.BGKCollision(tau))
    return jsim, tsim


def couette(pkg, ctx):
    return pkg.CouetteFlow2D(ctx, [16, 128], reynolds_number=10,
                             mach_number=0.05)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_blocked_couette_matches_lettuce_tpu(dtype_name, monkeypatch):
    """tests/test_native.py:494-518's Couette flow (bounce back, a moving
    equilibrium wall): 5 steps in two masked blocked launches and one
    single-step launch, as lettuce_tpu's _run_mixed."""
    jsim, tsim = blocked_pair(couette, monkeypatch, dtype_name)
    assert tsim.step_path == "cuda x2"
    calls = counted_launches(monkeypatch)
    jsim(5)
    tsim(5)
    assert calls == [(2, False), (2, False), (1, False)]
    np.testing.assert_allclose(to_numpy(tsim.flow.f), np.asarray(jsim.flow.f),
                               rtol=0, atol=DTYPES[dtype_name][2])


def frozen_blob(shape, lo, hi):
    """A boundary class (per package) freezing every population in the box
    [lo, hi), which it also bounces back (tests/test_native.py:521-586)."""
    mask = np.zeros(shape, dtype=bool)
    mask[tuple(slice(a, b) for a, b in zip(lo, hi))] = True

    def make(pkg, ctx):
        class Frozen(pkg.BounceBackBoundary):
            def make_no_streaming_mask(self, nsm_shape, context):
                m = np.zeros(tuple(nsm_shape), dtype=bool)
                m[(slice(None),) + tuple(slice(a, b)
                                         for a, b in zip(lo, hi))] = True
                return context.convert_to_tensor(m)

        flow_cls = TestFlow if pkg is lt else TorchTestFlow
        return flow_cls(ctx, list(shape), stencil=(
            pkg.D2Q9() if len(shape) == 2 else pkg.D3Q19()),
            boundaries=[Frozen(mask)])
    return make


@pytest.mark.parametrize("shape,lo,hi", [
    ((16, 128), (7, 30), (9, 50)),
    ((16, 16, 128), (6, 5, 40), (9, 10, 80))], ids=["2d", "3d"])
def test_blocked_frozen_blob_matches_lettuce_tpu(shape, lo, hi,
                                                 monkeypatch):
    """Interior frozen populations on every sub-step: the blocked launch
    keeps the no-streaming mask (no replay rewrites it)."""
    jsim, tsim = blocked_pair(frozen_blob(shape, lo, hi), monkeypatch)
    step = tsim._step_multi[0]
    assert tsim.step_path == "cuda x2" and step.params["nsm"] is not None
    jsim(5)
    tsim(5)
    np.testing.assert_allclose(to_numpy(tsim.flow.f), np.asarray(jsim.flow.f),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["anti_bounce_back", "equilibrium_outlet_p",
                                  "parabolic_inlet"])
def test_blocked_outlets_match_lettuce_tpu(name, monkeypatch):
    """The obstacle with an anti-bounce-back outlet, an equilibrium
    pressure outlet, and the per-node parabolic inlet with an outlet
    (tests/test_native.py:648-770): masked blocked launches, each followed
    by the replay at span 2, and a single-step remainder with the replay
    at span 1, to 1e-13."""
    jsim, tsim = blocked_pair(lambda pkg, ctx: obstacle(pkg, ctx,
                                                        OUTLETS[name]),
                              monkeypatch)
    assert tsim.step_path == "cuda+hybrid x2"
    step = tsim._step_multi[0]
    assert step.fixup is not None and step.fixup is not tsim._fixup
    # every frozen population lies on the outlet's planes: neither kernel
    # reads the no-streaming mask
    assert step.params["nsm"] is None and tsim._kernel_params["nsm"] is None
    calls = counted_launches(monkeypatch)
    jsim(5)
    tsim(5)
    assert calls == [(2, False), (2, False), (1, False)]
    np.testing.assert_allclose(to_numpy(tsim.flow.f), np.asarray(jsim.flow.f),
                               rtol=0, atol=1e-13)


def test_blocked_replay_rewrites_the_cone():
    """The replay at span n rewrites the outlet's planes +- n: the x2
    replay's planes are a superset of the x1 replay's."""
    from lettuce_tpu_torch.ops.cuda.hybrid_outlets import build_hybrid_fixup
    flow = obstacle(ltt, ltt.Context(device="cpu", dtype=torch.float64,
                                     use_native=False))
    sim = port_kernel(flow, ltt.BGKCollision(
        flow.units.relaxation_parameter_lu))
    hybrid = sc.gate_fused_params(sim)[1]
    planes = {n: build_hybrid_fixup(sim, hybrid, n_sub=n)[1][0][1]
              for n in (1, 2, 3)}
    nx = flow.resolution[0]
    for n, rewritten in planes.items():
        assert sorted(rewritten) == sorted((nx - 1 + k) % nx
                                           for k in range(-n, n + 1))
    assert set(planes[1]) < set(planes[2]) < set(planes[3])


def test_blocked_cavity_half_storage_matches_lettuce_tpu(monkeypatch):
    """The cavity under half storage at span 2: 6 steps in three bf16-dev
    masked blocked launches, u within 5e-3 of max|u| of lettuce_tpu's
    blocked half run, mass to 1e-4 (tests/test_torch_half_simulation.py's
    bounds)."""
    monkeypatch.setenv("LETTUCE_NSUB", NSUB)

    def make(pkg, ctx):
        return pkg.Cavity2D(ctx, [32, 128], reynolds_number=100,
                            mach_number=0.1)

    jflow = make(lt, lt.Context(dtype=jnp.float32, use_native=True))
    jsim = lt.Simulation(jflow, lt.BGKCollision(
        jflow.units.relaxation_parameter_lu), [], half_storage=True)
    assert jsim._step_dev_multi is not None
    jsim(6)
    tflow = make(ltt, ltt.Context(device="cpu", dtype=torch.float32,
                                  use_native=False))
    tsim = port_kernel(tflow, ltt.BGKCollision(
        tflow.units.relaxation_parameter_lu), half_storage=True)
    assert tsim.step_path == "cuda x2"
    mass0 = float(tflow.rho().sum())
    calls = counted_launches(monkeypatch)
    tsim(6)
    assert calls == [(2, True)] * 3
    u, ref = to_numpy(tflow.u()), np.asarray(jflow.u(), dtype=np.float64)
    assert float(np.abs(u - ref).max() / np.abs(ref).max()) < 5e-3
    np.testing.assert_allclose(float(tflow.rho().sum()), mass0, rtol=1e-4)


# ----------------------------------------------------------------------
# (c) what a bounded flow keeps single-step
# ----------------------------------------------------------------------
def test_masked_blocked_step_has_no_blocked_adjoint(monkeypatch):
    """Masks (and a replay) keep gradients on the single-step kernels, as
    lettuce_tpu does (:2360-2362): adjoint_kernel is False,
    make_segment_fn steps one step per launch, and the blocked step
    refuses a state that requires grad."""
    monkeypatch.setenv("LETTUCE_NSUB", NSUB)
    for make in (couette, lambda pkg, ctx: obstacle(pkg, ctx)):
        flow = make(ltt, ltt.Context(device="cpu", dtype=torch.float64,
                                     use_native=False))
        sim = port_kernel(flow, ltt.BGKCollision(
            flow.units.relaxation_parameter_lu))
        step = sim._step_multi[0]
        assert step.adjoint_kernel is False
        f0 = flow.f.clone().requires_grad_(True)
        spans = []
        real = fused_step_module.stream_collide

        def counted(f, **kwargs):
            spans.append(kwargs.get("n_sub", 1))
            return real(f, **kwargs)

        monkeypatch.setattr(fused_step_module, "stream_collide", counted)
        grad_fn = sim.make_segment_fn(4)
        (grad,) = torch.autograd.grad((grad_fn(f0) ** 2).sum(), f0)
        monkeypatch.setattr(fused_step_module, "stream_collide", real)
        assert spans == [1] * 4 and bool(torch.isfinite(grad).all())
        ref = f0.detach()
        for _ in range(4):
            ref = sim._torch_step(ref)
        with torch.no_grad():
            np.testing.assert_allclose(to_numpy(grad_fn(f0)), to_numpy(ref),
                                       rtol=0, atol=1e-12)
        with pytest.raises(NotImplementedError, match="periodic grids"):
            step(f0)
