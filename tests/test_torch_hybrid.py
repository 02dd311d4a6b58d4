"""Bounded flows on lettuce_tpu_torch's kernel path on the CPU: the masked
kernel step (plain versions inside) with the outlets' window replay
against lettuce_tpu's jnp step, gradients through it against
``jax.grad``, and the capability probe that chooses it.

A CPU simulation is routed through the kernel path with
``sim._use_kernel()``; its wrappers run their plain versions on CPU
tensors, so the wiring (gate, table, masks, replay, Function) is the one
the card runs. Inputs are seeded numpy states handed to both packages:
float64 to 1e-12, gradients to 1e-12 of the largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu_torch.ops.cuda.hybrid_outlets import nsm_outside_regions
from tests.torch_helpers import hand_state, noisy_state, to_numpy

RTOL = 1e-12


def _inlet_outlet_bb(pkg, flow):
    return pkg.Obstacle.boundaries.fget(flow)


def _outlet(kind, **kwargs):
    def boundaries(pkg, flow):
        inlet, _, bb = _inlet_outlet_bb(pkg, flow)
        direction = [1] + [0] * (len(flow.resolution) - 1)
        return [inlet, getattr(pkg, kind)(direction, flow, **kwargs), bb]
    return boundaries


def _parabolic_inlet(pkg, flow):
    _, outlet, bb = _inlet_outlet_bb(pkg, flow)
    nx, ny = flow.resolution
    y = np.linspace(0, 1, ny)
    velocity = np.stack([0.05 * 4 * y * (1 - y), np.zeros(ny)])[:, None, :]
    mask = np.zeros((nx, ny), dtype=bool)
    mask[0] = True
    return [pkg.EquilibriumBoundaryPU(flow.context, mask, velocity), outlet,
            bb]


def _two_outlets(pkg, flow):
    inlet, outlet, bb = _inlet_outlet_bb(pkg, flow)
    return [inlet, outlet, pkg.EquilibriumOutletP([0, 1], flow,
                                                  rho_outlet=1.0), bb]


OUTLETS = {
    "anti_bounce_back": _inlet_outlet_bb,
    "equilibrium_outlet_p": _outlet("EquilibriumOutletP", rho_outlet=1.0),
    "sponge": _outlet("SpongeOutlet", depth=4),
    "parabolic_inlet": _parabolic_inlet,
    "two_outlets": _two_outlets,
}


def obstacle(pkg, ctx, boundaries=_inlet_outlet_bb, resolution=(32, 128)):
    """tests/test_native.py's obstacle flows, in either package."""
    d = len(resolution)

    class Flow(pkg.Obstacle):
        @property
        def boundaries(self):
            return boundaries(pkg, self)

    flow = Flow(ctx, list(resolution), reynolds_number=80 if d == 2 else 50,
                mach_number=0.1, domain_length_x=3.2 if d == 2 else 1.6)
    centre = (1.0, 6.0) if d == 2 else (0.5, 0.8, 6.0)
    radius2 = 0.3 if d == 2 else 0.09
    flow.mask = sum((to_numpy(x) - c) ** 2
                    for x, c in zip(flow.grid, centre)) < radius2
    flow.initialize()
    return flow


def pair(make, dtype=("float64", jnp.float64, torch.float64)):
    jflow = make(lt, lt.Context(dtype=dtype[1], use_native=False))
    tflow = make(ltt, ltt.Context(device="cpu", dtype=dtype[2],
                                  use_native=False))
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=61, scale=1e-4))
    tau = float(jflow.units.relaxation_parameter_lu)
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), [])
    tsim = ltt.Simulation(tflow, ltt.BGKCollision(tau), [])
    tsim._use_kernel()
    assert jsim._step_kind == "jnp" and tsim._step_kind == "cuda"
    return jsim, tsim


def assert_scaled_close(got, want, rtol=RTOL):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ----------------------------------------------------------------------
# kernel step + window replay against the jnp step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(OUTLETS))
def test_hybrid_step_matches_jnp_step(name):
    """Eight steps of the masked kernel step with the replay against
    lettuce_tpu's jnp step (tests/test_native.py's hybrid cases)."""
    jsim, tsim = pair(lambda pkg, ctx: obstacle(pkg, ctx, OUTLETS[name]))
    assert tsim.step_path == "cuda+hybrid x1"
    jsim(8)
    tsim(8)
    np.testing.assert_allclose(to_numpy(tsim.flow.f),
                               np.asarray(jsim.flow.f), rtol=0, atol=1e-12)


def test_hybrid_step_matches_jnp_step_3d():
    jsim, tsim = pair(lambda pkg, ctx: obstacle(pkg, ctx,
                                                resolution=(16, 16, 128)))
    assert tsim.step_path == "cuda+hybrid x1"
    jsim(4)
    tsim(4)
    np.testing.assert_allclose(to_numpy(tsim.flow.f),
                               np.asarray(jsim.flow.f), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["cavity", "couette"])
def test_masked_step_matches_jnp_step(name):
    """Flows whose every boundary has a kernel kind: no replay."""
    def make(pkg, ctx):
        if name == "cavity":
            return pkg.Cavity2D(ctx, [32, 128], reynolds_number=100,
                                mach_number=0.1)
        return pkg.CouetteFlow2D(ctx, [16, 128], reynolds_number=10,
                                 mach_number=0.05)
    jsim, tsim = pair(make)
    assert tsim.step_path == "cuda x1"
    assert tsim._kernel_params["nsm"] is None
    jsim(6)
    tsim(6)
    np.testing.assert_allclose(to_numpy(tsim.flow.f),
                               np.asarray(jsim.flow.f), rtol=0, atol=1e-12)


def test_replay_drops_the_no_streaming_mask_only_inside_its_planes():
    _, tsim = pair(lambda pkg, ctx: obstacle(pkg, ctx))
    params = tsim._kernel_params
    assert params["nsm"] is None  # the outlet's frozen face is rewritten
    assert [kind for kind, _ in params["table"]] == [
        "collide", "identity", "bounce_back", "equilibrium_pu"]
    # the table was packed for the masks the kernel gets, so a launch
    # forwards it without checking again
    assert sc.checked_table(tsim.flow.f, params["ncm"], None,
                            params["table"],
                            params["feq_field"]) is params["table"]
    nsm = tsim.no_streaming_mask
    assert bool(nsm.any())
    regions = [(0, np.array([30, 31, 0]))]
    assert not nsm_outside_regions(nsm, regions)
    inner = nsm.clone()
    inner[:, 10, 10] = True
    assert nsm_outside_regions(inner, regions)


# ----------------------------------------------------------------------
# gradients against jax.grad
# ----------------------------------------------------------------------
GRAD_CASES = {"obstacle": "float64", "sponge": "float64", "cavity": "float64",
              "obstacle-float32": "float32"}
DTYPE_SETS = {"float64": ("float64", jnp.float64, torch.float64),
              "float32": ("float32", jnp.float32, torch.float32)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_matches_jax_grad(case):
    """A 3-step gradient of sum(u^2) through the kernel path (masked
    Function, then the replay under autograd) against jax.grad through
    lettuce_tpu's jnp step: 1e-12 (float64) and 1e-5 (float32) of the
    largest magnitude."""
    name, dtype_name = case.split("-")[0], GRAD_CASES[case]
    def make(pkg, ctx):
        if name == "cavity":
            return pkg.Cavity2D(ctx, [16, 128], reynolds_number=100,
                                mach_number=0.1)
        return obstacle(pkg, ctx, OUTLETS["sponge" if name == "sponge"
                                          else "anti_bounce_back"])
    jsim, tsim = pair(make, DTYPE_SETS[dtype_name])
    jflow, tflow = jsim.flow, tsim.flow

    def jloss(f):
        for _ in range(3):
            f = jsim._step(f)
        return jnp.sum(jflow.view(f).u() ** 2)

    want = jax.jit(jax.grad(jloss))(jflow.f)
    f0 = tflow.f.clone().requires_grad_(True)
    (tflow.view(tsim.make_segment_fn(3)(f0)).u() ** 2).sum().backward()
    assert_scaled_close(f0.grad, want,
                        RTOL if dtype_name == "float64" else 1e-5)


def test_hybrid_checkpointed_gradient_is_bitwise_equal():
    _, tsim = pair(lambda pkg, ctx: obstacle(pkg, ctx, _two_outlets),
                   dtype=("float32", jnp.float32, torch.float32))
    f0 = tsim.flow.f.clone().requires_grad_(True)
    grads = []
    for every in (None, 3):
        segment = tsim.make_segment_fn(8, checkpoint_every=every)
        (grad,) = torch.autograd.grad((segment(f0) ** 2).sum(), f0)
        grads.append(grad)
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])


def test_hybrid_path_never_writes_a_state_the_caller_holds():
    """The throughput loop's replay writes only into the simulation's own
    buffers and the fresh tensor of a run's last step."""
    _, tsim = pair(lambda pkg, ctx: obstacle(pkg, ctx))
    _, reference = pair(lambda pkg, ctx: obstacle(pkg, ctx))
    f0 = tsim.flow.f
    kept0 = f0.clone()
    tsim(3)
    f1 = tsim.flow.f
    kept1 = f1.clone()
    tsim(4)
    assert torch.equal(f0, kept0) and torch.equal(f1, kept1)
    owned = {b.data_ptr() for b in tsim._buffers if b is not None}
    assert f1.data_ptr() not in owned
    step = tsim.make_step_fn()
    with torch.no_grad():
        out = step(f1)
    assert torch.equal(f1, kept1) and out.data_ptr() != f1.data_ptr()
    reference(7)
    np.testing.assert_allclose(to_numpy(tsim.flow.f),
                               to_numpy(reference.flow.f), rtol=0,
                               atol=1e-12)


# ----------------------------------------------------------------------
# the capability probe and the gate agree
# ----------------------------------------------------------------------
class _WallPlane(ltt.BounceBackBoundary):
    """Sorts after SpongeOutlet, so it takes a plane out of the middle of
    the sponge's planes."""


def _probe(flow, collision, capsys):
    """(the probe's verdict on a CUDA context, what it printed, whether
    the gate accepts). The context says ``cuda`` only while the probe
    runs, so no card is needed: the probe makes host-side checks only."""
    sim = ltt.Simulation(flow, collision, [])
    capsys.readouterr()
    device = flow.context.device
    flow.context.device = torch.device("cuda", 0)
    try:
        ok = sim._native_supported()
    finally:
        flow.context.device = device
    printed = capsys.readouterr().out
    try:
        sc.gate_fused_params(sim)
        gate = True
    except NotImplementedError:
        gate = False
    if ok:
        sim._use_kernel()
        assert sim._step_kind == "cuda"
        # the table was checked against the state's own dtype
        assert sim._kernel_params["table"].checked[1] == flow.f.dtype
    return ok, printed, gate


def _cpu(dtype=torch.float32):
    return ltt.Context(device="cpu", dtype=dtype, use_native=True)


def _sponge_with(extra, depth=4):
    def boundaries(pkg, flow):
        return _outlet("SpongeOutlet", depth=depth)(pkg, flow) + extra(flow)
    return boundaries


PROBE_CASES = {
    "obstacle": (lambda: obstacle(ltt, _cpu()), None),
    "equilibrium_outlet_p": (lambda: obstacle(
        ltt, _cpu(), OUTLETS["equilibrium_outlet_p"]), None),
    "sponge": (lambda: obstacle(ltt, _cpu(), OUTLETS["sponge"]), None),
    "two_outlets": (lambda: obstacle(ltt, _cpu(), _two_outlets), None),
    "cavity": (lambda: ltt.Cavity2D(_cpu(), [16, 16], 100, 0.1), None),
    "couette": (lambda: ltt.CouetteFlow2D(_cpu(), [16, 16], 10, 0.05),
                None),
    "periodic_pressure": (lambda: obstacle(ltt, _cpu(), lambda pkg, flow: [
        pkg.PeriodicPressureBC(flow, 1e-3, pkg.BGKCollision(0.8))]),
        "boundary 'PeriodicPressureBC' does not support the CUDA kernel"),
    "planes_not_contiguous": (lambda: obstacle(ltt, _cpu(), _sponge_with(
        lambda flow: [_WallPlane(np.eye(32, dtype=bool)[29][:, None]
                                 .repeat(128, axis=1))])),
        "outlet planes are not contiguous"),
    "window_spans_axis": (lambda: obstacle(ltt, _cpu(), _sponge_with(
        lambda flow: [], depth=29)), "fix-up window spans the whole axis"),
    "outlet_owns_no_nodes": (lambda: obstacle(ltt, _cpu(), lambda pkg, flow: (
        _inlet_outlet_bb(pkg, flow) + [_WallPlane(
            np.eye(32, dtype=bool)[31][:, None].repeat(128, axis=1))])),
        "outlet owns no nodes"),
    # a 16-bit state runs its 16-bit instances (K1f): the gate checks the
    # table against the float16 state (test_probe_and_gate_agree)
    "float16": (lambda: ltt.Cavity2D(_cpu(torch.float16), [8, 8], 100,
                                     0.1), None),
}


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_probe_and_gate_agree(name, capsys):
    make, reason = PROBE_CASES[name]
    flow = make()
    ok, printed, gate = _probe(flow, ltt.BGKCollision(0.6), capsys)
    assert ok == gate == (reason is None)
    if reason is None:
        assert printed == ""
    else:
        assert "native was requested, but" in printed
        assert reason in printed


def test_probe_names_every_component(capsys):
    flow = obstacle(ltt, _cpu(), lambda pkg, flow: [
        pkg.PeriodicPressureBC(flow, 1e-3, pkg.BGKCollision(0.8))])
    ok, printed, gate = _probe(flow, ltt.SmagorinskyCollision(
        0.8, force=ltt.Guo(flow, 0.8, [1e-5, 0.0])), capsys)
    assert not ok and not gate
    assert "collision 'SmagorinskyCollision'" in printed
    assert "boundary 'PeriodicPressureBC'" in printed
