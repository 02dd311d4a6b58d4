"""16-bit state (K1f) of lettuce_tpu_torch's kernel on the CPU, and the
refusals of half storage.

The plain step on a bfloat16 and a float16 state against lettuce_tpu's
Pallas kernel in interpret mode (which stores 16 bits and computes in
float32, ``stream_collide.py:1492-1495``): BGK, TRT, the closed-form D2Q9
Lallemand MRT, and BGK with the bounded codes, over 1 and 3 steps along the
Pallas trajectory, every entry within one ulp of the storage type at the
larger magnitude. Then what half storage refuses (the closed-form MRT
bases, outlets, the torch step), each warning with its reason and running
at full precision; a 16-bit state that requires grad on the kernel path
(the 16-bit emit-u forward and adjoint; tests/test_torch_half_gradient.py
holds them against lettuce_tpu); and the CLI's ``--half-storage`` and
``-p half``."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch import cli
from tests.test_torch_bounded_kernel import JAX_KINDS, bounded_case
from tests.test_torch_hybrid import OUTLETS, obstacle
from tests.test_torch_half_storage import assert_within_storage_ulp

GRID = [16, 128]
D2_TAUS = [1.0, 1.0, 1.0, 1.3, 1.3, 1.2, 1.1, 1.1, 1.2]
STATES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
COLLISIONS = {
    "bgk": lambda flow: ltt.BGKCollision(0.8),
    "trt": lambda flow: ltt.TRTCollision(0.8, 1.1),
    "mrt_lallemand": lambda flow: ltt.MRTCollision(
        ltt.D2Q9Lallemand(flow.stencil, flow.context), D2_TAUS,
        flow.context),
}


def kernel_args(st, spec):
    return (np.asarray(st.e), np.asarray(st.w), np.asarray(st.opposite),
            float(st.cs), spec[1] if spec[0] == "bgk" else None)


def tgv_case(make):
    """(stencil, packed spec, float32 numpy state): the D2Q9 TGV plus
    seeded noise."""
    ctx = ltt.Context(device="cpu", dtype=torch.float32, use_native=False)
    flow = ltt.TaylorGreenVortex(ctx, GRID, 100, 0.05, stencil=ltt.D2Q9(),
                                 initialize_fneq=False)
    f = flow.f.numpy() + 1e-4 * np.random.default_rng(32).standard_normal(
        tuple(flow.f.shape))
    spec, reason = sc.collision_spec_of(ltt.Simulation(flow, make(flow), []))
    assert reason is None
    st = flow.stencil
    return st, sc.pack_spec(spec, st.e, st.w, st.opposite), f


def check_trajectory(st, spec, f, state, jax_masks=None, torch_masks=None):
    """Steps 1 and 3 of both packages from the Pallas state of the step
    before, each within one storage ulp."""
    torch_dtype, jax_dtype = STATES[state]
    want = jnp.asarray(np.asarray(f, dtype=np.float32)).astype(jax_dtype)
    for step in (1, 2, 3):
        start = torch.as_tensor(np.asarray(want, dtype=np.float32)).to(
            torch_dtype)
        got = sc.stream_collide_plain(start, *kernel_args(st, spec),
                                      collision_spec=spec,
                                      **(torch_masks or {}))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = fused_stream_collide(
                want, *kernel_args(st, spec), collision_spec=tuple(spec),
                interpret=True, **(jax_masks or {}))
        assert got.dtype == torch_dtype and want.dtype == jax_dtype
        if step != 2:
            differ = assert_within_storage_ulp(got, want, torch_dtype)
            assert differ <= 0.05, (state, step, differ)


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("collision", sorted(COLLISIONS))
def test_plain_16_bit_step_matches_pallas(collision, state):
    st, spec, f = tgv_case(COLLISIONS[collision])
    check_trajectory(st, spec, f, state)


@pytest.mark.parametrize("state", sorted(STATES))
def test_plain_16_bit_masked_step_matches_pallas(state):
    st = ltt.D2Q9()
    f, ncm, nsm, feq, table = bounded_case(st, tuple(GRID), 44, True)
    spec = sc.pack_spec(("bgk", 1.0 / 0.6), st.e, st.w, st.opposite)
    jax_masks = dict(no_collision_mask=jnp.asarray(ncm),
                     no_streaming_mask=jnp.asarray(nsm),
                     boundary_kinds=JAX_KINDS,
                     feq_boundary=(None, table[2][1], None, None),
                     feq_field=jnp.asarray(feq, dtype=jnp.float32))
    torch_masks = dict(ncm=torch.as_tensor(ncm), nsm=torch.as_tensor(nsm),
                       table=table, feq_field=torch.as_tensor(
                           feq, dtype=torch.float32).to(STATES[state][0]))
    check_trajectory(st, spec, f, state, jax_masks, torch_masks)


# ----------------------------------------------------------------------
# what half storage refuses
# ----------------------------------------------------------------------
def _tgv(dtype=torch.float32):
    ctx = ltt.Context(device="cpu", dtype=dtype, use_native=True)
    return ltt.TaylorGreenVortex(ctx, [16, 16], 100, 0.05,
                                 stencil=ltt.D2Q9(), initialize_fneq=False)


def _refused(sim, reason):
    """On the kernel path, half storage warns with ``reason``, leaves the
    deviation instances out and runs the full-precision kernel path."""
    sim._use_kernel()
    with pytest.warns(UserWarning, match="running at full precision") as rec:
        sim._use_half_storage()
    assert reason in str(rec[0].message)
    assert not sim.half_storage_engaged
    with pytest.raises(NotImplementedError, match=reason):
        sc.gate_fused_params(sim, dev_storage=True)
    f0 = sim.flow.f.clone()
    sim(2)
    assert sim.flow.f.dtype == f0.dtype and sim.flow.i == 2
    assert bool(torch.isfinite(sim.flow.f).all())


def test_half_storage_refuses_analytic_mrt():
    flow = _tgv()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        sim = ltt.Simulation(flow, COLLISIONS["mrt_lallemand"](flow), [],
                             half_storage=True)
    _refused(sim, "analytic-moment MRT fragment is not shift-invariant")


def test_half_storage_refuses_outlets():
    flow = obstacle(ltt, ltt.Context(device="cpu", dtype=torch.float32),
                    OUTLETS["equilibrium_outlet_p"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [],
                             half_storage=True)
    _refused(sim, "the window replay operates on f")


def test_half_storage_warns_on_the_torch_step():
    flow = _tgv()
    with pytest.warns(UserWarning, match="the torch step runs"):
        sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [],
                             half_storage=True)
    assert sim._step_kind == "torch" and not sim.half_storage_engaged
    sim(2)
    assert sim.flow.f.dtype == torch.float32


def test_deviation_refusals_leave_the_probe_alone():
    """The refusals of deviation storage are not the kernel path's: the
    probe's list stays empty for the analytic MRT."""
    flow = _tgv()
    sim = ltt.Simulation(flow, COLLISIONS["mrt_lallemand"](flow), [])
    assert sc.kernel_refusals(sim) == []
    assert len(sc.kernel_refusals(sim, dev_storage=True)) == 1
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [])
    assert sc.kernel_refusals(sim, dev_storage=True) == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_16_bit_gradient_raises_on_the_kernel_path(dtype, monkeypatch):
    """A 16-bit state that requires grad on the kernel path no longer
    raises: it runs the 16-bit emit-u forward and the 16-bit adjoint
    (their plain versions on the CPU, counted where the wrappers call
    them), through the step function and through a call; the gradient is
    finite, non-zero and in the state's dtype, and the forward saves u in
    float32. (The name is the one this test had when the gradient
    raised.)"""
    import lettuce_tpu_torch.ops.cuda.adjoint as ad
    flow = _tgv(dtype)
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.6), [])
    f0 = flow.f.clone().requires_grad_(True)
    assert sim.make_step_fn()(f0).dtype == dtype  # torch step: autograd
    sim._use_kernel()
    calls = []
    forward, backward = sc.stream_collide_plain, ad.stream_collide_adjoint_plain

    def counted_forward(f, *args, **kwargs):
        out = forward(f, *args, **kwargs)
        if kwargs.get("emit_u"):
            calls.append(("emit_u", f.dtype, out[1].dtype))
        return out

    def counted_backward(g, res, *args, **kwargs):
        calls.append(("adjoint", g.dtype, res.dtype))
        return backward(g, res, *args, **kwargs)

    monkeypatch.setattr(sc, "stream_collide_plain", counted_forward)
    monkeypatch.setattr(ad, "stream_collide_adjoint_plain", counted_backward)
    (grad,) = torch.autograd.grad(
        (sim.make_step_fn()(f0).float() ** 2).sum(), f0)
    assert calls == [("emit_u", dtype, torch.float32),
                     ("adjoint", dtype, torch.float32)]
    assert grad.dtype == dtype and bool(torch.isfinite(grad.float()).all())
    assert float(grad.float().abs().max()) > 0
    flow.f = f0
    sim(1)
    (grad_call,) = torch.autograd.grad((flow.f.float() ** 2).sum(), f0)
    assert len(calls) == 4 and torch.equal(grad_call, grad)
    with torch.no_grad():
        assert sim.make_step_fn()(f0).dtype == dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_16_bit_state_runs_the_kernel_path(dtype):
    """The kernel path (its plain version on the CPU) keeps a 16-bit
    state, with its mass to half-precision rounding, as
    tests/test_native.py holds lettuce_tpu's plain bf16 and f16 runs."""
    flow = _tgv(dtype)
    sim = ltt.Simulation(flow, ltt.BGKCollision(
        flow.units.relaxation_parameter_lu), [])
    sim._use_kernel()
    sim(10)
    f = flow.f.float()
    assert flow.f.dtype == dtype and bool(torch.isfinite(f).all())
    np.testing.assert_allclose(float(f.sum()), 16 * 16, rtol=2e-2)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_half_storage_on_the_cpu_warns(capsys):
    with pytest.warns(UserWarning, match="running at full precision"):
        assert cli.main(["--device", "cpu", "-p", "single", "benchmark",
                         "-r", "16", "-s", "2", "--half-storage"]) == 0
    assert "(torch x1 path), half storage off" in capsys.readouterr().out


def test_cli_half_precision_runs(capsys):
    assert cli.main(["--device", "cpu", "-p", "half", "benchmark",
                     "-r", "16", "-s", "2"]) == 0
    out = capsys.readouterr().out
    assert "bfloat16 on cpu (torch x1 path)" in out and "MLUPS" in out
