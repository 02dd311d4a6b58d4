"""The blocked adjoint (K4) of lettuce_tpu_torch on the CPU: its plain
version (``stream_collide_adjoint_multi_plain``) against lettuce_tpu's
``fused_adjoint_multi`` in interpret mode per adjoint spec (bgk, trt,
matvec for the regularized and the MRT from_feq collisions, none); the
blocked gradient segments of ``make_segment_fn`` with ``LETTUCE_NSUB=2``
against ``jax.grad`` through lettuce_tpu's blocked segments; ``gradcheck``
of the blocked ``torch.autograd.Function`` per spec; and the collisions
and flows that keep the single-step adjoint.

Inputs are seeded numpy arrays (or the TGV state plus seeded noise)
handed to both packages. Tolerances are scaled by the reference's largest
magnitude: the VJP 1e-12 in float64 (1e-5 in float32 for MRT, whose
Pallas fragment is not float64-exact); the segment gradients 1e-11
(tests/test_adjoint.py:480-547's bound for lettuce_tpu's blocked adjoint).
The CUDA kernel runs only on a card; ``chip_smoke.py`` (phase 28) holds
it against this plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.simulation as simulation_module
from lettuce_tpu.ops.pallas.adjoint import fused_adjoint_multi
from lettuce_tpu_torch.ops.cuda.fused_step import fused_multi_step
from tests.test_torch_adjoint import assert_scaled_close, random_state
from tests.test_torch_half_storage import kernel_args, tgv_case
from tests.test_torch_multi_step import port_kernel
from tests.torch_helpers import hand_state, noisy_state, to_numpy

TAU = 0.8
D3 = ("D3Q19", [16, 16, 128], 2)
D2 = ("D2Q9", [32, 256], 4)
DHUMIERES = lambda flow: ltt.MRTCollision(  # noqa: E731
    ltt.D3Q19DHumieres(flow.stencil, flow.context),
    [1.0] * 3 + [1.1, 1.2] * 8, flow.context)
# adjoint spec case -> (stencil, grid, n_sub, collision factory)
CASES = {
    "bgk_d3q19": (*D3, lambda flow: ltt.BGKCollision(TAU)),
    "bgk_d2q9": (*D2, lambda flow: ltt.BGKCollision(TAU)),
    "trt": (*D3, lambda flow: ltt.TRTCollision(TAU, 1.1)),
    "matvec_reg": (*D2, lambda flow: ltt.RegularizedCollision(TAU)),
    "matvec_mrt": (*D3, DHUMIERES),
    "none": (*D2, lambda flow: ltt.NoCollision()),
}
# lettuce_tpu's MRT fragment is not float64-exact (test_torch_multi_step's
# F32_ONLY), and its blocked adjoint replays that forward: the MRT case
# compares in float32, to 1e-5 of the largest magnitude
# (tests/test_adjoint.py's float32 bound)
F32_ONLY = ("matvec_mrt",)


# ----------------------------------------------------------------------
# (a) the plain blocked adjoint against the Pallas kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_blocked_adjoint_matches_pallas(name):
    stencil_name, grid, n_sub, make = CASES[name]
    st, spec, f = tgv_case(stencil_name, grid, make, seed=51)
    dtype = np.float32 if name in F32_ONLY else np.float64
    f = f.astype(dtype)
    g = np.random.default_rng(52).standard_normal(f.shape).astype(dtype)
    want = fused_adjoint_multi(
        jnp.asarray(f), jnp.asarray(g), np.asarray(st.e), np.asarray(st.w),
        np.asarray(st.opposite), float(st.cs), tuple(spec), spec.adjoint,
        n_sub, block_target=(16, 16), interpret=True)
    got = ad.stream_collide_adjoint_multi_plain(
        torch.as_tensor(f), torch.as_tensor(g), n_sub,
        *kernel_args(st, spec), collision_spec=spec)
    assert got.dtype == torch.as_tensor(f).dtype
    assert_scaled_close(got, want, 1e-5 if name in F32_ONLY else 1e-12)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(ad.stream_collide_adjoint_multi(
        torch.as_tensor(f), torch.as_tensor(g), n_sub,
        *kernel_args(st, spec), collision_spec=spec), got)


# ----------------------------------------------------------------------
# (b) blocked gradient segments against jax.grad through lettuce_tpu's
# ----------------------------------------------------------------------
def counted_multi(monkeypatch):
    calls = []
    real = simulation_module.fused_multi_step

    def counted(f, **kwargs):
        calls.append(kwargs["n_sub"])
        return real(f, **kwargs)

    monkeypatch.setattr(simulation_module, "fused_multi_step", counted)
    return calls


@pytest.mark.parametrize("steps,every", [(5, None), (8, 4)],
                         ids=["5-steps", "8-steps-checkpointed"])
def test_blocked_segment_gradient_matches_jax_grad(steps, every,
                                                   monkeypatch):
    """make_segment_fn at span 2 (the bulk through the blocked Function,
    the remainder single-step) against jax.grad through lettuce_tpu's
    blocked segment, D3Q19 16x16x128 float64."""
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    grid = [16, 16, 128]
    jflow = lt.TaylorGreenVortex(
        lt.Context(dtype=jnp.float64, use_native=True), grid, 1600, 0.05,
        stencil=lt.D3Q19(), initialize_fneq=False)
    tflow = ltt.TaylorGreenVortex(
        ltt.Context(device="cpu", dtype=torch.float64), grid, 1600, 0.05,
        stencil=ltt.D3Q19(), initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=53, scale=1e-4))
    tau = jflow.units.relaxation_parameter_lu
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), [])
    assert jsim._step_multi is not None
    assert jsim._step_multi[0].adjoint_kernel
    jseg = jsim.make_segment_fn(steps, checkpoint_every=every)
    want = jax.grad(lambda f: jnp.sum(jseg(f) ** 2))(jflow.f)

    tsim = port_kernel(tflow, ltt.BGKCollision(tau))
    assert tsim.step_path == "cuda x2" and tsim._step_multi[0].adjoint_kernel
    calls = counted_multi(monkeypatch)
    f0 = tflow.f.clone().requires_grad_(True)
    segment = tsim.make_segment_fn(steps, checkpoint_every=every)
    (tsim_grad,) = torch.autograd.grad((segment(f0) ** 2).sum(), f0)
    # the forward's launches, and under checkpointing their recompute
    assert calls == [2] * ((steps // 2) * (1 if every is None else 2))
    assert_scaled_close(tsim_grad, want, 1e-11)


def test_checkpointed_blocked_gradient_is_bitwise_equal(monkeypatch):
    monkeypatch.setenv("LETTUCE_NSUB", "4")
    flow = ltt.TaylorGreenVortex(ltt.Context(device="cpu"), [6, 8, 10], 1600,
                                 0.05, stencil=ltt.D3Q19(),
                                 initialize_fneq=False)
    sim = port_kernel(flow, ltt.BGKCollision(0.52))
    assert sim.step_path == "cuda x4"
    f0 = flow.f.clone().requires_grad_(True)
    grads = []
    for every in (None, 4):
        calls = counted_multi(monkeypatch)
        segment = sim.make_segment_fn(9, checkpoint_every=every)
        grads.append(torch.autograd.grad((segment(f0) ** 2).sum(), f0)[0])
        # the segments run at span 2 whatever the throughput span
        assert set(calls) == {2}
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])


def test_grad_state_through_a_call_takes_the_blocked_route(monkeypatch):
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    flow = ltt.TaylorGreenVortex(
        ltt.Context(device="cpu", dtype=torch.float64), [8, 6], 100, 0.05,
        stencil=ltt.D2Q9(), initialize_fneq=False)
    sim = port_kernel(flow, ltt.BGKCollision(0.7))
    f0 = flow.f.clone().requires_grad_(True)
    want = torch.autograd.grad((sim.make_segment_fn(5)(f0) ** 2).sum(), f0)[0]
    calls = counted_multi(monkeypatch)
    flow.f = f0
    sim(5)
    assert calls == [2, 2]
    (got,) = torch.autograd.grad((flow.f ** 2).sum(), f0)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# (c) gradcheck of the blocked Function per spec
# ----------------------------------------------------------------------
GRADCHECK = {
    "bgk": ("D2Q9", (5, 6), lambda flow: ltt.BGKCollision(TAU)),
    "trt": ("D2Q9", (5, 6), lambda flow: ltt.TRTCollision(TAU, 1.1)),
    "matvec_reg": ("D2Q9", (5, 6), lambda flow: ltt.RegularizedCollision(
        TAU)),
    "matvec_mrt": ("D3Q19", (3, 4, 5), DHUMIERES),
    "none": ("D2Q9", (5, 6), lambda flow: ltt.NoCollision()),
}


@pytest.mark.parametrize("name", sorted(GRADCHECK))
def test_fused_multi_step_gradcheck(name):
    stencil_name, shape, make = GRADCHECK[name]
    st, spec, _ = tgv_case(stencil_name, list(shape), make, seed=54)
    f = torch.as_tensor(random_state(st, shape, seed=55)).requires_grad_(True)
    e, w, opposite, cs, tau_inv = kernel_args(st, spec)
    params = dict(e=e, w=w, opposite=opposite, cs=cs, tau_inv=tau_inv,
                  collision_spec=spec)
    assert torch.autograd.gradcheck(
        lambda x: fused_multi_step(x, n_sub=2, **params), (f,))
    out = fused_multi_step(f, n_sub=2, **params)
    assert out.data_ptr() != f.data_ptr() and out.requires_grad


# ----------------------------------------------------------------------
# (d) what keeps the single-step adjoint
# ----------------------------------------------------------------------
@pytest.mark.parametrize("collision,stencil", [
    (lambda: ltt.SmagorinskyCollision(TAU), "D2Q9"),
    (lambda: ltt.KBCCollision(TAU), "D2Q9")], ids=["smag", "kbc"])
def test_smag_and_kbc_keep_the_single_step_adjoint(collision, stencil,
                                                   monkeypatch, capsys):
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    flow = ltt.TaylorGreenVortex(
        ltt.Context(device="cpu", dtype=torch.float64), [8, 6], 100, 0.05,
        stencil=getattr(ltt, stencil)(), initialize_fneq=False)
    sim = port_kernel(flow, collision())
    assert sim.step_path == "cuda x2"  # the forward blocks
    assert not sim._step_multi[0].adjoint_kernel
    printed = capsys.readouterr().out
    assert "has no blocked adjoint" in printed
    assert "gradients run the single-step adjoint" in printed
    f0 = flow.f.clone().requires_grad_(True)
    calls = counted_multi(monkeypatch)
    grad = torch.autograd.grad((sim.make_segment_fn(4)(f0) ** 2).sum(),
                               f0)[0]
    assert calls == []
    monkeypatch.delenv("LETTUCE_NSUB")
    single = port_kernel(flow, collision())
    assert torch.equal(grad, torch.autograd.grad(
        (single.make_segment_fn(4)(f0) ** 2).sum(), f0)[0])
    spec = sim._kernel_params["collision_spec"]
    with pytest.raises(NotImplementedError, match="no blocked adjoint"):
        fused_multi_step(f0, n_sub=2, **sim._kernel_params)
    with pytest.raises(NotImplementedError, match="no blocked adjoint"):
        ad.stream_collide_adjoint_multi(flow.f, flow.f, 2,
                                        *kernel_args(flow.stencil, spec),
                                        collision_spec=spec)


def test_masked_flow_and_half_storage_keep_the_single_step_adjoint(
        monkeypatch):
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    flow = ltt.CouetteFlow2D(ltt.Context(device="cpu", dtype=torch.float64),
                             [16, 32], reynolds_number=10, mach_number=0.05)
    sim = port_kernel(flow, ltt.BGKCollision(
        flow.units.relaxation_parameter_lu))
    calls = counted_multi(monkeypatch)
    f0 = flow.f.clone().requires_grad_(True)
    grad = torch.autograd.grad((sim.make_segment_fn(4)(f0) ** 2).sum(),
                               f0)[0]
    assert calls == [] and bool(torch.isfinite(grad).all())
    # the deviation step has no gradient; the full-precision one does
    tgv = ltt.TaylorGreenVortex(ltt.Context(device="cpu"), [8, 8, 8], 100,
                                0.05, stencil=ltt.D3Q19(),
                                initialize_fneq=False)
    half = port_kernel(tgv, ltt.BGKCollision(0.7), half_storage=True)
    assert not half._half_multi[0].adjoint_kernel
    assert half._step_multi[0].adjoint_kernel
    with pytest.raises(NotImplementedError, match="throughput mode"):
        half._half_multi[0](tgv.f.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="no masks"):
        ad.stream_collide_adjoint_multi(
            flow.f, flow.f, 2, *kernel_args(flow.stencil, ("bgk", 1.0)),
            ncm=sim.no_collision_mask)


def test_gradient_segment_without_blocking_is_unchanged(monkeypatch):
    """LETTUCE_NSUB unset: the segment is the single-step Function, as
    before temporal blocking was ported."""
    monkeypatch.delenv("LETTUCE_NSUB", raising=False)
    flow = ltt.TaylorGreenVortex(ltt.Context(device="cpu",
                                             dtype=torch.float64),
                                 [8, 6], 100, 0.05, stencil=ltt.D2Q9(),
                                 initialize_fneq=False)
    sim = port_kernel(flow, ltt.BGKCollision(0.7))
    calls = counted_multi(monkeypatch)
    f0 = flow.f.clone().requires_grad_(True)
    grad = torch.autograd.grad((sim.make_segment_fn(5)(f0) ** 2).sum(), f0)
    assert calls == [] and bool(torch.isfinite(grad[0]).all())
    assert to_numpy(grad[0]).shape == tuple(flow.f.shape)
