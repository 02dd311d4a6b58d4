"""The differentiable step of lettuce_tpu_torch on the CPU: the emit-u
forward and the adjoint's plain versions against lettuce_tpu's Pallas
kernels in interpret mode and against ``jax.vjp`` of its jnp step, the
``torch.autograd.Function`` that joins them, and rollout gradients through
``make_segment_fn`` against ``jax.grad`` through lettuce_tpu's.

Inputs are seeded numpy arrays handed to both packages. Tolerances are
scaled by the reference's largest magnitude: 1e-12 in float64, and in
float32 1e-5, the bound tests/test_adjoint.py holds lettuce_tpu's adjoint
kernel to. The CUDA kernels themselves run only on a card;
``chip_smoke.py`` holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.adjoint import fused_adjoint
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda.fused_step import fused_step
from tests.torch_helpers import (hand_state, launch_counts, noisy_state,
                                 tgv_pair, to_numpy)

TAU_INV = 1.0 / 0.52
RTOL = {"float64": 1e-12, "float32": 1e-5}
TORCH = {"float64": torch.float64, "float32": torch.float32}
JAX = {"float64": jnp.float64, "float32": jnp.float32}
KERNEL_GRIDS = [("D3Q19", (8, 8, 128)), ("D2Q9", (16, 128))]


def random_state(stencil, shape, seed):
    """Populations near equilibrium at rest: w_q (1 + 10 % noise)."""
    noise = np.random.default_rng(seed).uniform(-0.1, 0.1,
                                                (stencil.q, *shape))
    return stencil.w.reshape((-1,) + (1,) * len(shape)) * (1 + noise)


def random_cotangent(stencil, shape, seed):
    return np.random.default_rng(seed).standard_normal((stencil.q, *shape))


def kernel_args(stencil):
    return (stencil.e, stencil.w, stencil.opposite, stencil.cs, TAU_INV)


def assert_scaled_close(got, want, rtol):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def kernel_path(simulation):
    """Route a CPU simulation through the kernel path (``fused_step`` and
    ``_cuda_step``), whose wrappers run their plain versions on CPU
    tensors."""
    simulation._use_kernel()
    assert simulation._step_kind == "cuda"
    return simulation


# ----------------------------------------------------------------------
# (a) the emit-u forward against the Pallas kernel in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(RTOL))
@pytest.mark.parametrize("stencil_name,shape", KERNEL_GRIDS,
                         ids=["d3q19", "d2q9"])
def test_emit_u_matches_pallas_kernel(dtype_name, stencil_name, shape):
    stencil = getattr(ltt, stencil_name)()
    f_np = random_state(stencil, shape, seed=11)
    want_f, want_u = fused_stream_collide(
        jnp.asarray(f_np, dtype=JAX[dtype_name]), *kernel_args(stencil),
        emit_u=True, interpret=True)
    got_f, got_u = sc.stream_collide_plain(
        torch.as_tensor(f_np, dtype=TORCH[dtype_name]),
        *kernel_args(stencil), emit_u=True)
    assert got_u.dtype == TORCH[dtype_name]
    assert tuple(got_u.shape) == (stencil.d, *shape)
    assert_scaled_close(got_f, want_f, RTOL[dtype_name])
    assert_scaled_close(got_u, want_u, RTOL[dtype_name])


# ----------------------------------------------------------------------
# (b) the adjoint against the Pallas adjoint kernel in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(RTOL))
@pytest.mark.parametrize("stencil_name,shape", KERNEL_GRIDS,
                         ids=["d3q19", "d2q9"])
def test_adjoint_matches_pallas_kernel(dtype_name, stencil_name, shape):
    stencil = getattr(ltt, stencil_name)()
    f_np = random_state(stencil, shape, seed=12)
    g_np = random_cotangent(stencil, shape, seed=13)
    _, u = sc.stream_collide_plain(torch.as_tensor(f_np),
                                   *kernel_args(stencil), emit_u=True)
    u_np = u.numpy()
    want = fused_adjoint(jnp.asarray(u_np, dtype=JAX[dtype_name]),
                         jnp.asarray(g_np, dtype=JAX[dtype_name]),
                         stencil.e, stencil.w, stencil.opposite, stencil.cs,
                         spec=("bgk", TAU_INV), residual_u=True,
                         interpret=True)
    got = ad.stream_collide_adjoint_plain(
        torch.as_tensor(g_np, dtype=TORCH[dtype_name]),
        torch.as_tensor(u_np, dtype=TORCH[dtype_name]),
        *kernel_args(stencil))
    assert got.dtype == TORCH[dtype_name]
    assert_scaled_close(got, want, RTOL[dtype_name])


# ----------------------------------------------------------------------
# (c) the adjoint against jax.vjp of lettuce_tpu's jnp step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stencil_name", ["D2Q9", "D3Q15", "D3Q19",
                                          "D3Q27"])
def test_adjoint_matches_vjp_of_jnp_step(stencil_name):
    """Every stencil with a compiled kernel instance, on a grid with no
    axis a power of two."""
    stencil = getattr(ltt, stencil_name)()
    shape = (6, 10) if stencil.d == 2 else (5, 6, 7)
    f_np = random_state(stencil, shape, seed=14)
    g_np = random_cotangent(stencil, shape, seed=15)
    jflow = lt.TaylorGreenVortex(
        lt.Context(dtype=jnp.float64, use_native=False), list(shape), 100,
        0.05, stencil=getattr(lt, stencil_name)(), initialize_fneq=False)
    jsim = lt.Simulation(jflow, lt.BGKCollision(1.0 / TAU_INV), [])
    assert jsim._step_kind == "jnp"
    step = jsim._build_jnp_step()
    # jitted: one XLA compile instead of one per eager primitive
    (want,) = jax.jit(lambda f, g: jax.vjp(step, f)[1](g))(
        jnp.asarray(f_np), jnp.asarray(g_np))
    _, u = sc.stream_collide_plain(torch.as_tensor(f_np),
                                   *kernel_args(stencil), emit_u=True)
    got = ad.stream_collide_adjoint_plain(torch.as_tensor(g_np), u,
                                          *kernel_args(stencil))
    assert_scaled_close(got, want, RTOL["float64"])


# ----------------------------------------------------------------------
# (d) gradcheck of the Function
# ----------------------------------------------------------------------
def test_fused_step_gradcheck():
    stencil = ltt.D2Q9()
    f = torch.as_tensor(random_state(stencil, (5, 7), seed=16))
    f.requires_grad_(True)
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=stencil.cs, tau_inv=TAU_INV)
    assert torch.autograd.gradcheck(lambda x: fused_step(x, **params), (f,))


# ----------------------------------------------------------------------
# (e) an 8-step rollout gradient against jax.grad through lettuce_tpu
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stencil_name,resolution",
                         [("D2Q9", [16, 12]), ("D3Q19", [6, 8, 10])],
                         ids=["tgv2d", "tgv3d"])
def test_segment_gradient_matches_jax_grad(stencil_name, resolution):
    jflow, tflow = tgv_pair("float64", resolution, stencil_name,
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=17))
    tau = jflow.units.relaxation_parameter_lu
    jseg = lt.Simulation(jflow, lt.BGKCollision(tau), []).make_segment_fn(8)
    want = jax.grad(lambda f: jnp.sum(jseg(f) ** 2))(jflow.f)

    tsim = kernel_path(ltt.Simulation(tflow, ltt.BGKCollision(tau), []))
    f0 = tflow.f.clone().requires_grad_(True)
    (tsim.make_segment_fn(8)(f0) ** 2).sum().backward()
    assert_scaled_close(f0.grad, want, RTOL["float64"])


# ----------------------------------------------------------------------
# (f) checkpointed and plain segments give equal gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("path", ["kernel", "torch"])
def test_checkpointed_segment_gradient_is_bitwise_equal(path):
    ctx = ltt.Context(device="cpu", dtype=torch.float32)
    flow = ltt.TaylorGreenVortex(ctx, [6, 8, 10], 1600, 0.05,
                                 stencil=ltt.D3Q19(), initialize_fneq=False)
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.52), [])
    if path == "kernel":
        kernel_path(sim)
    f0 = flow.f.clone().requires_grad_(True)
    grads = []
    for every in (None, 3):
        segment = sim.make_segment_fn(8, checkpoint_every=every)
        (grad,) = torch.autograd.grad((segment(f0) ** 2).sum(), f0)
        grads.append(grad)
    assert bool(torch.isfinite(grads[0]).all())
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])


# ----------------------------------------------------------------------
# (g) the Function never aliases or writes its input
# ----------------------------------------------------------------------
@pytest.mark.parametrize("requires_grad", [True, False],
                         ids=["grad", "no-grad"])
def test_fused_step_returns_fresh_tensors(requires_grad):
    stencil = ltt.D3Q19()
    f = torch.as_tensor(random_state(stencil, (4, 5, 6), seed=18))
    f.requires_grad_(requires_grad)
    kept = f.detach().clone()
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=stencil.cs, tau_inv=TAU_INV)
    first = fused_step(f, **params)
    second = fused_step(first, **params)
    pointers = {f.data_ptr(), first.data_ptr(), second.data_ptr()}
    assert len(pointers) == 3
    assert torch.equal(f.detach(), kept)
    assert first.requires_grad is requires_grad
    want = sc.stream_collide_plain(kept, *kernel_args(stencil))
    assert torch.equal(first.detach(), want)


# ----------------------------------------------------------------------
# the wrappers on the CPU
# ----------------------------------------------------------------------
def test_wrappers_run_plain_on_cpu_tensors():
    stencil = ltt.D2Q9()
    args = kernel_args(stencil)
    f = torch.as_tensor(random_state(stencil, (6, 9), seed=19))
    g = torch.as_tensor(random_cotangent(stencil, (6, 9), seed=20))
    counts = launch_counts("K1", "K3")
    want_f, want_u = sc.stream_collide_plain(f, *args, emit_u=True)
    out, u = torch.empty_like(f), torch.empty((2, 6, 9), dtype=f.dtype)
    got_out, got_u = sc.stream_collide(f, *args, out=out, u_out=u)
    assert got_out is out and got_u is u
    assert torch.equal(out, want_f) and torch.equal(u, want_u)
    want = ad.stream_collide_adjoint_plain(g, u, *args)
    assert torch.equal(ad.stream_collide_adjoint(g, u, *args), want)
    ct = torch.empty_like(g)
    assert ad.stream_collide_adjoint(g, u, *args, out=ct) is ct
    assert torch.equal(ct, want)
    # no kernel launched
    assert launch_counts("K1", "K3") == counts


def test_adjoint_wrapper_refuses_other_devices():
    stencil = ltt.D2Q9()
    g = torch.empty((9, 4, 4), device="meta")
    u = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ad.stream_collide_adjoint(g, u, *kernel_args(stencil))


def test_make_step_fn_selects_the_path():
    ctx = ltt.Context(device="cpu", dtype=torch.float64)
    flow = ltt.TaylorGreenVortex(ctx, [6, 8], 1600, 0.05,
                                 stencil=ltt.D2Q9(), initialize_fneq=False)
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.52), [])
    assert sim.make_step_fn() == sim._torch_step
    want = sim.make_step_fn()(flow.f)
    kernel_path(sim)
    step = sim.make_step_fn()
    assert step.func is fused_step and step.keywords == sim._kernel_params
    np.testing.assert_allclose(step(flow.f).numpy(), want.numpy(), rtol=0,
                               atol=1e-15)
