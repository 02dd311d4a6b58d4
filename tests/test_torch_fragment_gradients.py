"""Rollout gradients of every collision fragment through lettuce_tpu_torch's
kernel path on the CPU, against ``jax.grad`` through lettuce_tpu's jnp
step: full mode (TRT, the folded MRT, the regularized collision,
Smagorinsky, KBC, the identity) and split mode (a closed-form MRT basis,
Guo-forced BGK), periodic and masked, and a bounded flow with an outlet
through the window replay; ``gradcheck`` of the Function for every spec;
then the simulation's routing: every kernel-path collision's
differentiable step is the fused Function.

A CPU simulation takes the kernel path with ``sim._use_kernel()``: the
same Function and wrappers as on the card, with the plain versions
inside. The cases mirror tests/test_adjoint.py:154-296. Inputs are seeded
numpy states handed to both packages; gradients of sum(u^2) after 3 steps
agree to 1e-12 of the largest magnitude in float64 (1e-11 where
tests/test_adjoint.py allows it), 1e-5 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from lettuce_tpu.ops.pallas.adjoint import \
    adjoint_collision_spec as jax_adjoint_collision_spec
from lettuce_tpu_torch.ops.cuda.fused_step import fused_step
from tests.conftest import TestFlow
from tests.test_torch_bounded_kernel import bounded_case, torch_masks
from tests.test_torch_fragment_adjoint import forward_spec
from tests.test_torch_hybrid import OUTLETS, obstacle
from tests.torch_helpers import (DTYPES, TorchTestFlow, contexts, hand_state,
                                 to_numpy)


def _tgv(resolution, stencil):
    def make(pkg, ctx):
        return pkg.TaylorGreenVortex(ctx, list(resolution), 100, 0.05,
                                     stencil=getattr(pkg, stencil)(),
                                     initialize_fneq=False)
    return make


def _walled(resolution, stencil):
    """tests/test_adjoint.py's TestFlow with a bounce-back plane y = 0."""
    def make(pkg, ctx):
        mask = np.zeros(resolution, dtype=bool)
        mask[:, 0] = True
        flow_cls = TestFlow if pkg is lt else TorchTestFlow
        return flow_cls(ctx, list(resolution),
                        stencil=getattr(pkg, stencil)(),
                        boundaries=[pkg.BounceBackBoundary(mask)])
    return make


def _mrt(transform, taus):
    def make(pkg, flow):
        return pkg.MRTCollision(getattr(pkg, transform)(flow.stencil,
                                                        flow.context),
                                taus, flow.context)
    return make


def _units_tau(flow):
    return float(flow.units.relaxation_parameter_lu)


D2 = [16, 128]
D3 = [8, 16, 128]
DHUMIERES_TAUS = [1.0, 1.2, 1.1, 1.0, 1.3, 1.0, 1.3, 1.0, 1.3,
                  0.9, 1.1, 0.9, 1.1, 0.9, 0.9, 0.9, 1.2, 1.2, 1.2]
# name -> (flow, collision, mode, dtype, rtol): the KBC states carry 1 %
# noise (at equilibrium its guard makes the Jacobian a subgradient choice,
# tests/test_adjoint.py:250-264), the others 1e-4
CASES = {
    "trt-2d": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.TRTCollision(
        _units_tau(flow), 1.3 * _units_tau(flow)), "full", "float64", 1e-12),
    "trt-2d-float32": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.TRTCollision(
        _units_tau(flow), 1.3 * _units_tau(flow)), "full", "float32", 1e-5),
    "trt-3d-masked": (_walled(D3, "D3Q19"), lambda pkg, flow:
                      pkg.TRTCollision(0.8, 0.95), "full", "float64", 1e-12),
    "mrt-dhumieres": (_tgv(D3, "D3Q19"), _mrt("D3Q19DHumieres",
                                              DHUMIERES_TAUS),
                      "full", "float64", 1e-11),
    "mrt-lallemand": (_tgv(D2, "D2Q9"), _mrt("D2Q9Lallemand", [1.1] * 9),
                      "split", "float64", 1e-12),
    "reg-2d": (_tgv(D2, "D2Q9"), lambda pkg, flow:
               pkg.RegularizedCollision(0.8), "full", "float64", 1e-12),
    "reg-3d-masked": (_walled(D3, "D3Q19"), lambda pkg, flow:
                      pkg.RegularizedCollision(0.8), "full", "float64",
                      1e-11),
    "smag-2d": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.SmagorinskyCollision(
        _units_tau(flow)), "full", "float64", 1e-11),
    "smag-3d-masked": (_walled(D3, "D3Q19"), lambda pkg, flow:
                       pkg.SmagorinskyCollision(0.8), "full", "float64",
                       1e-11),
    "kbc-2d": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.KBCCollision(
        _units_tau(flow)), "full", "float64", 1e-12),
    "kbc-3d": (_tgv([8, 8, 128], "D3Q27"), lambda pkg, flow:
               pkg.KBCCollision(_units_tau(flow)), "full", "float64",
               1e-11),
    "kbc-masked": (_walled(D2, "D2Q9"), lambda pkg, flow:
                   pkg.KBCCollision(0.8), "full", "float64", 1e-11),
    "guo": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.Guo(flow, 0.8, [1e-4, 0.0])), "split", "float64",
        1e-12),
    "none": (_tgv(D2, "D2Q9"), lambda pkg, flow: pkg.NoCollision(), "full",
             "float64", 1e-12),
}


def grad_pair(make_flow, make_collision, dtype_name, steps=3, noise=1e-4,
              seed=71):
    """(the port's gradient through the kernel path, jax.grad through
    lettuce_tpu's jnp step, the port's simulation) of sum(u^2) after
    ``steps`` steps, from one seeded state."""
    jctx, tctx = contexts(dtype_name)
    jflow, tflow = make_flow(lt, jctx), make_flow(ltt, tctx)
    f = np.asarray(jflow.f, dtype=np.float64)
    hand_state(jflow, tflow, f * (1 + noise * np.random.default_rng(
        seed).uniform(-1, 1, f.shape)))
    jsim = lt.Simulation(jflow, make_collision(lt, jflow), [])
    tsim = ltt.Simulation(tflow, make_collision(ltt, tflow), [])
    tsim._use_kernel()
    assert jsim._step_kind == "jnp" and tsim._step_kind == "cuda"
    step = jsim._build_jnp_step()

    def jloss(x):
        for _ in range(steps):
            x = step(x)
        return jnp.sum(jflow.view(x).u() ** 2)

    want = jax.jit(jax.grad(jloss))(jflow.f)
    f0 = tflow.f.clone().requires_grad_(True)
    (tflow.view(tsim.make_segment_fn(steps)(f0)).u() ** 2).sum().backward()
    return f0.grad, want, tsim


def assert_scaled_close(got, want, rtol):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_gradient_matches_jax_grad(case):
    make_flow, make_collision, mode, dtype_name, rtol = CASES[case]
    kbc = case.startswith("kbc")
    got, want, tsim = grad_pair(make_flow, make_collision, dtype_name,
                                steps=2 if case == "kbc-3d" else 3,
                                noise=1e-2 if kbc else 1e-4)
    assert tsim.adjoint_mode == mode
    assert got.dtype == DTYPES[dtype_name][1]
    assert_scaled_close(got, want, rtol)


# ----------------------------------------------------------------------
# a bounded flow with an outlet: kernel + window replay
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,reference_mode", [("trt", "full"),
                                                 ("kbc", "split")])
def test_hybrid_gradient_matches_jax_grad(name, reference_mode):
    """tests/test_torch_hybrid.py's obstacle (equilibrium inlet,
    anti-bounce-back outlet through the replay, cylinder) with TRT and
    KBC, 3 steps. lettuce_tpu differentiates TRT in full mode and KBC in
    split mode (``reference_mode``: its adjoint spec raises for KBC); the
    port runs both in full mode, KBC through its own adjoint."""
    def make_collision(pkg, flow):
        tau = _units_tau(flow)
        if name == "trt":
            return pkg.TRTCollision(tau, 1.2 * tau)
        return pkg.KBCCollision(tau)

    got, want, tsim = grad_pair(
        lambda pkg, ctx: obstacle(pkg, ctx, OUTLETS["anti_bounce_back"]),
        make_collision, "float64", noise=1e-2 if name == "kbc" else 1e-4)
    assert tsim.step_path == "cuda+hybrid x1"
    assert tsim.adjoint_mode == "full"
    params = dict(tsim._kernel_params,
                  collision_spec=tuple(tsim._kernel_params["collision_spec"]))
    try:
        jax_adjoint_collision_spec(params)
        mode = "full"
    except NotImplementedError:
        mode = "split"
    assert mode == reference_mode
    assert_scaled_close(got, want, 1e-12 if name == "trt" else 1e-11)


# ----------------------------------------------------------------------
# gradcheck of the Function, full and split mode
# ----------------------------------------------------------------------
GRADCHECK = {"trt": ("D2Q9", "full"), "reg": ("D3Q27", "full"),
             "mrt": ("D3Q19", "full"), "smag": ("D2Q9", "full"),
             "none": ("D2Q9", "full"), "kbc": ("D2Q9", "full"),
             "guo": ("D2Q9", "split")}


@pytest.mark.parametrize("masked", [False, True], ids=["periodic", "masked"])
@pytest.mark.parametrize("name", sorted(GRADCHECK))
def test_fused_step_gradcheck(name, masked):
    stencil_name, mode = GRADCHECK[name]
    stencil = getattr(ltt, stencil_name)()
    shape = (5, 7) if stencil.d == 2 else (3, 3, 4)
    spec = forward_spec(name, stencil)
    assert spec.mode == mode
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 54, True)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64) if masked \
        else {}
    x = torch.as_tensor(f).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda y: fused_step(y, e=stencil.e, w=stencil.w,
                             opposite=stencil.opposite, cs=stencil.cs,
                             collision_spec=spec, **masks), (x,))


# ----------------------------------------------------------------------
# routing: the Function for every fragment, and no message
# ----------------------------------------------------------------------
FRAGMENT_COLLISIONS = {
    "trt": lambda flow: ltt.TRTCollision(0.8, 1.1),
    "reg": lambda flow: ltt.RegularizedCollision(0.8),
    "smag": lambda flow: ltt.SmagorinskyCollision(0.8),
    "none": lambda flow: ltt.NoCollision(),
    "kbc": lambda flow: ltt.KBCCollision(0.8),
    "mrt_lallemand": lambda flow: ltt.MRTCollision(
        ltt.D2Q9Lallemand(flow.stencil, flow.context), [1.1] * 9,
        flow.context),
    "bgk_force": lambda flow: ltt.BGKCollision(0.8, force=ltt.Guo(
        flow, 0.8, [1e-4, 0.0])),
}


@pytest.mark.parametrize("name", sorted(FRAGMENT_COLLISIONS))
def test_make_step_fn_is_the_fused_function(name, capsys):
    ctx = ltt.Context(device="cpu", dtype=torch.float64)
    flow = ltt.TaylorGreenVortex(ctx, [6, 8], 100, 0.05, stencil=ltt.D2Q9(),
                                 initialize_fneq=False)
    sim = ltt.Simulation(flow, FRAGMENT_COLLISIONS[name](flow), [])
    assert sim.adjoint_mode is None  # the torch step: autograd's gradient
    sim._use_kernel()
    step = sim.make_step_fn()
    assert step.func is fused_step and step.keywords == sim._kernel_params
    assert sim.make_segment_fn(2) is not None
    spec = sim._kernel_params["collision_spec"]
    assert sim.adjoint_mode == spec.mode
    assert spec.fragment == name
    assert capsys.readouterr().out == ""
