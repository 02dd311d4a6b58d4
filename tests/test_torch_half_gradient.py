"""The gradient of a 16-bit state in lettuce_tpu_torch on the CPU: the
16-bit emit-u forward (K1d at 16 bits), the adjoints at 16-bit storage
(K3 at 16 bits, every spec and mask form) and the blocked adjoint at 16
bits (K4, ROADMAP F11) in their plain versions, split mode at 16 bits, and
whole gradient segments, against lettuce_tpu's Pallas kernels in
interpret mode.

Inputs are seeded numpy arrays (or a TGV state) handed to both packages in
the 16-bit dtype. lettuce_tpu stores 16 bits and computes in float32
(stream_collide.py:1492-1495, adjoint.py:167-174), as the port does, so:

* the emit-u state is within one storage ulp entrywise and u (float32 in
  both) within 5e-6 of its largest magnitude;
* an adjoint is within one storage ulp at the largest magnitude:
  lettuce_tpu rounds a collide cell's cotangent twice (h - t, then the
  equilibrium term, adjoint.py:236-240, :536-541) and the port once, and
  quantization dominates (the reference's 16-bit result is 3.6e-3 (bf16)
  of its largest magnitude from its float32 one);
* the blocked adjoint is within one storage ulp plus n_sub float32 floors
  of lettuce_tpu's float32 kernel on the upcast inputs, rounded (the port
  keeps a float32 tile, F11), and within :data:`F11_ULPS` storage ulps of
  lettuce_tpu's 16-bit kernel, which computes every operation of its
  replay and backward sweep in the storage type;
* split mode is within one storage ulp of lettuce_tpu's split VJP on the
  upcast inputs, rounded;
* a 4-step gradient segment is within 4 storage ulps per step of
  lettuce_tpu's at the largest magnitude, and both within 2 % of the
  float32 gradient (the bar half storage's u is held to).

The CUDA kernels run only on a card; ``chip_smoke.py`` (phases 32-34)
holds them against these plain versions there."""

import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.adjoint import fused_adjoint, fused_adjoint_multi
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda.fused_step import (fused_multi_step,
                                                   fused_step)
from tests.test_torch_bounded_kernel import (JAX_KINDS, bounded_case,
                                             torch_masks)
from tests.test_torch_fragment_adjoint import args_of, forward_spec
from tests.test_torch_half_storage import (MANTISSA_BITS,
                                           assert_within_storage_ulp)
from tests.test_torch_hybrid import _inlet_outlet_bb

STATES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
D2 = ("D2Q9", (16, 128))
D3 = ("D3Q19", (8, 16, 128))  # a raw 3D Pallas call in 16 bits: y % 16
# lettuce_tpu's 16-bit blocked adjoint computes in the storage type: over
# the six D2Q9 and D3Q19 cases at n_sub 2 it sits 3.1-4.8 storage ulps (at
# the largest magnitude) from the port's float32-tile result
F11_ULPS = 8
SEGMENT_STEPS = 4


def ulp_at_max(want, dtype: torch.dtype) -> float:
    """One ``dtype`` ulp at the largest magnitude of ``want``."""
    m = float(np.abs(np.asarray(want, dtype=np.float64)).max())
    assert m > 0
    return 2.0 ** (np.floor(np.log2(m)) - MANTISSA_BITS[dtype])


def numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_ulps_at_max(got, want, dtype, ulps=1.0, floor=0.0):
    """|got - want| within ``ulps`` storage ulps at want's largest
    magnitude, plus ``floor`` times that magnitude; returns the ulps."""
    a, b = numpy64(got), numpy64(want)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    ulp = ulp_at_max(b, dtype)
    assert err <= ulps * ulp + floor * scale, (
        f"{err:.3e} = {err / ulp:.2f} ulps at {scale:.3e} (bar {ulps} "
        f"+ {floor:.1e} relative)")
    return err / ulp


def sixteen(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float64 array rounded to the 16-bit ``dtype`` through float32,
    as both packages take it here."""
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dtype)


def jax_array(x: torch.Tensor, jax_dtype):
    """The 16-bit (or float32) tensor ``x`` as a jax array, exactly."""
    return jnp.asarray(x.float().numpy()).astype(jax_dtype)


# ----------------------------------------------------------------------
# (a) K1d at 16 bits: the plain emit-u step against the Pallas kernel
# ----------------------------------------------------------------------
EMIT_U = {"bgk": D2, "trt": D2, "reg": D2, "mrt": D3}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("masked", [False, True], ids=["periodic", "masked"])
@pytest.mark.parametrize("name", sorted(EMIT_U))
def test_plain_16_bit_emit_u_matches_pallas(name, masked, state):
    torch_dtype, jax_dtype = STATES[state]
    stencil_name, shape = EMIT_U[name]
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name, stencil)
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 81, True)
    x = sixteen(f, torch_dtype)
    jmasks, tmasks = {}, {}
    if masked:
        tmasks = torch_masks(ncm, nsm, feq, table, torch.float32)
        tmasks["feq_field"] = tmasks["feq_field"].to(torch_dtype)
        jmasks = dict(no_collision_mask=jnp.asarray(ncm),
                      no_streaming_mask=jnp.asarray(nsm),
                      boundary_kinds=JAX_KINDS,
                      feq_boundary=(None, table[2][1], None, None),
                      feq_field=jax_array(tmasks["feq_field"], jax_dtype))
    tau_inv = spec[1] if name == "bgk" else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_f, want_u = fused_stream_collide(
            jax_array(x, jax_dtype), *args_of(stencil), tau_inv,
            collision_spec=tuple(spec), emit_u=True, interpret=True,
            **jmasks)
    got_f, got_u = sc.stream_collide_plain(
        x, *args_of(stencil), tau_inv, collision_spec=spec, emit_u=True,
        **tmasks)
    assert got_f.dtype == torch_dtype and want_f.dtype == jax_dtype
    assert got_u.dtype == torch.float32 and want_u.dtype == jnp.float32
    assert_within_storage_ulp(got_f, want_f, torch_dtype)
    want_u = numpy64(want_u)
    np.testing.assert_allclose(numpy64(got_u), want_u, rtol=0,
                               atol=5e-6 * np.abs(want_u).max())
    # the wrapper on CPU tensors is the plain version, u in float32
    u_out = torch.empty(tuple(got_u.shape), dtype=torch.float32)
    out, _ = sc.stream_collide(x, *args_of(stencil), tau_inv, u_out=u_out,
                               collision_spec=spec, **tmasks)
    assert torch.equal(out, got_f) and torch.equal(u_out, got_u)


def test_emit_u_refuses_deviations():
    stencil = ltt.D2Q9()
    g = torch.zeros((9, 4, 6), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="deviation"):
        sc.stream_collide_plain(g, *args_of(stencil), 1.2, emit_u=True,
                                dev_storage=True)


# ----------------------------------------------------------------------
# (b) K3 at 16 bits: the plain adjoint of every spec against the kernel
# ----------------------------------------------------------------------
ADJOINT = {"bgk": D2, "trt": D2, "matvec-reg": D2, "matvec-mrt": D3,
           "smag": D2, "none": D2}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("masks", ["periodic", "codes+frozen", "frozen"])
@pytest.mark.parametrize("name", sorted(ADJOINT))
def test_plain_16_bit_adjoint_matches_pallas(name, masks, state):
    torch_dtype, jax_dtype = STATES[state]
    stencil_name, shape = ADJOINT[name]
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name.removeprefix("matvec-"), stencil)
    frozen = "frozen" in masks
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 82, frozen)
    x = sixteen(f, torch_dtype)
    g = sixteen(np.random.default_rng(83).standard_normal(f.shape),
                torch_dtype)
    codes = "codes" in masks
    tmasks = torch_masks(ncm, nsm, feq, table, torch.float32)
    tmasks = (dict(tmasks, feq_field=tmasks["feq_field"].to(torch_dtype))
              if codes else dict(nsm=tmasks["nsm"]))
    residual_u = spec.residual == "u"
    if residual_u:
        _, res = sc.stream_collide_plain(x, *args_of(stencil), None,
                                         collision_spec=spec, emit_u=True)
        assert res.dtype == torch.float32
    else:
        res = x if spec.residual == "f" else None
    want = fused_adjoint(
        None if res is None else jax_array(
            res, jnp.float32 if residual_u else jax_dtype),
        jax_array(g, jax_dtype), *args_of(stencil), spec=spec.adjoint,
        no_collision_mask=jnp.asarray(ncm) if codes else None,
        no_streaming_mask=nsm, boundary_kinds=JAX_KINDS if codes else (),
        residual_u=residual_u, interpret=True)
    got = ad.stream_collide_adjoint_plain(g, res, *args_of(stencil), None,
                                          collision_spec=spec, **tmasks)
    assert got.dtype == torch_dtype and want.dtype == jax_dtype
    assert_ulps_at_max(got, want, torch_dtype)
    assert torch.equal(ad.stream_collide_adjoint(
        g, res, *args_of(stencil), None, collision_spec=spec, **tmasks), got)


# ----------------------------------------------------------------------
# (c) K4 at 16 bits: the plain blocked adjoint (F11)
# ----------------------------------------------------------------------
MULTI = {"bgk": D2, "trt": D2, "reg": D2, "none": D2, "mrt": D3}


@pytest.mark.parametrize("name,state", [
    (name, state) for name in sorted(MULTI) for state in sorted(STATES)
    if not (name == "mrt" and state == "float16")])  # the D3Q19 case once
def test_plain_16_bit_blocked_adjoint(name, state):
    """F11: the port's K4 at 16 bits keeps a float32 tile and rounds once,
    so it is lettuce_tpu's float32 blocked adjoint on the upcast inputs,
    rounded (within one storage ulp plus n_sub float32 floors); against
    lettuce_tpu's 16-bit kernel, which computes in the storage type, it
    sits within F11_ULPS storage ulps."""
    torch_dtype, jax_dtype = STATES[state]
    stencil_name, shape = MULTI[name]
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name, stencil)
    n_sub = 2
    f = bounded_case(stencil, shape, 84, False)[0]
    x = sixteen(f, torch_dtype)
    g = sixteen(np.random.default_rng(85).standard_normal(f.shape),
                torch_dtype)
    tau_inv = spec[1] if name == "bgk" else None
    got = ad.stream_collide_adjoint_multi_plain(
        x, g, n_sub, *args_of(stencil), tau_inv, collision_spec=spec)
    assert got.dtype == torch_dtype
    reference = (np.asarray(stencil.e), np.asarray(stencil.w),
                 np.asarray(stencil.opposite), float(stencil.cs),
                 tuple(spec), spec.adjoint, n_sub)
    wide = fused_adjoint_multi(jax_array(x, jnp.float32),
                               jax_array(g, jnp.float32), *reference,
                               block_target=(16, 16), interpret=True)
    rounded = jnp.asarray(wide).astype(jax_dtype)
    assert_ulps_at_max(got, rounded, torch_dtype,
                       floor=n_sub * 2.0 ** -23)
    narrow = fused_adjoint_multi(jax_array(x, jax_dtype),
                                 jax_array(g, jax_dtype), *reference,
                                 block_target=(16, 16), interpret=True)
    assert narrow.dtype == jax_dtype
    assert_ulps_at_max(got, narrow, torch_dtype, ulps=F11_ULPS)
    assert torch.equal(ad.stream_collide_adjoint_multi(
        x, g, n_sub, *args_of(stencil), tau_inv, collision_spec=spec), got)


# ----------------------------------------------------------------------
# (d) split mode at 16 bits against lettuce_tpu's split adjoint
# ----------------------------------------------------------------------
SPLIT = {
    "guo": lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.Guo(flow, 0.8, [1e-4, 0.0])),
    "mrt_lallemand": lambda pkg, flow: pkg.MRTCollision(
        pkg.D2Q9Lallemand(flow.stencil, _transform_context(pkg, flow)),
        [1.1] * 9, _transform_context(pkg, flow)),
    "kbc": lambda pkg, flow: pkg.KBCCollision(0.8),
}


def _transform_context(pkg, flow):
    """The port's MRT transform in float64 (a 16-bit context would round
    M^-1, which the float32 reference keeps to float32); the reference's
    in its own float32 context."""
    if pkg is lt:
        return flow.context
    return ltt.Context(device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("name,state", [
    ("guo", "bfloat16"), ("guo", "float16"), ("mrt_lallemand", "bfloat16"),
    ("kbc", "bfloat16")])
def test_16_bit_split_mode_matches_pallas(name, state):
    """One step's VJP through the Function in split mode (the 16-bit
    streaming transpose, then the pointwise VJP on float32 copies, rounded
    once) against the VJP of lettuce_tpu's kernel step, whose backward is
    build_adjoint_step's split adj, on the upcast state and cotangent,
    rounded. The state carries 1 % noise, as the fragment gradient tests
    hold KBC: at equilibrium KBC's guard makes the Jacobian a subgradient
    choice."""
    torch_dtype, jax_dtype = STATES[state]
    shape = [16, 128]
    jflow = lt.TaylorGreenVortex(
        lt.Context(dtype=jnp.float32, use_native=True), shape, 100, 0.05,
        stencil=lt.D2Q9(), initialize_fneq=False)
    f = np.asarray(jflow.f, dtype=np.float64)
    f = f * (1 + 1e-2 * np.random.default_rng(86).uniform(-1, 1, f.shape))
    x = sixteen(f, torch_dtype)
    g = sixteen(np.random.default_rng(87).standard_normal(f.shape),
                torch_dtype)
    jsim = lt.Simulation(jflow, SPLIT[name](lt, jflow), [])
    assert jsim._step.adjoint_mode == "split"
    _, vjp = jax.vjp(jsim._step, jax_array(x, jnp.float32))
    want = jnp.asarray(vjp(jax_array(g, jnp.float32))[0]).astype(jax_dtype)

    tflow = ltt.TaylorGreenVortex(
        ltt.Context(device="cpu", dtype=torch_dtype), shape, 100, 0.05,
        stencil=ltt.D2Q9(), initialize_fneq=False)
    tsim = ltt.Simulation(tflow, SPLIT[name](ltt, tflow), [])
    tsim._use_kernel()
    assert tsim.adjoint_mode == "split"
    x0 = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(tsim.make_step_fn()(x0), x0, g)
    assert got.dtype == torch_dtype
    assert_ulps_at_max(got, want, torch_dtype)


# ----------------------------------------------------------------------
# (e) the slice as a whole: gradient segments against lettuce_tpu's
# ----------------------------------------------------------------------
def _obstacle(pkg, ctx):
    """tests/test_torch_hybrid.py's 2D obstacle (inlet, anti-bounce-back
    outlet, a cylinder) at 32 x 128, its mask computed in float32 so that
    a 16-bit context builds it too."""
    class Flow(pkg.Obstacle):
        @property
        def boundaries(self):
            return _inlet_outlet_bb(pkg, self)

    flow = Flow(ctx, [32, 128], reynolds_number=80, mach_number=0.1,
                domain_length_x=3.2)
    flow.mask = sum((numpy64(x.float() if isinstance(x, torch.Tensor)
                             else x) - c) ** 2
                    for x, c in zip(flow.grid, (1.0, 6.0))) < 0.3
    flow.initialize()
    return flow


def _tgv(pkg, ctx, shape=(32, 32)):
    return pkg.TaylorGreenVortex(ctx, list(shape), 100, 0.05,
                                 stencil=pkg.D2Q9())


# lettuce_tpu pads a bfloat16 32 x 32 grid (its 16-row halo) and runs no
# blocked adjoint on a padded grid: the span-2 segment runs at 16 x 128
FLOWS = {"tgv": _tgv, "tgv-16x128": lambda pkg, ctx: _tgv(pkg, ctx,
                                                          (16, 128)),
         "obstacle": _obstacle}


def segment_gradients(flow_name, span=None, monkeypatch=None):
    """(the port's bf16 gradient, lettuce_tpu's bf16 gradient, the port's
    float32 gradient from the same state, the port's bf16 simulation) of
    sum(f_4^2) through make_segment_fn(4) on both kernel paths (the
    port's plain versions; lettuce_tpu's Pallas kernels in interpret
    mode), blocked at ``span`` when given."""
    if span is not None:
        monkeypatch.setenv("LETTUCE_NSUB", str(span))
    make = FLOWS[flow_name]
    jflow = make(lt, lt.Context(dtype=jnp.bfloat16, use_native=True))
    tau = float(jflow.units.relaxation_parameter_lu)
    jsim = lt.Simulation(jflow, lt.BGKCollision(tau), [])
    assert jsim._step_kind == "pallas"
    if span is not None:
        assert jsim._step_multi[0].adjoint_kernel
    jseg = jsim.make_segment_fn(SEGMENT_STEPS)
    want = jax.grad(lambda f: jnp.sum(jseg(f).astype(jnp.float32) ** 2))(
        jflow.f)
    state = np.asarray(jflow.f, dtype=np.float32)
    grads, sims = [], []
    for dtype in (torch.bfloat16, torch.float32):
        tflow = make(ltt, ltt.Context(device="cpu", dtype=dtype))
        tsim = ltt.Simulation(tflow, ltt.BGKCollision(tau), [])
        tsim._use_kernel()
        f0 = torch.as_tensor(state).to(dtype).requires_grad_(True)
        segment = tsim.make_segment_fn(SEGMENT_STEPS)
        (grad,) = torch.autograd.grad((segment(f0).float() ** 2).sum(), f0)
        grads.append(grad)
        sims.append(tsim)
    return grads[0], want, grads[1], sims[0]


@pytest.mark.parametrize("flow_name,span", [
    ("tgv", None), ("tgv-16x128", 2), ("obstacle", None)],
    ids=["tgv", "tgv-span-2", "obstacle-replay"])
def test_16_bit_segment_gradient_matches_lettuce_tpu(flow_name, span,
                                                     monkeypatch):
    got, want, wide, tsim = segment_gradients(flow_name, span, monkeypatch)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    path = {("tgv", None): "cuda x1", ("tgv-16x128", 2): "cuda x2",
            ("obstacle", None): "cuda+hybrid x1"}[flow_name, span]
    assert tsim.step_path == path
    if span is not None:
        assert tsim._step_multi[0].adjoint_kernel
    assert_ulps_at_max(got, want, torch.bfloat16, ulps=4 * SEGMENT_STEPS)
    scale = float(wide.abs().max())
    err = float(np.abs(numpy64(got) - numpy64(wide)).max()) / scale
    err_ref = float(np.abs(numpy64(want) - numpy64(wide)).max()) / scale
    print(f"{flow_name} span {span}: port {err:.3e}, lettuce_tpu "
          f"{err_ref:.3e} of the float32 gradient's largest magnitude")
    assert err <= 0.02
    if span is None:
        assert err_ref <= 0.02
    else:
        # F11: lettuce_tpu's 16-bit blocked adjoint computes in bfloat16
        # and lands further from the float32 gradient than the port's
        assert err < err_ref


# ----------------------------------------------------------------------
# (f) routing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("state", sorted(STATES))
def test_16_bit_state_saves_a_float32_u_residual(state):
    """A 16-bit state that requires grad runs _FusedStep, whose forward
    saves the emitted u in float32 and nothing else."""
    torch_dtype = STATES[state][0]
    stencil = ltt.D2Q9()
    spec = forward_spec("trt", stencil)
    x = sixteen(bounded_case(stencil, (6, 8), 88, False)[0], torch_dtype)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    x0 = x.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fused_step(x0, e=stencil.e, w=stencil.w,
                         opposite=stencil.opposite, cs=stencil.cs,
                         collision_spec=spec)
    assert out.dtype == torch_dtype
    assert type(out.grad_fn).__name__ == "_FusedStepBackward"
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (torch.float32, (2, 6, 8))]
    (grad,) = torch.autograd.grad(out.float().sum(), x0)
    assert grad.dtype == torch_dtype


def test_deviations_that_require_grad_still_raise():
    stencil = ltt.D2Q9()
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=stencil.cs, tau_inv=1.2)
    g = torch.zeros((9, 4, 6), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="throughput mode"):
        fused_multi_step(g, n_sub=2, dev_storage=True, **params)
    with pytest.raises(NotImplementedError, match="throughput mode"):
        sc.stream_collide(g, **params, dev_storage=True)


def test_16_bit_blocked_step_takes_the_blocked_adjoint(monkeypatch):
    """Under LETTUCE_NSUB a 16-bit periodic flow's blocked step takes K4
    (adjoint_kernel), as lettuce_tpu's, whose blocked adjoint is gated on
    deviation storage alone (stream_collide.py:2355-2404)."""
    monkeypatch.setenv("LETTUCE_NSUB", "2")
    for dtype in (torch.bfloat16, torch.float16):
        flow = _tgv(ltt, ltt.Context(device="cpu", dtype=dtype))
        sim = ltt.Simulation(flow, ltt.BGKCollision(0.7), [])
        sim._use_kernel()
        assert sim.step_path == "cuda x2"
        assert sim._step_multi[0].adjoint_kernel
        assert ad.adjoint_multi_refusal(
            sim._kernel_params["collision_spec"], dtype) is None


def test_the_port_imports_neither_jax_nor_lettuce_tpu():
    """Importing the port and running a 16-bit gradient pulls in neither
    jax nor lettuce_tpu (a fresh interpreter)."""
    code = (
        "import sys, torch\n"
        "import lettuce_tpu_torch as ltt\n"
        "ctx = ltt.Context(device='cpu', dtype=torch.bfloat16)\n"
        "flow = ltt.TaylorGreenVortex(ctx, [8, 8], 100, 0.05,\n"
        "                             stencil=ltt.D2Q9())\n"
        "sim = ltt.Simulation(flow, ltt.BGKCollision(0.7), [])\n"
        "sim._use_kernel()\n"
        "f0 = flow.f.clone().requires_grad_(True)\n"
        "(sim.make_segment_fn(2)(f0).float() ** 2).sum().backward()\n"
        "assert f0.grad.dtype == torch.bfloat16\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'lettuce_tpu')]\n"
        "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]


@pytest.mark.parametrize("state", sorted(STATES))
def test_mrt_spec_resolves_on_a_16_bit_context(state):
    """F12: the MRT spec of a transform built in a 16-bit context resolves
    (its matrices reach the host through float64), so a 16-bit MRT flow
    takes the kernel path and its split-mode gradient."""
    torch_dtype = STATES[state][0]
    ctx = ltt.Context(device="cpu", dtype=torch_dtype)
    flow = ltt.TaylorGreenVortex(ctx, [8, 8], 100, 0.05, stencil=ltt.D2Q9())
    transform = ltt.D2Q9Lallemand(flow.stencil, ctx)
    sim = ltt.Simulation(flow, ltt.MRTCollision(transform, [1.1] * 9, ctx),
                         [])
    spec, reason = sc.collision_spec_of(sim)
    assert reason is None and not sc.kernel_refusals(sim)
    np.testing.assert_array_equal(np.asarray(spec[1]),
                                  transform.matrix.double().numpy())
    sim._use_kernel()
    assert sim.adjoint_mode == "split"
    f0 = flow.f.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        (sim.make_segment_fn(2)(f0).float() ** 2).sum(), f0)
    assert grad.dtype == torch_dtype
    assert bool(torch.isfinite(grad.float()).all())
