"""The collision fragments of lettuce_tpu_torch's kernel on the CPU: the
plain step of every collision spec (``stream_collide_plain`` with
``collision_spec``) against lettuce_tpu's jnp step and, one case per
fragment kind, against its Pallas kernel in interpret mode; the masked
path with every D2Q9 fragment against the jnp step; the packed MRT
parameters; the capability probe and the gate on a CPU context that says
``cuda``; and a fragment's gradient through the fused Function.

Inputs are seeded numpy arrays handed to both packages; float64 agrees to
1e-12, float32 to 5e-6. The CUDA kernels run only on a card;
``chip_smoke.py`` holds them against these plain versions there."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda import adjoint
from lettuce_tpu_torch.ops.cuda.fused_step import fused_step
from tests.test_torch_hybrid import obstacle
from tests.torch_helpers import DTYPES, contexts, hand_state, noisy_state, \
    to_numpy

D2 = ("D2Q9", [16, 128])
D3 = ("D3Q19", [16, 16, 128])
D3_27 = ("D3Q27", [8, 8, 128])


def _mrt(name, taus):
    def make(pkg, flow):
        transform = getattr(pkg, name)(flow.stencil, flow.context)
        return pkg.MRTCollision(transform, taus, flow.context)
    return make


D2_TAUS = [1.0, 1.0, 1.0, 1.3, 1.3, 1.2, 1.1, 1.1, 1.2]
# spec name -> (grid, factory(pkg, flow)): the shapes of
# tests/test_native.py:217-234 plus the four MRT kinds
SPECS = {
    "trt-3d": (D3, lambda pkg, flow: pkg.TRTCollision(0.8, 1.1)),
    "reg-3d": (D3, lambda pkg, flow: pkg.RegularizedCollision(0.8)),
    "reg-q27": (D3_27, lambda pkg, flow: pkg.RegularizedCollision(0.8)),
    "smag-3d": (D3, lambda pkg, flow: pkg.SmagorinskyCollision(0.8)),
    "kbc-q27": (D3_27, lambda pkg, flow: pkg.KBCCollision()),
    "kbc-q9": (D2, lambda pkg, flow: pkg.KBCCollision()),
    "trt-2d": (D2, lambda pkg, flow: pkg.TRTCollision(0.8, 1.1)),
    "guo-2d": (D2, lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.Guo(flow, 0.8, [1e-4, 0.0]))),
    "shanchen-2d": (D2, lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.ShanChen(flow, 0.8, [1e-4, 0.0]))),
    "guo-3d": (D3, lambda pkg, flow: pkg.BGKCollision(
        0.8, force=pkg.Guo(flow, 0.8, [1e-4, 0.0, 5e-5]))),
    "none-2d": (D2, lambda pkg, flow: pkg.NoCollision()),
    "mrt-lallemand": (D2, _mrt("D2Q9Lallemand", D2_TAUS)),
    "mrt-dellar": (D2, _mrt("D2Q9Dellar", D2_TAUS)),
    "mrt-dhumieres": (D3, _mrt("D3Q19DHumieres",
                               [1.0] * 3 + [1.1, 1.2] * 8)),
    "mrt-hermite": (D3_27, _mrt("D3Q27Hermite",
                                [1.0] * 4 + [0.9] * 6 + [1.2] * 17)),
}
# one case per fragment kind in interpret mode (slow on the CPU)
INTERPRET = ["none-2d", "guo-2d", "trt-2d", "reg-3d", "smag-3d", "kbc-q9",
             "mrt-lallemand", "mrt-dhumieres"]


def spec_pair(name, dtype_name):
    """(jax simulation, torch simulation, the port's packed spec) for one
    SPECS case, both on the TGV state plus the same seeded noise."""
    (stencil, grid), make = SPECS[name]
    jctx, tctx = contexts(dtype_name)
    flows = []
    for pkg, ctx in ((lt, jctx), (ltt, tctx)):
        flows.append(pkg.TaylorGreenVortex(
            ctx, grid, 100, 0.05, stencil=getattr(pkg, stencil)(),
            initialize_fneq=False))
    jflow, tflow = flows
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=21, scale=1e-4))
    jsim = lt.Simulation(jflow, make(lt, jflow), [])
    tsim = ltt.Simulation(tflow, make(ltt, tflow), [])
    spec, reason = sc.collision_spec_of(tsim)
    assert reason is None
    st = tflow.stencil
    return jsim, tsim, sc.pack_spec(spec, st.e, st.w, st.opposite)


def plain_args(stencil):
    return (stencil.e, stencil.w, stencil.opposite, stencil.cs, None)


# ----------------------------------------------------------------------
# the plain step of every spec against the jnp step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_step_matches_jnp_step(name, dtype_name):
    jsim, tsim, spec = spec_pair(name, dtype_name)
    assert jsim._step_kind == "jnp"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jsim._step(jsim.flow.f)
    got = sc.stream_collide_plain(tsim.flow.f, *plain_args(tsim.flow.stencil),
                                  collision_spec=spec)
    assert got.dtype == DTYPES[dtype_name][1]
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=DTYPES[dtype_name][2])


# ----------------------------------------------------------------------
# one case per fragment kind against the Pallas kernel in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", INTERPRET)
def test_plain_step_matches_pallas_fragment(name):
    jsim, tsim, spec = spec_pair(name, "float32")
    st = tsim.flow.stencil
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fused_stream_collide(
            jsim.flow.f, np.asarray(st.e), np.asarray(st.w),
            np.asarray(st.opposite), float(st.cs), None,
            collision_spec=tuple(spec), interpret=True)
    got = sc.stream_collide_plain(tsim.flow.f, *plain_args(st),
                                  collision_spec=spec)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=5e-6)


# ----------------------------------------------------------------------
# the masked path: kernel step (plain on the CPU) + outlet replay
# ----------------------------------------------------------------------
MASKED = ["none-2d", "guo-2d", "shanchen-2d", "trt-2d", "kbc-q9",
          "mrt-lallemand", "mrt-dellar", "reg", "smag"]


def _masked_collision(name):
    if name == "reg":
        return lambda pkg, flow: pkg.RegularizedCollision()
    if name == "smag":
        return lambda pkg, flow: pkg.SmagorinskyCollision(0.7)
    return SPECS[name][1]


@pytest.mark.parametrize("name", MASKED)
def test_masked_fragment_step_matches_jnp_step(name):
    """The obstacle flow of tests/test_native.py with each D2Q9 fragment:
    the kernel path (masked plain step, then the outlet replay with the
    same collision) against lettuce_tpu's jnp step over 4 steps."""
    make = _masked_collision(name)
    jflow = obstacle(lt, lt.Context(dtype=jnp.float64, use_native=False))
    tflow = obstacle(ltt, ltt.Context(device="cpu", dtype=torch.float64,
                                      use_native=False))
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=22, scale=1e-4))
    jsim = lt.Simulation(jflow, make(lt, jflow), [])
    tsim = ltt.Simulation(tflow, make(ltt, tflow), [])
    tsim._use_kernel()
    assert tsim.step_path == "cuda+hybrid x1"
    assert tsim._fixup is not None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim(4)
        tsim(4)
    np.testing.assert_allclose(to_numpy(tflow.f), np.asarray(jflow.f),
                               rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# the packed MRT parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mrt-lallemand", "mrt-dellar",
                                  "mrt-dhumieres", "mrt-hermite"])
def test_folded_mrt_matrices_apply_c_and_a(name):
    """The even and odd blocks the MRT fragment reads reproduce C v and
    A m on seeded vectors, as csrc/collide_mrt.cu applies them."""
    _, tsim, spec = spec_pair(name, "float64")
    _, M, Minv, taus, meq_kind = spec
    M, Minv = np.asarray(M), np.asarray(Minv)
    s = 1.0 / np.asarray(taus)
    C = Minv @ (s[:, None] * M)
    A = Minv * s[None, :]
    opp = tsim.flow.stencil.opposite
    q = len(opp)
    firsts = [a for a in range(q) if a < opp[a]]
    P, R = len(firsts), len(firsts) + 1
    params = spec.params
    ce = params[:R * R].reshape(R, R)
    co = params[R * R:R * R + P * P].reshape(P, P)
    rng = np.random.default_rng(23)
    v = rng.standard_normal(q)
    ue = np.array([v[0]] + [v[a] + v[opp[a]] for a in firsts])
    uo = np.array([v[a] - v[opp[a]] for a in firsts])
    cv = np.empty(q)
    cv[0] = ce[0] @ ue
    for k, a in enumerate(firsts):
        ev, od = ce[k + 1] @ ue, co[k] @ uo
        cv[a], cv[opp[a]] = ev + od, ev - od
    np.testing.assert_allclose(cv, C @ v, rtol=0, atol=1e-12)
    if meq_kind == "from_feq":
        assert params.size == R * R + P * P
        return
    parity = np.asarray(sc.MRT_PARITY[meq_kind])
    rest = params[R * R + P * P:]
    ae = rest[:R * q].reshape(R, q)
    ao = rest[R * q:].reshape(P, q)
    m = rng.standard_normal(q)
    am = np.empty(q)
    am[0] = ae[0] @ (m * (parity > 0))
    for k, a in enumerate(firsts):
        ev, od = ae[k + 1] @ (m * (parity > 0)), ao[k] @ (m * (parity < 0))
        am[a], am[opp[a]] = ev + od, ev - od
    np.testing.assert_allclose(am, A @ m, rtol=0, atol=1e-12)


def test_mrt_without_the_kernels_parity_is_refused():
    """A moment basis whose rows lack the parity the kernel assumes (here
    Lallemand's with two rows swapped) is refused when packed."""
    _, tsim, spec = spec_pair("mrt-lallemand", "float64")
    M = np.asarray(spec[1])[[0, 1, 3, 2, 4, 5, 6, 7, 8]]
    bad = ("mrt", tuple(map(tuple, M)),
           tuple(map(tuple, np.linalg.inv(M))), spec[3], "lallemand")
    st = tsim.flow.stencil
    with pytest.raises(NotImplementedError, match="parity"):
        sc.pack_spec(bad, st.e, st.w, st.opposite)


# ----------------------------------------------------------------------
# the probe and the gate on a CPU context that says cuda
# ----------------------------------------------------------------------
def _probe(flow, collision, capsys):
    """(the probe's verdict on a CUDA context, what it printed, whether
    the gate accepts); the kernel path is selected when it accepts."""
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
    return sim, ok, printed, gate


def _ctx():
    return ltt.Context(device="cpu", dtype=torch.float32, use_native=True)


def _tgv(stencil, grid):
    return lambda: ltt.TaylorGreenVortex(_ctx(), grid, 100, 0.05,
                                         stencil=getattr(ltt, stencil)(),
                                         initialize_fneq=False)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_probe_puts_every_spec_on_the_kernel(name, capsys):
    (stencil, grid), make = SPECS[name]
    flow = _tgv(stencil, [4] * (len(grid) - 1) + [8])()
    sim, ok, printed, gate = _probe(flow, make(ltt, flow), capsys)
    assert ok and gate and printed == ""
    assert sim.step_path == "cuda x1"
    spec = sim._kernel_params["collision_spec"]
    assert isinstance(spec, sc.PackedSpec)
    assert spec.fragment in sc.FRAGMENTS or spec.fragment == "bgk"


def test_probe_puts_a_fragment_with_outlets_on_the_hybrid_path(capsys):
    flow = obstacle(ltt, _ctx())
    sim, ok, printed, gate = _probe(flow, ltt.KBCCollision(), capsys)
    assert ok and gate and printed == ""
    assert sim.step_path == "cuda+hybrid x1"


REFUSED = {
    "per_node_acceleration": (_tgv("D2Q9", [8, 8]), lambda flow:
        ltt.BGKCollision(0.8, force=ltt.Guo(
            flow, 0.8, np.full((2, 8, 8), 1e-5)))),
    "smagorinsky_with_force": (_tgv("D2Q9", [8, 8]), lambda flow:
        ltt.SmagorinskyCollision(0.8, force=ltt.Guo(flow, 0.8, [1e-5, 0]))),
    "kbc_d3q19": (_tgv("D3Q19", [4, 4, 8]), lambda flow: ltt.KBCCollision()),
    "mrt_without_closed_form": (_tgv("D3Q27", [4, 4, 8]), lambda flow:
        ltt.MRTCollision(ltt.Transform(flow.stencil, flow.context),
                         [0.8] * 27, flow.context)),
    "mrt_d1q3_transform_on_d2q9": (_tgv("D2Q9", [8, 8]), lambda flow:
        ltt.MRTCollision(ltt.D1Q3Transform(ltt.D1Q3(), flow.context),
                         [0.8] * 3, flow.context)),
}
REASONS = {
    "per_node_acceleration": "per-node acceleration",
    "smagorinsky_with_force": "with a force has no CUDA fragment",
    "kbc_d3q19": "'kbc' fragment is compiled for d2q9, d3q27, not d3q19",
    "mrt_without_closed_form": "no closed-form equilibrium",
    "mrt_d1q3_transform_on_d2q9": "no closed-form equilibrium",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_probe_and_gate_refuse_with_the_reason(name, capsys):
    make_flow, make_collision = REFUSED[name]
    flow = make_flow()
    sim, ok, printed, gate = _probe(flow, make_collision(flow), capsys)
    assert not ok and not gate
    assert sim.step_path == "torch x1"
    assert "native was requested, but" in printed
    assert REASONS[name] in printed


def test_refuses_a_collision_without_a_fragment():
    flow = _tgv("D2Q9", [8, 8])()
    sim = ltt.Simulation(flow, ltt.SmagorinskyCollision(0.8), [])
    sim.collision = object.__new__(type("Custom", (ltt.Collision,), {
        "__call__": lambda self, flow: flow.f}))
    assert sc.kernel_refusals(sim) == [
        "collision 'Custom' has no CUDA fragment"]


# ----------------------------------------------------------------------
# gradients: the fused Function for every fragment
# ----------------------------------------------------------------------
def test_trt_gradient_runs_the_fused_step(capsys):
    """On the kernel path a TRT simulation's differentiable step is the
    fused Function (full mode), nothing is printed, and its gradient is
    autograd's of the torch step; the Function and the adjoint wrapper
    take the TRT spec."""
    flow = _tgv("D2Q9", [8, 8])()
    sim, ok, _, _ = _probe(flow, ltt.TRTCollision(0.8, 1.1), capsys)
    assert ok and sim._step_kind == "cuda"
    step = sim.make_step_fn()
    assert step.func is fused_step and step.keywords == sim._kernel_params
    assert sim.adjoint_mode == "full"
    f0 = flow.f.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((sim.make_segment_fn(2)(f0) ** 2).sum(),
                                  f0)
    assert capsys.readouterr().out == ""
    f1 = flow.f.clone().requires_grad_(True)
    want = sim._torch_step(sim._torch_step(f1))
    (grad_ref,) = torch.autograd.grad((want ** 2).sum(), f1)
    scale = float(grad_ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=0,
                               atol=1e-5 * scale)
    sim(1)  # a state that does not require grad: no message either
    assert capsys.readouterr().out == ""
    params = sim._kernel_params
    out = fused_step(flow.f, **params)
    assert torch.equal(out, sc.stream_collide_plain(flow.f, **params))
    u = torch.empty((2, 8, 8))
    sc.stream_collide(flow.f, **params, u_out=u)
    g = torch.ones_like(flow.f)
    assert torch.equal(adjoint.stream_collide_adjoint(g, u, **params),
                       adjoint.stream_collide_adjoint_plain(g, u, **params))


def test_bgk_keeps_the_fused_step():
    flow = _tgv("D2Q9", [8, 8])()
    sim = ltt.Simulation(flow, ltt.BGKCollision(0.8), [])
    sim._use_kernel()
    step = sim.make_step_fn()
    assert step.func is fused_step
    assert sim._kernel_params["collision_spec"] == ("bgk", 1 / 0.8)
    assert sim._kernel_params["tau_inv"] == 1 / 0.8
