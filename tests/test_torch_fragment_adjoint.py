"""The gradients of lettuce_tpu_torch's collision fragments on the CPU,
kernel by kernel: the plain adjoint of every adjoint spec (``trt``,
``matvec`` for the folded MRT and the regularized collision, ``smag``,
``none``) and the plain emit-u step of every fragment that has one,
against lettuce_tpu's Pallas kernels in interpret mode; the packed
adjoint specs; and the routes that lead to the Function.

Inputs are seeded numpy arrays handed to both packages. The forward holds
float64 to 1e-12 and float32 to 5e-6; gradients 1e-12 (float64) and 1e-5
(float32) of the reference's largest magnitude. The CUDA kernels run only
on a card; ``chip_smoke.py`` holds them against these plain versions
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.adjoint import fused_adjoint
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from lettuce_tpu_torch.ops.cuda.fused_step import _FusedStep
from lettuce_tpu_torch.ops.equilibrium import quadratic_feq
from tests.test_torch_bounded_kernel import (JAX_KINDS, assert_scaled_close,
                                             bounded_case, torch_masks)
from tests.torch_helpers import DTYPES, launch_counts

GRAD_RTOL = {"float64": 1e-12, "float32": 1e-5}
D2 = ("D2Q9", (16, 128))
D3 = ("D3Q19", (8, 8, 128))
D3_27 = ("D3Q27", (8, 8, 128))
DHUMIERES_TAUS = [1.0, 1.2, 1.1, 1.0, 1.3, 1.0, 1.3, 1.0, 1.3,
                  0.9, 1.1, 0.9, 1.1, 0.9, 0.9, 0.9, 1.2, 1.2, 1.2]


def forward_spec(name, stencil):
    """The forward collision spec of each case, packed for ``stencil``."""
    if name == "mrt":
        ctx = ltt.Context(device="cpu", dtype=torch.float64)
        flow = ltt.TaylorGreenVortex(ctx, [4, 4, 4], 100, 0.05,
                                     stencil=stencil)
        collision = ltt.MRTCollision(ltt.D3Q19DHumieres(stencil, ctx),
                                     DHUMIERES_TAUS, ctx)
        spec = sc.collision_spec_of(ltt.Simulation(flow, collision, []))[0]
    else:
        spec = {"bgk": ("bgk", 1 / 0.6), "trt": ("trt", 0.8, 1.04),
                "reg": ("reg", 0.8), "smag": ("smag", 0.8, 0.17),
                "none": ("none",), "kbc": ("kbc", 0.8),
                "guo": ("bgk_force", 1 / 0.8, (1e-4, 0.0), 0.5,
                        1 - 1 / 1.6)}[name]
    return sc.pack_spec(spec, stencil.e, stencil.w, stencil.opposite)


def args_of(stencil):
    return (stencil.e, stencil.w, stencil.opposite, stencil.cs)


# ----------------------------------------------------------------------
# the plain adjoint of every spec against the Pallas adjoint kernel
# ----------------------------------------------------------------------
# (spec, grid, dtype, masks): masks "" (periodic), "codes" (every boundary
# kind), "codes+frozen" or "frozen" (the no-streaming mask alone)
ADJOINT_CASES = {
    "trt-d2q9": ("trt", D2, "float64", ""),
    "trt-d2q9-f32": ("trt", D2, "float32", ""),
    "trt-d3q19-masked": ("trt", D3, "float64", "codes+frozen"),
    "matvec-mrt-d3q19": ("mrt", D3, "float64", ""),
    "matvec-mrt-d3q19-f32": ("mrt", D3, "float32", ""),
    "matvec-reg-d2q9": ("reg", D2, "float64", ""),
    "matvec-reg-d2q9-masked": ("reg", D2, "float64", "codes+frozen"),
    "matvec-reg-d3q27": ("reg", D3_27, "float64", ""),
    "smag-d2q9": ("smag", D2, "float64", ""),
    "smag-d2q9-f32": ("smag", D2, "float32", ""),
    "smag-d3q19-masked": ("smag", D3, "float64", "codes"),
    "none-d2q9-frozen": ("none", D2, "float64", "frozen"),
    "none-d2q9-masked": ("none", D2, "float64", "codes+frozen"),
}


@pytest.mark.parametrize("case", sorted(ADJOINT_CASES))
def test_plain_adjoint_matches_pallas_kernel(case):
    name, (stencil_name, shape), dtype_name, masks = ADJOINT_CASES[case]
    jax_dtype, torch_dtype, _ = DTYPES[dtype_name]
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name, stencil)
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 51,
                                           "frozen" in masks)
    g = np.random.default_rng(52).standard_normal(f.shape)
    codes = "codes" in masks
    tmasks = torch_masks(ncm, nsm, feq, table, torch_dtype)
    if not codes:
        tmasks = dict(nsm=tmasks["nsm"])
    residual_u = spec.residual == "u"
    if residual_u:
        _, res = sc.stream_collide_plain(torch.as_tensor(f),
                                         *args_of(stencil), None,
                                         collision_spec=spec, emit_u=True)
        res = res.numpy()
    else:
        res = f
    want = fused_adjoint(
        None if spec.residual is None else jnp.asarray(res, dtype=jax_dtype),
        jnp.asarray(g, dtype=jax_dtype), *args_of(stencil),
        spec=spec.adjoint,
        no_collision_mask=jnp.asarray(ncm) if codes else None,
        no_streaming_mask=nsm, boundary_kinds=JAX_KINDS if codes else (),
        residual_u=residual_u, interpret=True)
    got = ad.stream_collide_adjoint_plain(
        torch.as_tensor(g, dtype=torch_dtype),
        None if spec.residual is None
        else torch.as_tensor(res, dtype=torch_dtype),
        *args_of(stencil), None, collision_spec=spec, **tmasks)
    assert got.dtype == torch_dtype
    assert_scaled_close(got, want, GRAD_RTOL[dtype_name])


# ----------------------------------------------------------------------
# the plain emit-u step of every fragment against the Pallas kernel
# ----------------------------------------------------------------------
EMIT_U_CASES = {
    "trt-d2q9": ("trt", D2, False),
    "trt-d2q9-masked": ("trt", D2, True),
    "reg-d3q27": ("reg", D3_27, False),
    "reg-d2q9-masked": ("reg", D2, True),
    "mrt-d3q19": ("mrt", D3, False),
    "mrt-d3q19-masked": ("mrt", D3, True),
}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(EMIT_U_CASES))
def test_plain_emit_u_matches_pallas_kernel(case, dtype_name):
    name, (stencil_name, shape), masked = EMIT_U_CASES[case]
    jax_dtype, torch_dtype, atol = DTYPES[dtype_name]
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name, stencil)
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 53, True)
    jmasks, tmasks = {}, {}
    if masked:
        jmasks = dict(no_collision_mask=jnp.asarray(ncm),
                      no_streaming_mask=jnp.asarray(nsm),
                      boundary_kinds=JAX_KINDS,
                      feq_boundary=(None, table[2][1], None, None),
                      feq_field=jnp.asarray(feq, dtype=jax_dtype))
        tmasks = torch_masks(ncm, nsm, feq, table, torch_dtype)
    want_f, want_u = fused_stream_collide(
        jnp.asarray(f, dtype=jax_dtype), *args_of(stencil), None,
        collision_spec=tuple(spec), emit_u=True, interpret=True, **jmasks)
    got_f, got_u = sc.stream_collide_plain(
        torch.as_tensor(f, dtype=torch_dtype), *args_of(stencil), None,
        collision_spec=spec, emit_u=True, **tmasks)
    assert got_u.dtype == torch_dtype
    assert tuple(got_u.shape) == (stencil.d, *shape)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=0,
                               atol=atol)


# ----------------------------------------------------------------------
# the packed adjoint specs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,stencil_name", [
    ("bgk", "D2Q9"), ("trt", "D3Q15"), ("reg", "D3Q27"), ("mrt", "D3Q19"),
    ("smag", "D3Q19"), ("none", "D2Q9"), ("kbc", "D3Q27"), ("guo", "D2Q9")])
def test_packed_adjoint_spec(name, stencil_name):
    """Each spec's mode and residual, and for matvec the folded C^T that
    csrc/adjoint_fragments.cu reads: its even and odd blocks reproduce
    C^T v on a seeded vector."""
    stencil = getattr(ltt, stencil_name)()
    spec = forward_spec(name, stencil)
    want = {"bgk": ("bgk", "full", "u"), "trt": ("trt", "full", "u"),
            "reg": ("matvec", "full", "u"), "mrt": ("matvec", "full", "u"),
            "smag": ("smag", "full", "f"), "none": ("none", "full", None),
            "kbc": ("kbc", "full", "f"), "guo": ("split", "split", "f")}
    assert (spec.adjoint[0], spec.mode, spec.residual) == want[name]
    if spec.adjoint[0] != "matvec":
        np.testing.assert_array_equal(spec.adjoint_params,
                                      np.asarray(spec.adjoint[1:] or (0.0,)))
        return
    ct = np.asarray(spec.adjoint[1])
    opp = stencil.opposite
    q = len(opp)
    firsts = [a for a in range(q) if a < opp[a]]
    P, R = len(firsts), len(firsts) + 1
    params = spec.adjoint_params
    assert params.size == R * R + P * P
    ce = params[:R * R].reshape(R, R)
    co = params[R * R:].reshape(P, P)
    v = np.random.default_rng(55).standard_normal(q)
    ue = np.array([v[0]] + [v[a] + v[opp[a]] for a in firsts])
    uo = np.array([v[a] - v[opp[a]] for a in firsts])
    tv = np.empty(q)
    tv[0] = ce[0] @ ue
    for k, a in enumerate(firsts):
        ev, od = ce[k + 1] @ ue, co[k] @ uo
        tv[a], tv[opp[a]] = ev + od, ev - od
    np.testing.assert_allclose(tv, ct @ v, rtol=0, atol=1e-12)


def test_regularized_matvec_is_its_collision():
    """The regularized collision is f - C (f - feq) with C = I - (1 - 1/tau)
    P: the packed C^T reproduces the plain fragment's step."""
    stencil = ltt.D3Q27()
    spec = forward_spec("reg", stencil)
    f = torch.as_tensor(bounded_case(stencil, (3, 4, 5), 56, False)[0])
    et = torch.as_tensor(stencil.e, dtype=f.dtype)
    rho = f.sum(0, keepdim=True)
    u = torch.tensordot(et.T, f, dims=1) / rho
    feq = quadratic_feq(et, torch.as_tensor(stencil.w), stencil.cs, rho, u)
    c = torch.as_tensor(np.asarray(spec.adjoint[1])).T
    want = f - torch.tensordot(c, f - feq, dims=1)
    got = sc.collide_plain(f, spec, *args_of(stencil)[:3], stencil.cs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-15)


# ----------------------------------------------------------------------
# the routes to the Function
# ----------------------------------------------------------------------
def test_autograd_route_keeps_the_collision_spec():
    """stream_collide on a state that requires grad goes through the
    Function with the spec it was given: its gradient is the TRT step's,
    not the BGK step's of the same tau_inv argument."""
    stencil = ltt.D2Q9()
    spec = forward_spec("trt", stencil)
    f = torch.as_tensor(bounded_case(stencil, (6, 8), 57, False)[0])
    g = torch.as_tensor(np.random.default_rng(58).standard_normal(f.shape))
    x = f.clone().requires_grad_(True)
    out = sc.stream_collide(x, *args_of(stencil), 1 / 0.6,
                            collision_spec=spec)
    assert type(out.grad_fn).__name__ == f"{_FusedStep.__name__}Backward"
    (got,) = torch.autograd.grad(out, x, g)
    y = f.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(sc.stream_collide_plain(
        y, *args_of(stencil), None, collision_spec=spec), y, g)
    assert_scaled_close(got, want, 1e-12)
    z = f.clone().requires_grad_(True)
    (bgk,) = torch.autograd.grad(sc.stream_collide_plain(
        z, *args_of(stencil), 1 / 0.6), z, g)
    assert float((bgk - want).abs().max()) > 1e-3 * float(want.abs().max())
    with pytest.raises(ValueError, match="bypass autograd"):
        sc.stream_collide(x, *args_of(stencil), None, collision_spec=spec,
                          out=torch.empty_like(f))


def test_emit_u_is_refused_for_fragments_without_an_adjoint_residual():
    stencil = ltt.D2Q9()
    f = torch.as_tensor(bounded_case(stencil, (6, 8), 59, False)[0])
    u = torch.empty((2, 6, 8), dtype=f.dtype)
    for name in ("smag", "kbc", "none"):
        with pytest.raises(ValueError, match="emit_u is for"):
            sc.stream_collide(f, *args_of(stencil), None,
                              collision_spec=forward_spec(name, stencil),
                              u_out=u)


def test_split_spec_has_no_closed_form_adjoint():
    stencil = ltt.D2Q9()
    g = torch.zeros((9, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="split mode"):
        ad.stream_collide_adjoint(g, g, *args_of(stencil), None,
                                  collision_spec=forward_spec("guo", stencil))


def test_wrappers_run_plain_on_cpu_tensors():
    """The fragment wrappers on CPU tensors: the plain versions, into
    ``out`` when given, with no launch counted; the frozen-only adjoint
    re-routes by the no-streaming mask alone."""
    stencil = ltt.D3Q19()
    f, ncm, nsm, feq, table = bounded_case(stencil, (5, 6, 7), 60, True)
    f = torch.as_tensor(f)
    g = torch.as_tensor(np.random.default_rng(61).standard_normal(f.shape))
    spec = forward_spec("mrt", stencil)
    counts = launch_counts("K1", "K3")
    out, u = torch.empty_like(f), torch.empty((3, 5, 6, 7),
                                              dtype=torch.float64)
    assert sc.stream_collide(f, *args_of(stencil), None, collision_spec=spec,
                             out=out, u_out=u) == (out, u)
    want_f, want_u = sc.stream_collide_plain(
        f, *args_of(stencil), None, collision_spec=spec, emit_u=True)
    assert torch.equal(out, want_f) and torch.equal(u, want_u)
    ct = torch.empty_like(g)
    got = ad.stream_collide_adjoint(g, u, *args_of(stencil), None,
                                    collision_spec=spec, out=ct)
    assert got is ct and torch.equal(ct, ad.stream_collide_adjoint_plain(
        g, u, *args_of(stencil), None, collision_spec=spec))
    frozen = torch.as_tensor(nsm)
    h = ad.stream_collide_adjoint(g, None, *args_of(stencil), None,
                                  nsm=frozen, collision_spec=ad.NONE_SPEC)
    assert torch.equal(h, ad._pull(g, stencil.e, frozen))
    assert launch_counts("K1", "K3") == counts
