"""The mask pipeline of lettuce_tpu_torch's kernels on the CPU: the plain
masked step (``stream_collide_plain`` with ncm/nsm/table/field) and the
plain masked adjoint against lettuce_tpu's Pallas kernels in interpret
mode and against ``jax.vjp`` of its jnp step, the Function with masks, and
the wrappers' routing and checks.

Inputs are seeded numpy arrays handed to both packages. The forward holds
float64 to 1e-12 and float32 to 5e-6; gradients 1e-12 (float64) and 1e-5
(float32) of the reference's largest magnitude. The CUDA kernels run only
on a card; ``chip_smoke.py`` holds them against these plain versions
there."""

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
from tests.torch_helpers import (DTYPES, TorchTestFlow, launch_counts,
                                 to_numpy)

TAU_INV = 1.0 / 0.6
GRAD_RTOL = {"float64": 1e-12, "float32": 1e-5}
# the shapes tests/test_native.py runs the Pallas kernel at
KERNEL_GRIDS = [("D2Q9", (16, 128)), ("D2Q9", (32, 128)),
                ("D3Q19", (16, 16, 128))]
GRID_IDS = ["d2q9-16x128", "d2q9-32x128", "d3q19-16x16x128"]
# code -> the TPU kernel's boundary_kinds; code 4 is left unclaimed there
# (identity), as a hybrid outlet's code is
JAX_KINDS = (("bounce_back", 1), ("equilibrium_pu", 2),
             ("equilibrium_pu_field", 3))


def bounded_case(stencil, shape, seed, frozen):
    """A state near rest and the masks of a bounded flow, as numpy:
    codes 1 bounce back (a blob), 2 a constant equilibrium (plane x = 0),
    3 a per-node equilibrium field (plane y = 0), 4 identity (plane
    x = -1); with ``frozen``, every population frozen on the plane
    x = n0 // 2 and the odd ones on y = 1."""
    rng = np.random.default_rng(seed)
    q, d = stencil.e.shape
    w = stencil.w.reshape((-1,) + (1,) * d)
    f = w * (1 + rng.uniform(-0.1, 0.1, (q, *shape)))
    feq = w * (1 + rng.uniform(-0.05, 0.05, (q, *shape)))
    ncm = np.zeros(shape, np.uint8)
    grid = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    ncm[sum((x - n / 3) ** 2 for x, n in zip(grid, shape)) < 12] = 1
    ncm[0] = 2
    ncm[:, 0] = 3
    ncm[-1] = 4
    nsm = None
    if frozen:
        nsm = np.zeros((q, *shape), bool)
        nsm[:, shape[0] // 2] = True
        nsm[1::2, :, 1] = True
    values = tuple(float(v) for v in 1.01 * stencil.w)
    table = (("collide", None), ("bounce_back", None),
             ("equilibrium_pu", values), ("equilibrium_pu_field", None),
             ("identity", None))
    return f, ncm, nsm, feq, table


def torch_masks(ncm, nsm, feq, table, dtype):
    return dict(ncm=torch.as_tensor(ncm),
                nsm=None if nsm is None else torch.as_tensor(nsm),
                table=table, feq_field=torch.as_tensor(feq, dtype=dtype))


def kernel_args(stencil):
    return (stencil.e, stencil.w, stencil.opposite, stencil.cs, TAU_INV)


def assert_scaled_close(got, want, rtol):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ----------------------------------------------------------------------
# the plain masked step against the Pallas kernel in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("frozen", [False, True], ids=["codes", "frozen"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name,shape", KERNEL_GRIDS, ids=GRID_IDS)
def test_masked_step_matches_pallas_kernel(stencil_name, shape, dtype_name,
                                           frozen):
    jax_dtype, torch_dtype, atol = DTYPES[dtype_name]
    stencil = getattr(ltt, stencil_name)()
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 41, frozen)
    want_f, want_u = fused_stream_collide(
        jnp.asarray(f, dtype=jax_dtype), *kernel_args(stencil),
        no_collision_mask=jnp.asarray(ncm),
        no_streaming_mask=None if nsm is None else jnp.asarray(nsm),
        boundary_kinds=JAX_KINDS, feq_boundary=(None, table[2][1], None,
                                                None),
        feq_field=jnp.asarray(feq, dtype=jax_dtype), emit_u=True,
        interpret=True)
    got_f, got_u = sc.stream_collide_plain(
        torch.as_tensor(f, dtype=torch_dtype), *kernel_args(stencil),
        **torch_masks(ncm, nsm, feq, table, torch_dtype), emit_u=True)
    assert got_f.dtype == torch_dtype
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=0,
                               atol=atol)


# ----------------------------------------------------------------------
# the plain masked adjoint against the Pallas adjoint in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("frozen", [False, True], ids=["codes", "frozen"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name,shape", KERNEL_GRIDS, ids=GRID_IDS)
def test_masked_adjoint_matches_pallas_kernel(stencil_name, shape,
                                              dtype_name, frozen):
    jax_dtype, torch_dtype, _ = DTYPES[dtype_name]
    stencil = getattr(ltt, stencil_name)()
    f, ncm, nsm, feq, table = bounded_case(stencil, shape, 42, frozen)
    g = np.random.default_rng(43).standard_normal(f.shape)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64)
    _, u = sc.stream_collide_plain(torch.as_tensor(f),
                                   *kernel_args(stencil), **masks,
                                   emit_u=True)
    u = u.numpy()
    want = fused_adjoint(jnp.asarray(u, dtype=jax_dtype),
                         jnp.asarray(g, dtype=jax_dtype),
                         *kernel_args(stencil)[:4], spec=("bgk", TAU_INV),
                         no_collision_mask=jnp.asarray(ncm),
                         no_streaming_mask=nsm, boundary_kinds=JAX_KINDS,
                         residual_u=True, interpret=True)
    got = ad.stream_collide_adjoint_plain(
        torch.as_tensor(g, dtype=torch_dtype),
        torch.as_tensor(u, dtype=torch_dtype), *kernel_args(stencil),
        **torch_masks(ncm, nsm, feq, table, torch_dtype))
    assert got.dtype == torch_dtype
    assert_scaled_close(got, want, GRAD_RTOL[dtype_name])


# ----------------------------------------------------------------------
# the plain masked adjoint against jax.vjp of lettuce_tpu's jnp step
# ----------------------------------------------------------------------
class _JaxFrozenPlane(lt.BounceBackBoundary):
    def make_no_streaming_mask(self, shape, context):
        m = np.zeros(tuple(shape), dtype=bool)
        m[:, 4] = True
        m[1::2, :, 2] = True
        return context.convert_to_tensor(m)


class _TorchFrozenPlane(ltt.BounceBackBoundary):
    def make_no_streaming_mask(self, shape, context):
        m = np.zeros(tuple(shape), dtype=bool)
        m[:, 4] = True
        m[1::2, :, 2] = True
        return context.convert_to_tensor(m)


@pytest.mark.parametrize("stencil_name,shape",
                         [("D2Q9", (12, 10)), ("D3Q19", (7, 6, 5))],
                         ids=["d2q9", "d3q19"])
def test_masked_adjoint_matches_vjp_of_jnp_step(stencil_name, shape):
    """A flow with bounce back, a frozen plane, a uniform and a per-node
    equilibrium boundary: the gate's table and masks, the plain masked
    adjoint, against jax.vjp of the whole jnp step."""
    from tests.conftest import TestFlow
    d = len(shape)
    solid = np.zeros(shape, bool)
    solid[(slice(3, 5),) * d] = True
    frozen = np.zeros(shape, bool)
    frozen[(slice(None),) + (slice(1, 2),) * (d - 1)] = True
    inlet = np.zeros(shape, bool)
    inlet[0] = True
    wall = np.zeros(shape, bool)
    wall[:, -1] = True
    velocity = 0.05 * np.random.default_rng(44).uniform(size=(d, *shape))
    u_in = [0.03] + [0.0] * (d - 1)

    def boundaries(pkg, frozen_cls, ctx):
        return [pkg.BounceBackBoundary(solid), frozen_cls(frozen),
                pkg.EquilibriumBoundaryPU(ctx, inlet, u_in, 0.001),
                pkg.EquilibriumBoundaryPU(ctx, wall, velocity)]

    jctx = lt.Context(dtype=jnp.float64, use_native=False)
    tctx = ltt.Context(device="cpu", dtype=torch.float64,
                       use_native=False)
    jflow = TestFlow(jctx, list(shape), stencil=getattr(lt, stencil_name)())
    tflow = TorchTestFlow(tctx, list(shape),
                          stencil=getattr(ltt, stencil_name)())
    jflow._boundaries = boundaries(lt, _JaxFrozenPlane, jctx)
    tflow._boundaries = boundaries(ltt, _TorchFrozenPlane, tctx)
    stencil = tflow.stencil
    f = stencil.w.reshape((-1,) + (1,) * d) * (
        1 + np.random.default_rng(45).uniform(-0.1, 0.1, tflow.f.shape))
    g = np.random.default_rng(46).standard_normal(f.shape)
    jsim = lt.Simulation(jflow, lt.BGKCollision(1.0 / TAU_INV), [])
    step = jsim._build_jnp_step()
    (want,) = jax.jit(lambda x, c: jax.vjp(step, x)[1](c))(
        jnp.asarray(f), jnp.asarray(g))

    tsim = ltt.Simulation(tflow, ltt.BGKCollision(1.0 / TAU_INV), [])
    params, hybrid = sc.gate_fused_params(tsim)
    assert hybrid == ()
    # codes by class name: the frozen plane's sorts last
    assert [kind for kind, _ in params["table"]] == [
        "collide", "bounce_back", "equilibrium_pu", "equilibrium_pu_field",
        "bounce_back"]
    assert params["nsm"] is not None and params["feq_field"] is not None
    _, u = sc.stream_collide_plain(torch.as_tensor(f), **params,
                                   emit_u=True)
    got = ad.stream_collide_adjoint_plain(torch.as_tensor(g), u, **params)
    assert_scaled_close(got, want, GRAD_RTOL["float64"])
    # and the forward of the same configuration against the jnp step
    np.testing.assert_allclose(
        sc.stream_collide_plain(torch.as_tensor(f), **params).numpy(),
        np.asarray(jax.jit(step)(jnp.asarray(f))), rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# the Function with masks, and the wrappers on the CPU
# ----------------------------------------------------------------------
def test_masked_fused_step_gradcheck():
    stencil = ltt.D2Q9()
    f, ncm, nsm, feq, table = bounded_case(stencil, (9, 7), 47, True)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64)
    params = dict(e=stencil.e, w=stencil.w, opposite=stencil.opposite,
                  cs=stencil.cs, tau_inv=TAU_INV, **masks)
    x = torch.as_tensor(f).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda y: fused_step(y, **params), (x,))


def test_masked_wrappers_run_plain_on_cpu_tensors():
    stencil = ltt.D3Q19()
    f, ncm, nsm, feq, table = bounded_case(stencil, (5, 6, 7), 48, True)
    f = torch.as_tensor(f)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64)
    args = kernel_args(stencil)
    counts = launch_counts("K1", "K3")
    want_f, want_u = sc.stream_collide_plain(f, *args, **masks, emit_u=True)
    out, u = torch.empty_like(f), torch.empty((3, 5, 6, 7),
                                              dtype=torch.float64)
    assert sc.stream_collide(f, *args, **masks, out=out, u_out=u) == (out, u)
    assert torch.equal(out, want_f) and torch.equal(u, want_u)
    g = torch.randn(f.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    want = ad.stream_collide_adjoint_plain(g, u, *args, **masks)
    assert torch.equal(ad.stream_collide_adjoint(g, u, *args, **masks), want)
    assert launch_counts("K1", "K3") == counts


def test_unknown_codes_are_identity():
    """A code outside the table keeps f, in the step and its adjoint, as
    the TPU kernel leaves an unclaimed code."""
    stencil = ltt.D2Q9()
    f, ncm, _, feq, table = bounded_case(stencil, (6, 8), 49, False)
    ncm[2, 3] = 7
    f = torch.as_tensor(f)
    masks = dict(ncm=torch.as_tensor(ncm), table=table,
                 feq_field=torch.as_tensor(feq))
    out = sc.stream_collide_plain(f, *kernel_args(stencil), **masks)
    pushed = {}
    for q, (ex, ey) in enumerate(stencil.e):
        pushed[q] = out[q, (2 + ex) % 6, (3 + ey) % 8]
    assert all(pushed[q] == f[q, 2, 3] for q in range(9))
    g = torch.randn(f.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    _, u = sc.stream_collide_plain(f, *kernel_args(stencil), **masks,
                                   emit_u=True)
    ct = ad.stream_collide_adjoint_plain(g, u, *kernel_args(stencil),
                                         **masks)
    for q, (ex, ey) in enumerate(stencil.e):
        assert ct[q, 2, 3] == g[q, (2 + ex) % 6, (3 + ey) % 8]


@pytest.mark.parametrize("change,match", [
    (lambda m: m.update(ncm=m["ncm"].to(torch.int32)), "ncm must be"),
    (lambda m: m.update(ncm=m["ncm"][:, :-1]), "ncm must be"),
    (lambda m: m.update(nsm=m["nsm"][:-1]), "nsm must be"),
    (lambda m: m.update(feq_field=None), "feq_field"),
    (lambda m: m.update(table=m["table"] * 2), "at most 8 codes"),
    (lambda m: m.update(table=m["table"][1:]), "code 0 'collide'"),
    (lambda m: m.update(table=m["table"][:4] + (("slip", None),)),
     "kinds must be"),
], ids=["ncm-dtype", "ncm-shape", "nsm-shape", "no-field", "long-table",
        "no-collide", "bad-kind"])
def test_check_masks_refuses(change, match):
    stencil = ltt.D2Q9()
    f, ncm, nsm, feq, table = bounded_case(stencil, (6, 8), 50, True)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64)
    change(masks)
    with pytest.raises(ValueError, match=match):
        sc.check_masks(torch.as_tensor(f), masks["ncm"], masks["nsm"],
                       masks["table"], masks["feq_field"])


def test_table_arrays():
    stencil = ltt.D2Q9()
    *_, table = bounded_case(stencil, (6, 8), 51, False)
    kinds, values = sc.table_arrays(table)
    assert kinds.dtype == np.int32 and values.shape == (sc.MAX_CODES, 27)
    assert kinds.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    np.testing.assert_array_equal(values[2, :9], 1.01 * stencil.w)
    assert not values[[0, 1, 3, 4]].any() and not values[2, 9:].any()


def test_checked_table_packs_once_and_checks_other_masks():
    """A table packed with its masks is reused for those very masks and a
    state like the one it was checked for; anything else is checked and
    packed anew."""
    stencil = ltt.D2Q9()
    f, ncm, nsm, feq, table = bounded_case(stencil, (6, 8), 52, True)
    f = torch.as_tensor(f)
    masks = torch_masks(ncm, nsm, feq, table, torch.float64)
    packed = sc.checked_table(f, **masks)
    assert isinstance(packed, sc.PackedTable) and packed == table
    kinds, values = sc.table_arrays(table)
    assert np.array_equal(packed.kinds, kinds)
    assert np.array_equal(packed.values, values)
    masks["table"] = packed
    assert sc.checked_table(f.clone(), **masks) is packed
    other = sc.checked_table(f, **dict(masks, ncm=masks["ncm"].clone()))
    assert other is not packed and other == table
    with pytest.raises(ValueError, match="ncm must be"):
        sc.checked_table(f[:, :, :-1].contiguous(), **masks)
    with pytest.raises(ValueError, match="feq_field"):
        sc.checked_table(f, **dict(masks, feq_field=None))
