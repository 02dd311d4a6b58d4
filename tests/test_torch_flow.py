"""lettuce_tpu_torch flows against lettuce_tpu on the CPU: the initial
state of TGV2D (with f_neq) and TGV3D, the observables on a seeded state,
and states carried across through the checkpoint pickle, 16-bit states
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
from tests.torch_helpers import (DTYPES, hand_state, noisy_state, tgv_pair,
                                 to_numpy)

CASES = [("D2Q9", [24, 20], True), ("D3Q19", [8, 10, 12], False)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name,resolution,fneq", CASES,
                         ids=["tgv2d-fneq", "tgv3d"])
def test_initial_state_matches(dtype_name, stencil_name, resolution, fneq):
    jflow, tflow = tgv_pair(dtype_name, resolution, stencil_name,
                            initialize_fneq=fneq)
    atol = DTYPES[dtype_name][2]
    assert tflow.f.dtype == DTYPES[dtype_name][1]
    assert tflow.f.is_contiguous()
    assert tuple(tflow.f.shape) == tuple(jflow.f.shape)
    np.testing.assert_allclose(to_numpy(tflow.f), to_numpy(jflow.f),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("stencil_name,resolution,fneq", CASES,
                         ids=["tgv2d", "tgv3d"])
def test_observables_match(stencil_name, resolution, fneq):
    jflow, tflow = tgv_pair("float64", resolution, stencil_name,
                            initialize_fneq=fneq)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=3))
    for name in ("rho", "j", "u", "incompressible_energy"):
        np.testing.assert_allclose(to_numpy(getattr(tflow, name)()),
                                   to_numpy(getattr(jflow, name)()),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in ("rho_pu", "p_pu", "u_pu", "velocity"):
        np.testing.assert_allclose(to_numpy(getattr(tflow, name)),
                                   to_numpy(getattr(jflow, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_analytic_solution_matches():
    jflow, tflow = tgv_pair("float64", [16, 12], "D2Q9",
                            initialize_fneq=False)
    for t in (0.0, 0.37):
        (jp, ju), (tp, tu) = (jflow.analytic_solution(t),
                              tflow.analytic_solution(t))
        np.testing.assert_allclose(to_numpy(tp), to_numpy(jp), atol=1e-12)
        np.testing.assert_allclose(to_numpy(tu), to_numpy(ju), atol=1e-12)


def test_gradient_matches():
    import lettuce_tpu as lt
    field = np.random.default_rng(5).standard_normal((12, 10))
    for order in (2, 4, 6):
        np.testing.assert_allclose(
            ltt.torch_gradient(torch.as_tensor(field), dx=0.5,
                               order=order).numpy(),
            np.asarray(lt.torch_gradient(field, dx=0.5, order=order)),
            atol=1e-12)
    with pytest.raises(ValueError):
        ltt.torch_gradient(torch.as_tensor(field), order=3)


def test_lettuce_tpu_dump_loads_into_port(tmp_path):
    jflow, tflow = tgv_pair("float64", [16, 12], "D2Q9",
                            initialize_fneq=False)
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=11))
    jflow.i = 42
    path = tmp_path / "state.pkl"
    jflow.dump(path)
    fresh = ltt.TaylorGreenVortex(tflow.context, [16, 12], 1600, 0.05,
                                  stencil=ltt.D2Q9())
    fresh.load(path)
    assert fresh.i == 42
    assert fresh.f.dtype == torch.float64
    np.testing.assert_array_equal(to_numpy(fresh.f), to_numpy(jflow.f))


def test_port_dump_loads_into_lettuce_tpu(tmp_path):
    jflow, tflow = tgv_pair("float32", [8, 10, 12], "D3Q19")
    hand_state(jflow, tflow, noisy_state(jflow.f, seed=12))
    tflow.i = 7
    path = tmp_path / "state.pkl"
    tflow.dump(path)
    jflow.load(path)
    assert jflow.i == 7
    np.testing.assert_array_equal(to_numpy(jflow.f), to_numpy(tflow.f))


def test_state_from_numpy_checks_shape():
    _, tflow = tgv_pair("float32", [8, 10, 12], "D3Q19")
    with pytest.raises(ValueError):
        ltt.state_from_numpy(tflow, np.zeros((19, 8, 10, 13)))
    f = np.ones((19, 8, 10, 12))
    ltt.state_from_numpy(tflow, f, i=3)
    assert tflow.i == 3 and tflow.f.dtype == torch.float32
    assert tflow.f.device == tflow.context.device


def test_context_factories_and_conversion():
    ctx = ltt.Context(device="cpu", dtype=torch.float64)
    assert ctx.zero_tensor([2, 3]).dtype == torch.float64
    assert ctx.one_tensor([2], dtype=torch.float32).dtype == torch.float32
    assert tuple(ctx.empty_tensor([4, 1]).shape) == (4, 1)
    assert ctx.convert_to_tensor(np.zeros(3, dtype=bool)).dtype == torch.bool
    assert ctx.convert_to_tensor(np.arange(3)).dtype == torch.int64
    assert ctx.convert_to_tensor([0.5, 1.5]).dtype == torch.float64
    assert ctx.convert_to_tensor(np.ones(2, np.float32)).dtype \
        == torch.float64
    np.testing.assert_array_equal(
        ctx.convert_to_ndarray(torch.arange(3)), np.arange(3))
    with pytest.raises(ValueError):
        ltt.Context(device="cpu", dtype=torch.int32)
    with pytest.raises(ValueError):
        ltt.Context(device="meta")


# ----------------------------------------------------------------------
# 16-bit state reaches the host (F6)
# ----------------------------------------------------------------------
HALF = {"bfloat16": (torch.bfloat16, "bfloat16"),
        "float16": (torch.float16, "float16")}


@pytest.mark.parametrize("name", sorted(HALF))
def test_16_bit_dump_load_round_trip(name, tmp_path):
    """A 16-bit state dumps as float32 (numpy has no bfloat16) and loads
    back bitwise, into the flow's dtype."""
    dtype = HALF[name][0]
    ctx = ltt.Context(device="cpu", dtype=dtype)
    flow = ltt.TaylorGreenVortex(ctx, [16, 12], 1600, 0.05,
                                 stencil=ltt.D2Q9())
    flow.i = 5
    host = ctx.convert_to_ndarray(flow.f)
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, flow.f.float().numpy())
    path = tmp_path / "state.pkl"
    flow.dump(path)
    fresh = ltt.TaylorGreenVortex(ctx, [16, 12], 1600, 0.05,
                                  stencil=ltt.D2Q9())
    fresh.f = torch.zeros_like(fresh.f)
    fresh.load(path)
    assert fresh.i == 5 and fresh.f.dtype == dtype
    assert torch.equal(fresh.f, flow.f)


@pytest.mark.parametrize("target", [torch.bfloat16, torch.float32],
                         ids=["into-bfloat16", "into-float32"])
def test_lettuce_tpu_bf16_pickle_loads_into_port(target, tmp_path):
    """lettuce_tpu's own bfloat16 pickle holds an ml_dtypes array: the
    port reads it through float32 (exact) into either context."""
    jctx = lt.Context(dtype=jnp.bfloat16, use_native=False)
    jflow = lt.TaylorGreenVortex(jctx, [16, 12], 1600, 0.05,
                                 stencil=lt.D2Q9())
    jflow.i = 9
    path = tmp_path / "state.pkl"
    jflow.dump(path)
    ctx = ltt.Context(device="cpu", dtype=target)
    flow = ltt.TaylorGreenVortex(ctx, [16, 12], 1600, 0.05,
                                 stencil=ltt.D2Q9())
    flow.load(path)
    assert flow.i == 9 and flow.f.dtype == target
    np.testing.assert_array_equal(flow.f.float().numpy(),
                                  np.asarray(jflow.f, dtype=np.float32))
