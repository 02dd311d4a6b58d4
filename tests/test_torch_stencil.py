"""lettuce_tpu_torch stencils: the tables equal lettuce_tpu's, and the
invariants of tests/test_stencil.py hold."""

import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt

NAMES = ["D1Q3", "D2Q9", "D3Q15", "D3Q19", "D3Q27"]


@pytest.fixture(params=NAMES)
def pair(request):
    return getattr(lt, request.param)(), getattr(ltt, request.param)()


def test_tables_equal_lettuce_tpu(pair):
    jax_stencil, torch_stencil = pair
    assert np.array_equal(torch_stencil.e, jax_stencil.e)
    assert torch_stencil.e.dtype == np.int64
    assert np.array_equal(torch_stencil.w, jax_stencil.w)
    assert np.array_equal(torch_stencil.opposite, jax_stencil.opposite)
    assert torch_stencil.cs == jax_stencil.cs
    assert (torch_stencil.d, torch_stencil.q) == (jax_stencil.d,
                                                  jax_stencil.q)


def test_invariants(pair):
    _, stencil = pair
    e = np.asarray(stencil.e, dtype=float)
    w = np.asarray(stencil.w)
    assert np.isclose(np.sum(w), 1.0)
    assert np.array_equal(stencil.e[stencil.opposite], -stencil.e)
    assert np.all(stencil.e[0] == 0)
    assert np.allclose(w @ e, 0.0)
    second = np.einsum("q,qa,qb->ab", w, e, e)
    assert np.allclose(second, stencil.cs ** 2 * np.eye(stencil.d),
                       atol=1e-12)
    # the kernel's opposite-pair cache relies on symmetric weights
    assert np.array_equal(w, w[stencil.opposite])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_stencil_mirror(pair, dtype):
    _, stencil = pair
    ts = ltt.TorchStencil(stencil, ltt.Context(device="cpu", dtype=dtype))
    assert ts.e.dtype == dtype and ts.w.dtype == dtype
    assert ts.e.device.type == "cpu"
    assert np.array_equal(ts.e.numpy(), stencil.e)
    assert np.allclose(ts.w.numpy(), stencil.w)
    assert np.array_equal(ts.opposite.numpy(), stencil.opposite)
    assert ts.d == stencil.d and ts.q == stencil.q
