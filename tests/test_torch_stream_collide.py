"""The stream-collide module of lettuce_tpu_torch on the CPU: its plain
version against lettuce_tpu's Pallas kernel in interpret mode, and the
wrapper's routing, checks and build errors. The CUDA kernel itself runs
only on a card; ``chip_smoke.py`` holds it against the plain version
there."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.build as build
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from tests.torch_helpers import DTYPES, launch_counts

TAU_INV = 1.0 / 0.52


def random_state(stencil, shape, seed):
    """Populations near equilibrium at rest: w_q (1 + 10 % noise)."""
    noise = np.random.default_rng(seed).uniform(-0.1, 0.1,
                                                (stencil.q, *shape))
    return stencil.w.reshape((-1,) + (1,) * len(shape)) * (1 + noise)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("stencil_name,shape",
                         [("D3Q19", (8, 8, 128)), ("D2Q9", (16, 128))],
                         ids=["d3q19", "d2q9"])
def test_plain_matches_pallas_kernel(dtype_name, stencil_name, shape):
    jax_dtype, torch_dtype, atol = DTYPES[dtype_name]
    stencil = getattr(ltt, stencil_name)()
    f_np = random_state(stencil, shape, seed=1)
    args = (stencil.e, stencil.w, stencil.opposite, stencil.cs, TAU_INV)
    want = fused_stream_collide(jnp.asarray(f_np, dtype=jax_dtype), *args,
                                interpret=True)
    got = sc.stream_collide_plain(torch.as_tensor(f_np, dtype=torch_dtype),
                                  *args)
    assert got.dtype == torch_dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("stencil_name", ["D2Q9", "D3Q15", "D3Q19",
                                          "D3Q27"])
def test_plain_matches_jnp_step(stencil_name):
    """Every stencil with a compiled kernel instance, on a non-cubic grid
    with no 128-lane minor axis: the plain version equals lettuce_tpu's
    jnp step (BGK collision, then streaming)."""
    stencil = getattr(ltt, stencil_name)()
    shape = (6, 10) if stencil.d == 2 else (5, 6, 7)
    f_np = random_state(stencil, shape, seed=2)
    jflow = lt.TaylorGreenVortex(lt.Context(dtype=jnp.float64), list(shape),
                                 100, 0.05,
                                 stencil=getattr(lt, stencil_name)(),
                                 initialize_fneq=False)
    jflow.f = jnp.asarray(f_np)
    want = lt.stream(lt.BGKCollision(1.0 / TAU_INV)(jflow), stencil.e)
    got = sc.stream_collide_plain(torch.as_tensor(f_np), stencil.e,
                                  stencil.w, stencil.opposite, stencil.cs,
                                  TAU_INV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_wrapper_runs_plain_on_cpu_tensors():
    stencil = ltt.D3Q19()
    f = torch.as_tensor(random_state(stencil, (4, 5, 6), seed=3))
    args = (stencil.e, stencil.w, stencil.opposite, stencil.cs, TAU_INV)
    before = launch_counts("K1")
    want = sc.stream_collide_plain(f, *args)
    assert torch.equal(sc.stream_collide(f, *args), want)
    out = torch.empty_like(f)
    assert sc.stream_collide(f, *args, out=out) is out
    assert torch.equal(out, want)
    assert launch_counts("K1") == before  # no kernel launched


def test_wrapper_refuses_other_devices():
    stencil = ltt.D2Q9()
    f = torch.empty((9, 4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sc.stream_collide(f, stencil.e, stencil.w, stencil.opposite,
                          stencil.cs, TAU_INV)


def test_kernel_instances():
    for name in ("D2Q9", "D3Q15", "D3Q19", "D3Q27"):
        s = getattr(ltt, name)()
        assert sc.kernel_stencil_name(s.e, s.w, s.opposite) == name.lower()
    d1q3 = ltt.D1Q3()
    with pytest.raises(ValueError, match="no compiled"):
        sc.kernel_stencil_name(d1q3.e, d1q3.w, d1q3.opposite)
    s = ltt.D2Q9()
    with pytest.raises(ValueError, match="no compiled"):
        sc.kernel_stencil_name(s.e, s.w * 1.01, s.opposite)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: fake compiler' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler"):
        build.build_libraries()
    for name in build.SOURCES:
        assert not build.library_path(name).exists()
    assert os.listdir(tmp_path / "build") == []  # no half-written library


def test_plain_step_is_differentiable():
    stencil = ltt.D2Q9()
    f = torch.as_tensor(random_state(stencil, (6, 8), seed=4))
    f.requires_grad_(True)
    out = sc.stream_collide(f, stencil.e, stencil.w, stencil.opposite,
                            stencil.cs, TAU_INV)
    out.pow(2).sum().backward()
    assert f.grad is not None and bool(torch.isfinite(f.grad).all())
