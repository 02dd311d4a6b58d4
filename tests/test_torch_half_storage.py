"""Deviation storage (K1e) of lettuce_tpu_torch's kernel on the CPU: the
plain step on bfloat16 deviations g = f - w_q (``stream_collide_plain``
with ``dev_storage``) against lettuce_tpu's Pallas kernel in interpret mode
(``fused_stream_collide(..., dev_storage=True, interpret=True)``), one
case per fragment kind, periodic, and the masked path with the bounded
codes, over 1 and 3 steps.

Tolerance: every entry within one bfloat16 ulp of the larger of the two
magnitudes, plus the float32 roundoff of a rebuilt population
(``DEV_FLOOR``): the TPU kernel shifts each fragment's base term and keeps
a deviation's roundoff relative to the deviation, the port rebuilds
f = g + w_q in float32. The fraction of entries that differ at all is
asserted small. The CUDA kernels run only on a card; ``chip_smoke.py``
(phase 22) holds them against these plain versions there."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu.ops.pallas.stream_collide import fused_stream_collide
from tests.test_torch_bounded_kernel import JAX_KINDS, bounded_case

# the mantissa bits of each 16-bit storage type, and float16's least
# subnormal
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}
F16_TINY = 2.0 ** -24
# deviation storage rebuilds each population as g + w_q in float32 before
# the collision, so an entry's roundoff is that of f (populations below 1:
# a few float32 ulps of 2^-24 at most), not that of the deviation; near a
# deviation's zero crossing that is more than a bf16 ulp of the deviation
DEV_FLOOR = 2.0 ** -23


def storage_ulp(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """One ulp of the 16-bit ``dtype`` at the magnitudes ``x``."""
    x = np.maximum(np.abs(np.asarray(x, dtype=np.float64)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(x)) - MANTISSA_BITS[dtype])
    return np.maximum(ulp, F16_TINY) if dtype == torch.float16 else ulp


def assert_within_storage_ulp(got, want, dtype: torch.dtype,
                              floor: float = 0.0) -> float:
    """Every entry of ``got`` within one ``dtype`` ulp of the larger of its
    own and ``want``'s magnitude (plus ``floor``); returns the fraction of
    entries that differ at all."""
    a, b = (x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float64) for x in (got, want))
    assert a.shape == b.shape and np.all(np.isfinite(a))
    err = np.abs(a - b)
    bound = storage_ulp(np.maximum(np.abs(a), np.abs(b)), dtype) + floor
    worst = float(np.max(err / bound))
    differ = float(np.mean(err > 0))
    assert worst <= 1.0, (f"{np.sum(err > bound)} entries beyond one "
                          f"{dtype} ulp (+ {floor:.1e}): worst {worst:.2f} "
                          f"of the bound, max |diff| {err.max():.3e}")
    return differ


D2 = ("D2Q9", [16, 128])
# a raw 3D Pallas call in 16 bits needs y in multiples of its 16-row halo
D3 = ("D3Q19", [16, 16, 128])
TAU = 0.8
# fragment kind -> (grid, collision factory)
FRAGMENTS = {
    "bgk": (D2, lambda flow: ltt.BGKCollision(TAU)),
    "bgk_force": (D2, lambda flow: ltt.BGKCollision(
        TAU, force=ltt.Guo(flow, TAU, [1e-4, 0.0]))),
    "trt": (D2, lambda flow: ltt.TRTCollision(TAU, 1.1)),
    "none": (D2, lambda flow: ltt.NoCollision()),
    "kbc": (D2, lambda flow: ltt.KBCCollision(TAU)),
    "reg": (D2, lambda flow: ltt.RegularizedCollision(TAU)),
    "smag": (D2, lambda flow: ltt.SmagorinskyCollision(TAU)),
    "mrt_from_feq": (D3, lambda flow: ltt.MRTCollision(
        ltt.D3Q19DHumieres(flow.stencil, flow.context),
        [1.0] * 3 + [1.1, 1.2] * 8, flow.context)),
}
# at most this share of entries may differ at all (measured: under 2 %)
MAX_DIFFER = 0.05


def tgv_case(stencil_name, grid, make, seed):
    """(stencil, packed spec, float32 numpy state): the TGV at Re 100,
    Ma 0.05 plus seeded noise of 1e-4."""
    ctx = ltt.Context(device="cpu", dtype=torch.float32, use_native=False)
    flow = ltt.TaylorGreenVortex(ctx, grid, 100, 0.05,
                                 stencil=getattr(ltt, stencil_name)(),
                                 initialize_fneq=False)
    f = flow.f.numpy() + 1e-4 * np.random.default_rng(seed).standard_normal(
        tuple(flow.f.shape))
    spec, reason = sc.collision_spec_of(
        ltt.Simulation(flow, make(flow), []))
    assert reason is None
    st = flow.stencil
    return st, sc.pack_spec(spec, st.e, st.w, st.opposite), f


def kernel_args(st, spec):
    tau_inv = spec[1] if spec[0] == "bgk" else None
    return (np.asarray(st.e), np.asarray(st.w), np.asarray(st.opposite),
            float(st.cs), tau_inv)


def run_both(st, spec, f, steps, jax_masks=None, torch_masks=None):
    """[(pallas g, plain g)] for each of ``steps`` steps along the Pallas
    trajectory from ``f`` (float32, encoded by each package): each step
    starts both from the Pallas state, since a one-ulp rounding difference
    would carry into the next step's input."""
    f = np.asarray(f, dtype=np.float32)
    w = np.asarray(st.w, dtype=np.float32).reshape((-1,) + (1,) * st.d)
    want = (jnp.asarray(f) - jnp.asarray(w)).astype(jnp.bfloat16)
    got = sc.encode_deviations(torch.as_tensor(f), st.w)
    np.testing.assert_array_equal(np.asarray(want, dtype=np.float32),
                                  got.float().numpy())
    out = []
    for _ in range(steps):
        got = sc.stream_collide_plain(
            torch.as_tensor(np.asarray(want, dtype=np.float32)).to(
                torch.bfloat16), *kernel_args(st, spec), collision_spec=spec,
            dev_storage=True, **(torch_masks or {}))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = fused_stream_collide(
                want, *kernel_args(st, spec), collision_spec=tuple(spec),
                dev_storage=True, interpret=True, **(jax_masks or {}))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        out.append((want, got))
    return out


@pytest.mark.parametrize("fragment", sorted(FRAGMENTS))
def test_plain_dev_step_matches_pallas(fragment):
    (stencil_name, grid), make = FRAGMENTS[fragment]
    st, spec, f = tgv_case(stencil_name, grid, make, seed=31)
    for steps, (want, got) in zip((1, 2, 3), run_both(st, spec, f, 3)):
        if steps == 2:
            continue
        differ = assert_within_storage_ulp(got, want, torch.bfloat16,
                                           floor=DEV_FLOOR)
        assert differ <= MAX_DIFFER, (fragment, steps, differ)


@pytest.mark.parametrize("stencil_name,grid", [D2, D3],
                         ids=["d2q9", "d3q19"])
def test_plain_dev_masked_step_matches_pallas(stencil_name, grid):
    """BGK with the bounded codes (bounce back, a constant equilibrium, a
    per-node field, an identity plane) and frozen planes: the table stays
    in f, the field is encoded like the state."""
    st = getattr(ltt, stencil_name)()
    f, ncm, nsm, feq, table = bounded_case(st, tuple(grid), 43, True)
    spec = sc.pack_spec(("bgk", 1.0 / 0.6), st.e, st.w, st.opposite)
    jax_masks = dict(no_collision_mask=jnp.asarray(ncm),
                     no_streaming_mask=jnp.asarray(nsm),
                     boundary_kinds=JAX_KINDS,
                     feq_boundary=(None, table[2][1], None, None),
                     feq_field=jnp.asarray(feq, dtype=jnp.float32))
    torch_masks = dict(ncm=torch.as_tensor(ncm), nsm=torch.as_tensor(nsm),
                       table=table, feq_field=sc.encode_deviations(
                           torch.as_tensor(feq, dtype=torch.float32), st.w))
    for steps, (want, got) in zip((1, 2, 3), run_both(
            st, spec, f, 3, jax_masks, torch_masks)):
        if steps == 2:
            continue
        differ = assert_within_storage_ulp(got, want, torch.bfloat16,
                                           floor=DEV_FLOOR)
        assert differ <= MAX_DIFFER, (stencil_name, steps, differ)


def test_codec_round_trip():
    """decode(encode(f)) is f to half a bfloat16 ulp of each deviation, in
    the state's dtype; a float64 state decodes in float64."""
    st = ltt.D2Q9()
    w = st.w.reshape((-1, 1, 1))
    f = w * (1 + 0.02 * np.random.default_rng(5).standard_normal((9, 6, 7)))
    # the float32 sums round to a float32 ulp of f (2^-25 at w_q < 1/2)
    for dtype, floor in ((torch.float32, 2.0 ** -24),
                         (torch.float64, 1e-15)):
        x = torch.as_tensor(f, dtype=dtype)
        g = sc.encode_deviations(x, st.w)
        assert g.dtype == torch.bfloat16
        back = sc.decode_deviations(g, st.w, dtype)
        assert back.dtype == dtype
        dev = np.abs(f - w)
        np.testing.assert_array_less(
            np.abs(back.double().numpy() - x.double().numpy()),
            dev * 2.0 ** -8 + floor)
