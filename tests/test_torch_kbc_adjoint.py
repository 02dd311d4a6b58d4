"""KBC's adjoint kernel (K3 kbc: csrc/adjoint_fragments.cu ``KbcAdjoint``)
and its plain version (``adjoint._kbc_transpose``).

On the CPU, in float64: the hand-derived reverse against autograd through
split mode's route (the ``none`` adjoint's pull, then ``prestream_plain``),
periodic and masked, with cells where the stabiliser's guard fires (an
exact equilibrium, 0/0; gamma below 1e-15); and the gradient's route by
collision spec: KBC in full mode through its adjoint, forced BGK and a
closed-form MRT basis in split mode through the pointwise VJP.

On a card (marked ``card``; skipped without one): the kernel against its
plain version on D3Q27 128^3 periodic and D2Q9 2048x1024 masked, in
float64, float32, bfloat16 and float16, and the launches a rollout's
gradient counts. This file imports no JAX, so the card tests run where
JAX is absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_kbc_adjoint.py
"""

import math

import numpy as np
import pytest
import torch

import lettuce_tpu_torch as ltt
import lettuce_tpu_torch.ops.cuda.adjoint as ad
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
from lettuce_tpu_torch import tracing
from lettuce_tpu_torch.ops.collision import kbc_parts
from lettuce_tpu_torch.ops.equilibrium import quadratic_feq

TAU = 0.50693  # the benchmark cell's, where KBC is meant to run
GUARD_CELLS = 4  # of each kind: exact equilibrium, gamma below 1e-15


def args_of(stencil):
    return (stencil.e, stencil.w, stencil.opposite, stencil.cs, None)


def kbc_spec(stencil, tau=TAU):
    return sc.pack_spec(("kbc", tau), stencil.e, stencil.w,
                        stencil.opposite)


def equilibrium_of(f, stencil):
    """The plain step's equilibrium of ``f`` (``collide_plain``'s)."""
    et = torch.as_tensor(stencil.e, dtype=f.dtype)
    rho = torch.sum(f, dim=0, keepdim=True)
    return quadratic_feq(et, torch.as_tensor(stencil.w, dtype=f.dtype),
                         stencil.cs, rho, sc._velocity(f, et, rho,
                                                       stencil.e))


def noisy_state(stencil, shape, seed, noise=1e-2):
    """The equilibrium of a seeded density (1 + 5e-2 N) and velocity (5e-2
    N), each population scaled by 1 + ``noise`` N, float64."""
    rng = np.random.default_rng(seed)
    rho = torch.as_tensor(1 + 5e-2 * rng.standard_normal((1, *shape)))
    u = torch.as_tensor(5e-2 * rng.standard_normal((stencil.d, *shape)))
    et = torch.as_tensor(stencil.e, dtype=torch.float64)
    feq = quadratic_feq(et, torch.as_tensor(stencil.w), stencil.cs, rho, u)
    return feq * (1 + noise * torch.as_tensor(
        rng.standard_normal(tuple(feq.shape))))


def stabiliser_sensitive(stencil, seed):
    """``GUARD_CELLS`` populations at rest whose gamma is negative: f =
    feq + ds + eps P(ds) with ds a pure shear part (KBC's tracers of a
    random second moment) and P the projection onto the moment-free
    populations in the 1/w metric, so that dh = eps P(ds) and
    sum(ds dh / feq) / sum(dh^2 / feq) = 1 / eps."""
    rng = np.random.default_rng(seed)
    e = np.asarray(stencil.e, dtype=np.float64)
    w = np.asarray(stencil.w, dtype=np.float64)
    d = e.shape[1]
    basis = np.stack([np.ones(len(w))] + [e[:, a] for a in range(d)]
                     + [e[:, a] * e[:, b] for a in range(d)
                        for b in range(a, d)], axis=1)
    proj = np.eye(len(w)) - (w[:, None] * basis) @ np.linalg.solve(
        basis.T @ (w[:, None] * basis), basis.T)
    cells = []
    for _ in range(GUARD_CELLS):
        qm = rng.standard_normal((d, d)) * 2e-3
        ds = ad._kbc_shear_map(e).reshape(len(w), -1) @ (qm + qm.T).ravel()
        cells.append(w + ds + 0.05 * proj @ ds)
    return torch.as_tensor(np.stack(cells, axis=1))


def with_guard_cells(f, stencil, seed):
    """``f`` with ``GUARD_CELLS`` cells (in memory order, from a quarter of
    the grid on, away from :func:`masked_case`'s boundary codes) set to an
    exact equilibrium, a fixed point of the plain step's equilibrium (so
    dh is exactly 0 there), and the next ``GUARD_CELLS`` to
    :func:`stabiliser_sensitive` cells; and the flat indices of each."""
    f = f.clone()
    flat = f.reshape(f.shape[0], -1)
    start = flat.shape[1] // 4 + 3
    eq = torch.arange(start, start + GUARD_CELLS)
    neg = torch.arange(start + GUARD_CELLS, start + 2 * GUARD_CELLS)
    flat[:, neg] = stabiliser_sensitive(stencil, seed)
    flat[:, eq] = torch.as_tensor(np.asarray(stencil.w))[:, None] * (
        1 + 1e-2 * torch.arange(GUARD_CELLS, dtype=f.dtype))
    for _ in range(10):
        flat[:, eq] = equilibrium_of(f, stencil).reshape(flat.shape)[:, eq]
    return f, eq, neg


def masked_case(stencil, shape, seed):
    """The masks of a bounded grid: codes 1 bounce back (a disc), 2 a
    constant equilibrium (plane x = 0), 3 a per-node equilibrium field
    (plane y = 0), 4 identity (plane x = -1); every population frozen on
    the plane x = n0 // 2, the odd ones on y = 1."""
    rng = np.random.default_rng(seed)
    q = len(stencil.w)
    w = np.asarray(stencil.w).reshape((-1,) + (1,) * len(shape))
    ncm = np.zeros(shape, np.uint8)
    grid = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    ncm[sum((x - n / 2) ** 2 for x, n in zip(grid, shape))
        < (min(shape) / 5) ** 2] = 1
    ncm[0] = 2
    ncm[:, 0] = 3
    ncm[-1] = 4
    nsm = np.zeros((q, *shape), bool)
    nsm[:, shape[0] // 2] = True
    nsm[1::2, :, 1] = True
    table = (("collide", None), ("bounce_back", None),
             ("equilibrium_pu", tuple(1.01 * np.asarray(stencil.w))),
             ("equilibrium_pu_field", None), ("identity", None))
    feq = w * (1 + rng.uniform(-0.05, 0.05, (q, *shape)))
    return dict(ncm=torch.as_tensor(ncm), nsm=torch.as_tensor(nsm),
                table=table, feq_field=torch.as_tensor(feq))


def autograd_route(g, f, stencil, spec, masks):
    """Split mode's route: the ``none`` adjoint's pull (with the frozen
    re-route), then autograd through the plain pre-streaming map."""
    h = ad._pull(g, np.asarray(stencil.e), masks.get("nsm"))
    x = f.clone().requires_grad_(True)
    post = sc.prestream_plain(x, spec, *args_of(stencil)[:4],
                              masks.get("ncm"), masks.get("table"),
                              masks.get("feq_field"))
    (ct,) = torch.autograd.grad(post, x, h)
    return ct


def scaled_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


# ----------------------------------------------------------------------
# the derivation, on the CPU
# ----------------------------------------------------------------------
DERIVATION_CASES = {
    "d2q9-periodic": ("D2Q9", (24, 40), False),
    "d3q27-periodic": ("D3Q27", (6, 8, 10), False),
    "d2q9-masked": ("D2Q9", (24, 40), True),
}


@pytest.mark.parametrize("case", sorted(DERIVATION_CASES))
def test_plain_reverse_equals_autograd_through_the_split_route(case):
    """The plain reverse against autograd through the pull and
    ``prestream_plain``, to 1e-12 of the largest magnitude in float64
    (about 1e-15 measured: both recompute the forward with the plain
    step's code). The guard cells are where a subgradient is chosen:
    both give the gradient of gamma = 2 there."""
    stencil_name, shape, masked = DERIVATION_CASES[case]
    stencil = getattr(ltt, stencil_name)()
    spec = kbc_spec(stencil)
    assert (spec.adjoint[0], spec.mode, spec.residual) == ("kbc", "full",
                                                           "f")
    f, eq, neg = with_guard_cells(noisy_state(stencil, shape, 81), stencil,
                                  82)
    masks = masked_case(stencil, shape, 83) if masked else {}
    if masked:  # the guard cells lie on collide cells
        assert not masks["ncm"].reshape(-1)[torch.cat([eq, neg])].any()
    _, _, _, _, sum_h, _, guarded = kbc_parts(
        f, equilibrium_of(f, stencil), stencil.e, TAU)
    sum_h, guarded = sum_h.reshape(-1), guarded.reshape(-1)
    assert bool((sum_h[eq] == 0).all() and guarded[eq].all())
    assert bool((sum_h[neg] > 0).all() and guarded[neg].all())
    g = torch.as_tensor(np.random.default_rng(84).standard_normal(
        tuple(f.shape)))
    got = ad.stream_collide_adjoint_plain(g, f, *args_of(stencil),
                                          collision_spec=spec, **masks)
    want = autograd_route(g, f, stencil, spec, masks)
    assert bool(torch.isfinite(got).all())
    assert scaled_gap(got, want) < 1e-12
    cells = torch.cat([eq, neg])
    flat_got = got.reshape(got.shape[0], -1)[:, cells]
    flat_want = want.reshape(want.shape[0], -1)[:, cells]
    assert float((flat_got - flat_want).abs().max()) \
        < 1e-12 * float(want.abs().max())


def test_the_shear_map_is_the_forwards_shear_part():
    """ds = K : Q, Q = sum e e f - rho u u - rho cs^2 I, is the shear part
    the plain step's KBC computes from raw moments, on both stencils."""
    for stencil in (ltt.D2Q9(), ltt.D3Q27()):
        f = noisy_state(stencil, (5, 7) if stencil.d == 2 else (3, 4, 5),
                        85)
        feq = equilibrium_of(f, stencil)
        _, ds, _, _, _, _, _ = kbc_parts(f, feq, stencil.e, TAU)
        et = torch.as_tensor(stencil.e, dtype=f.dtype)
        rho = f.sum(0)
        u = torch.tensordot(et.T, f, dims=1) / rho
        ee = et[:, :, None] * et[:, None, :]
        eye = torch.eye(stencil.d, dtype=f.dtype).reshape(
            (stencil.d, stencil.d) + (1,) * stencil.d)
        q_neq = (torch.tensordot(ee.permute(1, 2, 0), f, dims=1)
                 - rho * u[:, None] * u[None, :] - stencil.cs ** 2 * rho * eye)
        shear = torch.as_tensor(ad._kbc_shear_map(stencil.e))
        assert scaled_gap(torch.tensordot(shear, q_neq, dims=2), ds) < 1e-12


def test_blocked_adjoint_still_refuses_kbc():
    stencil = ltt.D3Q27()
    reason = ad.adjoint_multi_refusal(kbc_spec(stencil), torch.float32)
    assert reason is not None and "'kbc'" in reason


# ----------------------------------------------------------------------
# the route of each collision's gradient
# ----------------------------------------------------------------------
def split_or_kbc(name, flow):
    tau = flow.units.relaxation_parameter_lu
    if name == "kbc":
        return ltt.KBCCollision(tau)
    if name == "bgk_force":
        return ltt.BGKCollision(tau, force=ltt.Guo(
            flow, tau, [1e-5] + [0.0] * (flow.stencil.d - 1)))
    return ltt.MRTCollision(ltt.D2Q9Lallemand(flow.stencil, flow.context),
                            [1.1] * 9, flow.context)


ROUTES = {"kbc": "full", "bgk_force": "split", "mrt_lallemand": "split"}


def route_run(name, device, dtype, steps=4):
    """The counts and spans of one ``steps``-step segment's gradient of a
    D2Q9 Taylor-Green vortex with collision ``name`` on the kernel path,
    and the simulation."""
    ctx = ltt.Context(device=device, dtype=dtype, use_native=False)
    flow = ltt.TaylorGreenVortex(ctx, [32, 48], 1600, 0.05,
                                 stencil=ltt.D2Q9(), initialize_fneq=False)
    sim = ltt.Simulation(flow, split_or_kbc(name, flow), [])
    sim._use_kernel()
    f0 = (flow.f * (1 + 1e-2 * torch.rand(
        flow.f.shape, generator=torch.Generator().manual_seed(86),
        dtype=dtype).to(device))).requires_grad_(True)
    with tracing.recording() as record:
        (flow.view(sim.make_segment_fn(steps)(f0)).u() ** 2).sum().backward()
    assert bool(torch.isfinite(f0.grad).all())
    return record, sim


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_gradient_route_follows_the_collision_spec(name, monkeypatch):
    """KBC's backward is its adjoint (the plain reverse here, once a step)
    and no pointwise VJP; forced BGK and the Lallemand MRT basis keep
    split mode, one ``vjp`` span and ``vjp:<fragment>`` count a step."""
    calls = []
    transpose = ad._kbc_transpose

    def spy(*args, **kwargs):
        calls.append(1)
        return transpose(*args, **kwargs)

    monkeypatch.setattr(ad, "_kbc_transpose", spy)
    record, sim = route_run(name, "cpu", torch.float64)
    assert sim.adjoint_mode == ROUTES[name]
    vjps = {k: n for k, n in record.counts.items() if k.startswith("vjp:")}
    spans = [s[0] for s in record.spans if s[0] == "vjp"]
    if name == "kbc":
        assert len(calls) == 4 and not vjps and not spans
    else:
        assert not calls and vjps == {f"vjp:{name}": 4} and len(spans) == 4


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
# KBC's Jacobian is ill-conditioned where a cell's higher-order part nearly
# vanishes: the stabiliser's adjoint divides by S_h = sum dh^2 / feq, and
# dh = f - feq - ds cancels. Two correct computations at one precision
# then differ by that precision's roundoff times the worst cell's
# condition, which at 10^6 cells is far above a fixed fraction of the
# largest magnitude (the card, float32: 1e-3; float64: 3-7e-12). So the
# kernel is held to what its plain version reads: in float32 and at 16
# bits, its gap to the float64 plain from the same stored inputs within
# ROUNDOFF_RATIO of the plain's own (the kernel's measured 0.64-1.0 of
# it); in float64, its gap to the plain within FLOOR_RATIO of the
# plain's change under a one-ulp perturbation of its input f.
ROUNDOFF_RATIO = 2.0
FLOOR_RATIO = 8.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: KBC's adjoint kernel has no CPU "
                    "build (its plain version runs in the CPU tests)")
    return torch.device("cuda")


def card_case(name, device):
    """(stencil, state float64, masks) of a card case."""
    if name == "d3q27-128":
        stencil = ltt.D3Q27()
        ctx = ltt.Context(device=device, dtype=torch.float64,
                          use_native=False)
        flow = ltt.TaylorGreenVortex(ctx, [128] * 3, 1600, 0.05,
                                     stencil=stencil, initialize_fneq=False)
        noise = torch.rand(flow.f.shape, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(87))
        return stencil, flow.f * (1 + 2e-2 * (noise.to(device) - 0.5)), {}
    stencil = ltt.D2Q9()
    masks = masked_case(stencil, (2048, 1024), 88)
    f = noisy_state(stencil, (2048, 1024), 89)
    return stencil, f.to(device), {
        k: v.to(device) if isinstance(v, torch.Tensor) else v
        for k, v in masks.items()}


def kernel_gap(ct, g, f, stencil, spec, masks):
    """(the kernel's gap, its bar): see ROUNDOFF_RATIO."""
    args = args_of(stencil)
    plain = ad.stream_collide_adjoint_plain(g, f, *args, collision_spec=spec,
                                            **masks)
    if ct.dtype == torch.float64:
        sign = torch.randint(0, 2, tuple(f.shape), device=f.device,
                             generator=torch.Generator(f.device)
                             .manual_seed(90)).to(f.dtype) * 2 - 1
        moved = ad.stream_collide_adjoint_plain(
            g, f * (1 + torch.finfo(f.dtype).eps * sign), *args,
            collision_spec=spec, **masks)
        scale = float(plain.abs().max())
        floor = float((moved - plain).abs().max()) / scale
        return scaled_gap(ct, plain), max(1e-12, FLOOR_RATIO * floor)
    wide = {k: v.double() if k == "feq_field" else v
            for k, v in masks.items()}
    ref = ad.stream_collide_adjoint_plain(g.double(), f.double(), *args,
                                          collision_spec=spec, **wide)
    own = scaled_gap(plain.double(), ref)
    return scaled_gap(ct.double(), ref), max(1e-5, ROUNDOFF_RATIO * own)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16, torch.float16],
                         ids=["f64", "f32", "bf16", "f16"])
@pytest.mark.parametrize("case", ["d3q27-128", "d2q9-2048-masked"])
def test_kernel_equals_its_plain_version(card, case, dtype):
    stencil, f64, masks = card_case(case, card)
    spec = kbc_spec(stencil, TAU if stencil.d == 3 else 0.8)
    f = f64.to(dtype).contiguous()
    g = torch.randn(tuple(f.shape), dtype=torch.float64, device=card,
                    generator=torch.Generator(card).manual_seed(91)
                    ).to(dtype)
    masks = {k: v.to(dtype) if k == "feq_field" else v
             for k, v in masks.items()}
    variant = "masked_" if masks else ""
    key = tracing.launch_key("K3", variant, "kbc",
                             ad.storage_suffix(dtype))
    before = tracing.counts[key]
    ct = ad.stream_collide_adjoint(g, f, *args_of(stencil),
                                   collision_spec=spec, **masks)
    torch.cuda.synchronize()
    assert tracing.counts[key] - before == 1
    assert ct.dtype == dtype and bool(torch.isfinite(ct.float()).all())
    gap, bar = kernel_gap(ct, g, f, stencil, spec, masks)
    assert gap <= bar, (gap, bar)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_card_counts_the_route(card, name):
    """On the card KBC's segment counts ``K3:kbc_f32`` once a step, no
    ``vjp:`` and no ``none`` adjoint; the split-mode collisions count
    their ``vjp:<fragment>`` and the ``none`` adjoint once a step."""
    record, sim = route_run(name, "cuda", torch.float32)
    counts = {k: n for k, n in record.counts.items()
              if k.startswith(("vjp:", "K3:"))}
    if name == "kbc":
        assert counts == {"K3:kbc_f32": 4}
    else:
        assert counts == {f"vjp:{name}": 4, "K3:none_f32": 4}
    assert math.isfinite(sim.flow.f.float().sum().item())
