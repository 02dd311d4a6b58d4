#!/usr/bin/env python3
"""Smoke test of lettuce_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``lettuce_tpu_torch/csrc`` (the fused
stream-collide step, its emit-u variant and its adjoint), checks each
against its plain PyTorch version, drives the main path (D3Q19 BGK
Taylor-Green 256^3, float32) through the kernel, runs the float64
convergence gate through the kernel, measures the card's practical
bandwidth, and drives the gradient of an 8-step rollout of the main path
and a few Adam iterations of an inverse-design loss through the emit-u
and adjoint kernels. Every failed check exits non-zero; nothing is caught.

Phases:
  0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  1. build the kernel libraries, one nvcc per source, all at once (seconds
     printed);
  2. kernel vs plain on the card: D2Q9 64x96 and D3Q15/D3Q19/D3Q27
     30x34x36, float32 and float64, 1 and 4 steps, TGV state plus seeded
     noise; the launch count must advance by the step count;
  3. the main path: 20 warm-up and 200 timed steps, one launch per step,
     finite state, mass conserved; MLUPS of the kernel path and of the
     plain torch path at the same size; kernel vs plain at that size;
  4. the TGV2D convergence gate in float64 at 16..128 through
     ``lettuce_tpu_torch.cli``, in-process;
  5. saxpy over 1 GiB tensors: practical bandwidth, and the main path's
     share of it at 152 B per D3Q19 float32 lattice update;
  6. the emit-u and adjoint kernels vs plain at the grids of phase 2, on
     all eight instances; one launch of each per case;
  7. the gradient path at 256^3 float32: ``loss = (seg(f0) ** 2).sum()``
     through ``make_segment_fn(8)`` with 8 emit-u and 8 adjoint launches,
     finite and non-zero, against the plain closed-form chain (plain
     forward saving u, plain adjoint) to 1e-5 of its largest magnitude,
     bitwise equal to ``checkpoint_every=4``; a 1-step VJP against
     autograd of the plain step; fwd+bwd MLUPS; per-launch ms of both
     kernels and their plain versions by CUDA events, with GB/s and the
     share of the saxpy bandwidth at 164 B per update;
  8. 5 Adam iterations of example 09's inverse-design loss (rollout
     velocity against a target's) at 256^3 through an 8-step segment; the
     last loss must be below the first.

Prints, before the last line, one JSON line describing the kernels, and
last ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# kernel vs plain: float32 as tests/test_native.py holds the Pallas kernel
# to its jnp step; float64 differs only by the order of roundoff
ATOL = {torch.float32: 5e-6, torch.float64: 1e-12}
# gradients, scaled by the reference's largest magnitude: float32 as
# tests/test_adjoint.py holds the Pallas adjoint kernel to jax.vjp
GRAD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_SOURCE = "lettuce_tpu_torch/csrc/stream_collide.cu"
REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1402"
ADJOINT_SOURCE = "lettuce_tpu_torch/csrc/adjoint.cu"
ADJOINT_REPLACES = "lettuce_tpu/ops/pallas/adjoint.py:131"
BYTES_PER_UPDATE = 19 * 4 * 2  # D3Q19 float32: q populations in and out
# emit-u: q in, q + d out; adjoint: q + d in, q out
GRAD_BYTES_PER_UPDATE = (19 * 2 + 3) * 4
SEGMENT_STEPS = 8


def check(condition, message):
    if not condition:
        raise SystemExit(f"chip_smoke FAILED: {message}")


def cuda_ms(fn, repeats):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase0_card():
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    card = smi.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


def phase1_build():
    from lettuce_tpu_torch.ops.cuda import adjoint, build
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    cached = all(build.library_path(name).exists() for name in build.SOURCES)
    beg = time.perf_counter()
    paths = build.build_libraries()
    sc.load_library()
    adjoint.load_library()
    seconds = time.perf_counter() - beg
    print(f"phase 1: kernel libraries "
          f"{', '.join(path.name for path in paths.values())} "
          f"{'loaded from cache' if cached else 'built'} in {seconds:.2f} s")
    return seconds


def tgv_state(stencil, shape, dtype, seed):
    """TGV initial state on the card plus seeded numpy noise."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=dtype, use_native=False)
    flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                stencil=stencil, initialize_fneq=False)
    noise = 1e-3 * np.random.default_rng(seed).standard_normal(
        tuple(flow.f.shape))
    f = flow.f + torch.as_tensor(noise, dtype=dtype, device="cuda")
    return f.contiguous(), 1.0 / flow.units.relaxation_parameter_lu


def phase2_cases():
    import lettuce_tpu_torch as lt
    return [(lt.D2Q9(), (64, 96)), (lt.D3Q15(), (30, 34, 36)),
            (lt.D3Q19(), (30, 34, 36)), (lt.D3Q27(), (30, 34, 36))]


def phase2_kernel_vs_plain():
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    cases = phase2_cases()
    worst = 0.0
    seed = 0
    for stencil, shape in cases:
        for dtype in (torch.float32, torch.float64):
            for steps in (1, 4):
                seed += 1
                f, tau_inv = tgv_state(stencil, shape, dtype, seed)
                args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                        tau_inv)
                before = sc.stream_collide.launches
                got, ref = f, f
                for _ in range(steps):
                    got = sc.stream_collide(got, *args)
                    ref = sc.stream_collide_plain(ref, *args)
                torch.cuda.synchronize()
                launched = sc.stream_collide.launches - before
                err = (got - ref).abs().max().item()
                name = type(stencil).__name__
                print(f"phase 2: {name} {'x'.join(map(str, shape))} "
                      f"{str(dtype)[6:]} {steps} step(s): max |kernel - "
                      f"plain| = {err:.3e} (atol {ATOL[dtype]:.0e}), "
                      f"{launched} launch(es)")
                check(launched == steps, f"{name}: {launched} launches "
                                         f"for {steps} steps")
                check(bool(torch.isfinite(got).all()), f"{name}: not finite")
                check(err <= ATOL[dtype], f"{name} {dtype} {steps} steps: "
                                          f"max error {err}")
                worst = max(worst, err)
    return worst


def phase3_main_path(card):
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    resolution = 256
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=True)
    flow = lt.TaylorGreenVortex(context, resolution, 1600, 0.05,
                                stencil=lt.D3Q19(), initialize_fneq=False)
    simulation = lt.Simulation(
        flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu), [])
    check(simulation._step_kind == "cuda",
          f"main path runs {simulation._step_kind!r}, not the kernel")
    mass0 = torch.sum(flow.f, dtype=torch.float64).item()

    reset_launch_counts()
    simulation(20)
    mlups = simulation(200)
    launches, emit_u, adjoint_launches = launch_counts()

    check(launches == 220, f"{launches} kernel launches for 220 steps")
    check(emit_u == adjoint_launches == 0,
          "the forward path ran gradient kernels")
    check(tuple(flow.f.shape) == (19, resolution, resolution, resolution),
          f"state shape {tuple(flow.f.shape)}")
    check(bool(torch.isfinite(flow.f).all()), "state is not finite")
    mass1 = torch.sum(flow.f, dtype=torch.float64).item()
    drift = abs(mass1 - mass0) / mass0
    check(drift < 1e-5, f"mass drift {drift}")
    print(f"phase 3: D3Q19 BGK TGV {resolution}^3 float32, "
          f"{simulation.step_path} path: {mlups:.1f} MLUPS ({card}); "
          f"{launches} launches; mass drift {drift:.2e}")

    # kernel vs plain on the main path's own state and shape, and both
    # timed by CUDA events in turns: plain, kernel, kernel, plain
    f = flow.f
    params = dict(e=flow.stencil.e, w=flow.stencil.w,
                  opposite=flow.stencil.opposite, cs=flow.stencil.cs,
                  tau_inv=1.0 / simulation.collision.tau)
    del simulation
    ref = sc.stream_collide_plain(f, **params)
    got = sc.stream_collide(f, **params)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= ATOL[torch.float32], f"256^3 kernel vs plain: {err}")
    del ref
    buffers = [f, got]

    def kernel_step():
        sc.stream_collide(buffers[0], out=buffers[1], **params)
        buffers.reverse()

    def plain_step():
        sc.stream_collide_plain(f, **params)

    kernel_step()
    plain_step()
    plain_a = cuda_ms(plain_step, 5)
    kernel_a = cuda_ms(kernel_step, 50)
    kernel_b = cuda_ms(kernel_step, 50)
    plain_b = cuda_ms(plain_step, 5)
    kernel_ms = (kernel_a + kernel_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    cells = resolution ** 3
    print(f"phase 3: per step, CUDA events: kernel {kernel_a:.4f} / "
          f"{kernel_b:.4f} ms ({cells / kernel_ms / 1e3:.1f} MLUPS), plain "
          f"{plain_a:.4f} / {plain_b:.4f} ms "
          f"({cells / plain_ms / 1e3:.1f} MLUPS); max |kernel - plain| "
          f"{err:.3e} ({card})")
    del buffers, got, f, flow
    torch.cuda.empty_cache()

    # the plain torch step through the same Simulation API
    plain_context = lt.Context(device="cuda", dtype=torch.float32,
                               use_native=False)
    plain_flow = lt.TaylorGreenVortex(plain_context, resolution, 1600, 0.05,
                                      stencil=lt.D3Q19(),
                                      initialize_fneq=False)
    plain_sim = lt.Simulation(
        plain_flow,
        lt.BGKCollision(tau=plain_flow.units.relaxation_parameter_lu), [])
    check(plain_sim._step_kind == "torch", "plain path did not select torch")
    plain_sim(3)
    plain_mlups = plain_sim(20)
    check(bool(torch.isfinite(plain_flow.f).all()), "plain state not finite")
    print(f"phase 3: D3Q19 BGK TGV {resolution}^3 float32, "
          f"{plain_sim.step_path} path: {plain_mlups:.1f} MLUPS ({card})")
    del plain_sim, plain_flow
    torch.cuda.empty_cache()
    return dict(mlups=mlups, plain_mlups=plain_mlups, launches=launches,
                err=err, kernel_ms=kernel_ms, plain_ms=plain_ms)


def phase4_convergence():
    from lettuce_tpu_torch import cli
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    before = sc.stream_collide.launches
    rc = cli.main(["--device", "cuda", "-p", "double", "convergence",
                   "--max-resolution-exponent", "7"])
    launched = sc.stream_collide.launches - before
    expected = sum(10 * 2 ** e for e in range(4, 8))
    print(f"phase 4: convergence gate float64 16..128 exit {rc}, "
          f"{launched} kernel launches")
    check(rc == 0, "the convergence gate failed")
    check(launched == expected,
          f"convergence ran {launched} launches, expected {expected}")


def phase5_saxpy(mlups, card):
    n = (1 << 30) // 4  # 1 GiB of float32 per tensor
    x = torch.full((n,), 1.0, device="cuda")
    y = torch.full((n,), 1.0, device="cuda")

    def saxpy():
        y.add_(x, alpha=0.5)

    saxpy()
    ms = cuda_ms(saxpy, 20)
    gbps = 3 * (1 << 30) / (ms * 1e-3) / 1e9  # read x, read y, write y
    share = mlups * 1e6 * BYTES_PER_UPDATE / (gbps * 1e9)
    print(f"phase 5: saxpy 1 GiB: {gbps:.1f} GB/s ({card}); main path "
          f"{mlups:.1f} MLUPS x {BYTES_PER_UPDATE} B = "
          f"{mlups * BYTES_PER_UPDATE / 1e3:.1f} GB/s, {share:.1%} of it")
    del x, y
    torch.cuda.empty_cache()
    return gbps


def launch_counts():
    """(primal, emit-u, adjoint) kernel launch counts."""
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    return (sc.stream_collide.launches, sc.stream_collide.emit_u_launches,
            adjoint.stream_collide_adjoint.launches)


def reset_launch_counts():
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    sc.stream_collide.launches = 0
    sc.stream_collide.emit_u_launches = 0
    adjoint.stream_collide_adjoint.launches = 0


def scaled_err(got, want):
    """(max |got - want|, max |want|)."""
    return ((got - want).abs().max().item(), want.abs().max().item())


def phase6_gradient_kernels_vs_plain():
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst_emit = worst_adjoint = 0.0
    seed = 100
    for stencil, shape in phase2_cases():
        for dtype in (torch.float32, torch.float64):
            seed += 1
            f, tau_inv = tgv_state(stencil, shape, dtype, seed)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    tau_inv)
            g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                tuple(f.shape)), dtype=dtype, device="cuda")
            before = launch_counts()
            u = torch.empty((stencil.d, *shape), dtype=dtype, device="cuda")
            got, _ = sc.stream_collide(f, *args, u_out=u)
            ct = adjoint.stream_collide_adjoint(g, u, *args)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(launch_counts(), before))
            ref, u_ref = sc.stream_collide_plain(f, *args, emit_u=True)
            ct_ref = adjoint.stream_collide_adjoint_plain(g, u, *args)
            err_f = (got - ref).abs().max().item()
            err_u = (u - u_ref).abs().max().item()
            err_ct, scale = scaled_err(ct, ct_ref)
            name = type(stencil).__name__
            print(f"phase 6: {name} {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]}: emit-u max |kernel - plain| state "
                  f"{err_f:.3e}, u {err_u:.3e} (atol {ATOL[dtype]:.0e}); "
                  f"adjoint {err_ct:.3e} of {scale:.3e} (rtol "
                  f"{GRAD_RTOL[dtype]:.0e}); launches {launched}")
            check(launched == (0, 1, 1), f"{name}: launches {launched}")
            check(bool(torch.isfinite(got).all() and torch.isfinite(u).all()
                       and torch.isfinite(ct).all()), f"{name}: not finite")
            check(max(err_f, err_u) <= ATOL[dtype],
                  f"{name} {dtype}: emit-u error {err_f}, {err_u}")
            check(err_ct <= GRAD_RTOL[dtype] * scale,
                  f"{name} {dtype}: adjoint error {err_ct} of {scale}")
            worst_emit = max(worst_emit, err_f, err_u)
            worst_adjoint = max(worst_adjoint, err_ct)
    return worst_emit, worst_adjoint


def tgv256_simulation():
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=True)
    flow = lt.TaylorGreenVortex(context, 256, 1600, 0.05,
                                stencil=lt.D3Q19(), initialize_fneq=False)
    simulation = lt.Simulation(
        flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu), [])
    check(simulation._step_kind == "cuda",
          f"gradient path runs {simulation._step_kind!r}, not the kernels")
    return simulation


def phase7_gradient_path(card, saxpy_gbps):
    from lettuce_tpu_torch.ops.cuda import adjoint
    from lettuce_tpu_torch.ops.cuda.fused_step import fused_step
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    simulation = tgv256_simulation()
    params = simulation._kernel_params
    f0 = simulation.flow.f.detach().clone().requires_grad_(True)
    cells = f0[0].numel()
    segment = simulation.make_segment_fn(SEGMENT_STEPS)

    def grad_of(seg):
        (grad,) = torch.autograd.grad((seg(f0) ** 2).sum(), f0)
        return grad

    reset_launch_counts()
    grad = grad_of(segment)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == (0, SEGMENT_STEPS, SEGMENT_STEPS),
          f"(primal, emit-u, adjoint) launches {launches} for a "
          f"{SEGMENT_STEPS}-step gradient")
    check(bool(torch.isfinite(grad).all()), "gradient not finite")
    check(grad.abs().max().item() > 0, "gradient is zero")

    # the plain closed-form chain: plain forward saving u, plain adjoint
    with torch.no_grad():
        x = f0.detach()
        us = []
        for _ in range(SEGMENT_STEPS):
            x, u = sc.stream_collide_plain(x, **params, emit_u=True)
            us.append(u)
        ref = 2 * x
        del x
        for u in reversed(us):
            ref = adjoint.stream_collide_adjoint_plain(ref, u, **params)
        del us, u
    err, scale = scaled_err(grad, ref)
    del ref
    print(f"phase 7: {SEGMENT_STEPS}-step gradient at 256^3 float32: "
          f"launches (primal, emit-u, adjoint) {launches}; max |kernel - "
          f"plain chain| {err:.3e} of {scale:.3e} "
          f"({err / scale:.2e} relative, rtol 1e-5)")
    check(err <= GRAD_RTOL[torch.float32] * scale,
          f"gradient vs plain chain: {err} of {scale}")

    grad_ck = grad_of(simulation.make_segment_fn(SEGMENT_STEPS,
                                                 checkpoint_every=4))
    torch.cuda.synchronize()
    check(torch.equal(grad, grad_ck),
          "checkpoint_every=4 gradient differs from the plain segment's")
    print("phase 7: checkpoint_every=4 gradient is bitwise equal")
    del grad_ck

    # one step: the kernels' VJP against autograd of the plain step
    gen = torch.Generator(device="cuda").manual_seed(7)
    g1 = torch.randn(f0.shape, generator=gen, device="cuda")
    x = f0.detach().requires_grad_(True)
    (vjp_kernel,) = torch.autograd.grad(fused_step(x, **params), x, g1)
    (vjp_plain,) = torch.autograd.grad(sc.stream_collide_plain(x, **params),
                                       x, g1)
    err1, scale1 = scaled_err(vjp_kernel, vjp_plain)
    print(f"phase 7: 1-step VJP vs autograd of the plain step: "
          f"{err1:.3e} of {scale1:.3e}")
    check(err1 <= GRAD_RTOL[torch.float32] * scale1,
          f"1-step VJP: {err1} of {scale1}")
    del x, vjp_kernel, vjp_plain
    torch.cuda.empty_cache()

    # fwd+bwd MLUPS, as benchmarks/bench_adjoint.py measures it
    grad_of(segment)
    torch.cuda.synchronize()
    repeats = 3
    beg = time.perf_counter()
    for _ in range(repeats):
        grad = grad_of(segment)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / repeats
    mlups = cells * SEGMENT_STEPS / seconds / 1e6
    print(f"phase 7: fwd+bwd {mlups:.1f} MLUPS ({seconds * 1e3:.2f} ms per "
          f"{SEGMENT_STEPS}-step gradient, {repeats} repeats) ({card})")
    del grad

    # per launch by CUDA events, in turns: plain, kernel, kernel, plain
    f = f0.detach()
    out = torch.empty_like(f)
    u = torch.empty((3, *f.shape[1:]), dtype=f.dtype, device="cuda")
    ct = torch.empty_like(f)
    sc.stream_collide(f, **params, out=out, u_out=u)
    adjoint.stream_collide_adjoint(g1, u, **params, out=ct)
    ref_out, ref_u = sc.stream_collide_plain(f, **params, emit_u=True)
    ref_ct = adjoint.stream_collide_adjoint_plain(g1, u, **params)
    torch.cuda.synchronize()
    err_emit = max((out - ref_out).abs().max().item(),
                   (u - ref_u).abs().max().item())
    err_adj, scale_adj = scaled_err(ct, ref_ct)
    check(err_emit <= ATOL[torch.float32], f"256^3 emit-u: {err_emit}")
    check(err_adj <= GRAD_RTOL[torch.float32] * scale_adj,
          f"256^3 adjoint: {err_adj} of {scale_adj}")
    del ref_out, ref_u, ref_ct
    timings = {}
    for name, kernel, plain in (
            ("emit_u",
             lambda: sc.stream_collide(f, **params, out=out, u_out=u),
             lambda: sc.stream_collide_plain(f, **params, emit_u=True)),
            ("adjoint",
             lambda: adjoint.stream_collide_adjoint(g1, u, **params,
                                                    out=ct),
             lambda: adjoint.stream_collide_adjoint_plain(g1, u, **params))):
        plain_a = cuda_ms(plain, 5)
        kernel_a = cuda_ms(kernel, 50)
        kernel_b = cuda_ms(kernel, 50)
        plain_b = cuda_ms(plain, 5)
        ms = (kernel_a + kernel_b) / 2
        plain_ms = (plain_a + plain_b) / 2
        gbps = GRAD_BYTES_PER_UPDATE * cells / (ms * 1e-3) / 1e9
        print(f"phase 7: {name} per launch, CUDA events: kernel "
              f"{kernel_a:.4f} / {kernel_b:.4f} ms, plain {plain_a:.4f} / "
              f"{plain_b:.4f} ms ({plain_ms / ms:.1f}x); "
              f"{GRAD_BYTES_PER_UPDATE} B/update, {gbps:.1f} GB/s, "
              f"{gbps / saxpy_gbps:.1%} of the saxpy ({card})")
        timings[name] = (ms, plain_ms)
    del simulation, f0, f, out, u, ct, g1, segment
    torch.cuda.empty_cache()
    return dict(launches=launches, err_emit=err_emit, err_adjoint=err_adj,
                mlups=mlups, timings=timings)


def phase8_adam(card):
    simulation = tgv256_simulation()
    flow = simulation.flow
    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    with torch.no_grad():
        u_target = flow.view(segment(flow.f)).u()
    shape = tuple(flow.f.shape[1:])
    f_rest = flow.equilibrium(
        flow, rho=torch.ones((1, *shape), device="cuda"),
        u=torch.zeros((3, *shape), device="cuda"))
    f0 = f_rest.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([f0], lr=2e-4)
    losses = []
    before = launch_counts()
    for _ in range(5):
        optimizer.zero_grad()
        u = flow.view(segment(f0)).u()
        loss = torch.mean((u - u_target) ** 2)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    launched = tuple(a - b for a, b in zip(launch_counts(), before))
    print(f"phase 8: Adam on example 09's loss at 256^3, "
          f"{SEGMENT_STEPS}-step segment: losses "
          f"{', '.join(f'{v:.6e}' for v in losses)}; launches {launched} "
          f"({card})")
    check(all(np.isfinite(losses)), "Adam losses not finite")
    check(losses[-1] < losses[0], "the loss did not decrease")
    check(launched == (0, 5 * SEGMENT_STEPS, 5 * SEGMENT_STEPS),
          f"Adam launches {launched}")
    del simulation, flow, segment, f0, optimizer, u_target
    torch.cuda.empty_cache()


def main():
    card = phase0_card()
    build_s = phase1_build()
    worst = phase2_kernel_vs_plain()
    main_path = phase3_main_path(card)
    phase4_convergence()
    saxpy_gbps = phase5_saxpy(main_path["mlups"], card)
    worst_emit, worst_adjoint = phase6_gradient_kernels_vs_plain()
    grad_path = phase7_gradient_path(card, saxpy_gbps)
    phase8_adam(card)
    print(f"build {build_s:.2f} s")
    print(card)
    emit_ms, emit_plain_ms = grad_path["timings"]["emit_u"]
    adj_ms, adj_plain_ms = grad_path["timings"]["adjoint"]
    print(json.dumps({"kernels": [{
        "name": "stream_collide",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": max(worst, main_path["err"]),
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
    }, {
        "name": "stream_collide_emit_u",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": grad_path["launches"][1],
        "max_abs_err": max(worst_emit, grad_path["err_emit"]),
        "ms": emit_ms,
        "plain_ms": emit_plain_ms,
    }, {
        "name": "stream_collide_adjoint",
        "route": "cuda",
        "source": ADJOINT_SOURCE,
        "replaces": ADJOINT_REPLACES,
        "launches": grad_path["launches"][2],
        "max_abs_err": max(worst_adjoint, grad_path["err_adjoint"]),
        "ms": adj_ms,
        "plain_ms": adj_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
