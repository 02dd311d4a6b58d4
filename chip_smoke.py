#!/usr/bin/env python3
"""Smoke test of lettuce_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA stream-collide kernel from ``lettuce_tpu_torch/csrc``,
checks it against its plain PyTorch version, drives the main path (D3Q19
BGK Taylor-Green 256^3, float32) through the kernel, runs the float64
convergence gate through the kernel, and measures the card's practical
bandwidth. Every failed check exits non-zero; nothing is caught.

Phases:
  0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  1. build the kernel library (seconds printed);
  2. kernel vs plain on the card: D2Q9 64x96 and D3Q15/D3Q19/D3Q27
     30x34x36, float32 and float64, 1 and 4 steps, TGV state plus seeded
     noise; the launch count must advance by the step count;
  3. the main path: 20 warm-up and 200 timed steps, one launch per step,
     finite state, mass conserved; MLUPS of the kernel path and of the
     plain torch path at the same size; kernel vs plain at that size;
  4. the TGV2D convergence gate in float64 at 16..128 through
     ``lettuce_tpu_torch.cli``, in-process;
  5. saxpy over 1 GiB tensors: practical bandwidth, and the main path's
     share of it at 152 B per D3Q19 float32 lattice update.

Prints, before the last line, one JSON line describing the kernel, and
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
KERNEL_SOURCE = "lettuce_tpu_torch/csrc/stream_collide.cu"
REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1402"
BYTES_PER_UPDATE = 19 * 4 * 2  # D3Q19 float32: q populations in and out


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
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    cached = sc.library_path().exists()
    beg = time.perf_counter()
    path = sc.build_library()
    sc.load_library()
    seconds = time.perf_counter() - beg
    print(f"phase 1: kernel library {path.name} "
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


def phase2_kernel_vs_plain():
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    cases = [(lt.D2Q9(), (64, 96)), (lt.D3Q15(), (30, 34, 36)),
             (lt.D3Q19(), (30, 34, 36)), (lt.D3Q27(), (30, 34, 36))]
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

    sc.stream_collide.launches = 0
    simulation(20)
    mlups = simulation(200)
    launches = sc.stream_collide.launches

    check(launches == 220, f"{launches} kernel launches for 220 steps")
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


def main():
    card = phase0_card()
    build_s = phase1_build()
    worst = phase2_kernel_vs_plain()
    main_path = phase3_main_path(card)
    phase4_convergence()
    phase5_saxpy(main_path["mlups"], card)
    print(f"build {build_s:.2f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "stream_collide",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": max(worst, main_path["err"]),
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
