#!/usr/bin/env python3
"""Smoke test of lettuce_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``lettuce_tpu_torch/csrc`` (the fused
stream-collide step, its emit-u variant and its adjoint, each periodic and
masked), checks each against its plain PyTorch version, drives the main
path (D3Q19 BGK Taylor-Green 256^3, float32) through the kernel, runs the
float64 convergence gate through the kernel, measures the card's practical
bandwidth, drives the gradient of an 8-step rollout of the main path and a
few Adam iterations of an inverse-design loss through the emit-u and
adjoint kernels, then drives the bounded-flow path: the 2048x1024 obstacle
flow through the masked kernel and the outlet window replay, forward and
backward, and the Ghia lid-driven cavity gate through the masked kernel,
and profiles the bounded path; then drives the collision-model path: every
collision fragment against its plain version, the JAX suite's fragment
cells at full size, the TGV3D KBC and Poiseuille gates, every fragment on
the obstacle, the probe's refusals and the decaying turbulence; then the
gradients of the fragments: every emit-u fragment instance and fragment
adjoint against its plain version, the gradient cells at full width in
full and split mode, and two obstacle gradients; then half-precision
storage: every 16-bit instance (bfloat16 deviations, bfloat16 and float16
states) against its plain version, the main path and the fragment cells
under ``half_storage``, and 16-bit states through the CLI; then temporal
blocking: every blocked instance (K2) and the blocked adjoint (K4)
against their plain versions, the main path at ``LETTUCE_NSUB=2`` and 4
in float32 and under half storage, and the 8-step gradient at span 2;
the blocked bounded flows; then the gradient of a 16-bit state: every
16-bit emit-u, adjoint and blocked-adjoint instance against its plain
version, the main path's gradient in bfloat16 and float16 and the
fragment, split and obstacle cells in bfloat16 at full width, and the
blocked bfloat16 gradient at span 2; last, the march plans the planner
offers the main path's blocked launches, each timed and held to the
default plan's output.
Every failed check exits non-zero; nothing is caught.

Phases:
  0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  1. build the kernel libraries, one nvcc per source, all at once (seconds
     printed), and summarise ptxas's registers and spills per source (the
     table per instance in build/lettuce_tpu_torch/ptxas_summary.txt);
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
     last loss must be below the first;
  9. the masked kernels vs plain on all 24 masked instances (primal and
     emit-u forward, adjoint) at the grids of phase 2, with a bounce-back
     cylinder (sphere), a constant-equilibrium inlet, a per-node
     equilibrium field, an identity outlet plane and a frozen plane; one
     launch of each per case;
 10. the probe on the card: the kernel path for each outlet kind and for
     Couette (256x128, against the torch step over 4 steps), the torch
     step with its printed reason for PeriodicPressureBC; then the obstacle
     flow of benchmarks/run_benchmarks.py:76-88
     (``obstacle2d_2048``: 2048x1024 D2Q9 float32, Re 100, Ma 0.1, a
     cylinder of radius 0.05 ny, equilibrium inlet, anti-bounce-back
     outlet) on the ``'cuda+hybrid x1'`` path: kernel + replay against the
     torch step over 4 steps; 20 warm-up and 100 timed steps with one
     masked launch per step, finite state; MLUPS of the kernel path and of
     the torch path; per-step ms of the masked kernel and of the replay by
     CUDA events, with GB/s at 73 B per update and the share of the
     saxpy; the 8-step gradient ``(seg(f0) ** 2).sum()`` against autograd
     of the torch step to 1e-5, bitwise equal under ``checkpoint_every=4``;
 11. the lid-driven cavity at 256^2, Re 100, Ma 0.05, float32 through the
     masked kernel: the kernel against its plain version at this shape and
     table (one step from a noisy state, and from the converged state),
     the kernel path against the torch step over 20 steps; then in chunks
     of 5000 steps until the velocity field changes by less than 1e-4;
     the centreline's max deviation from Ghia et al. (1982) Table I must
     be under 0.03 (benchmarks/validate_cavity.py's gate);
 12. where the bounded path's time goes: the periodic and the masked
     kernel back to back on the obstacle's grid; host microseconds per
     masked launch at 256^2 with the gate's packed table and an unpacked
     one; the obstacle step and its 8-step gradient under torch.profiler
     (device launches, device time, the device idle share against the
     unprofiled wall time);
 13. every collision fragment (K1c: none, bgk_force, trt, reg, smag, the
     four MRT bases, kbc) on each stencil it is compiled for, float32 and
     float64, against its plain version on the grids of phase 2: periodic
     over 1 and 3 steps, masked (phase 9's codes and frozen planes) over 2;
     launches equal steps;
 14. the fragment cells of benchmarks/run_benchmarks.py:129-171, uncut,
     float32, through Simulation.__call__ on 'cuda x1': kbc3d_256_d3q27,
     reg3d_256_d3q27, mrt3d_256_d3q19, trt3d_256_d3q19, smag3d_256_d3q19,
     poiseuille2d_2048_guo; 20 + 100 steps with one launch each, finite,
     mass conserved; MLUPS, kernel and plain ms by CUDA events, the share
     of the saxpy;
 15. the TGV3D gate: D3Q27 KBC at 256^3, Re 1600 (2 pi), Ma 0.05, float32,
     to t = 10 with E and the enstrophy every ~0.05; both dissipation
     peaks against benchmarks/tgv3d_validation_kbc.json (0.15 in time,
     5 % in value);
 16. tests/test_force.py's Poiseuille gate through the masked forced-BGK
     kernel, Guo and Shan-Chen, float64;
 17. every D2Q9 fragment on obstacle2d_2048 ('cuda+hybrid x1') and the 3D
     MRT fragments on a 96x48x48 obstacle, against the torch step over 4
     steps, each masked kernel timed against its plain version; the probe
     keeps the torch step, with its reason, for an MRT transform without
     a closed form, Smagorinsky with a force and a per-node acceleration;
     a TRT state that requires grad launches the emit-u TRT fragment and
     the TRT adjoint (3 each for 3 steps) and prints nothing;
 18. decaying turbulence, D3Q19 Smagorinsky 256^3 float32: the kernel path
     against the torch step over 4 steps, 20 steps losing energy
     monotonically;
 19. every new instance against its plain version at the grids of phase 2,
     float32 to 5e-6 and float64 to 1e-12 (adjoints to that of the plain's
     largest magnitude): the emit-u trt, reg and mrt_from_feq instances,
     periodic and masked; the adjoint of every full-mode spec (trt, matvec
     for reg and mrt_from_feq, smag, none) periodic, masked and with the
     no-streaming mask alone (split mode's entry), and BGK's nsm-only
     path; one launch each;
 20. the gradient cells at full width, float32 (trt3d_256_d3q19,
     mrt3d_256_d3q19, reg3d_256_d3q27, smagorinsky_d3q19 256^3: full mode;
     kbc_d3q27 128^3, mrt_lallemand_d2q9 and bgk_guo_d2q9 2048^2: split
     mode, benchmarks/bench_adjoint.py:102-126): make_segment_fn(8) with 8
     forward fragment and 8 adjoint launches, the 2-step gradient against
     autograd of the torch step along the kernels' trajectory to 1e-5
     (KBC's float32 gradient is too ill-conditioned to follow the torch
     step's own; both sides take u from K5, as Flow.u does), fwd+bwd
     MLUPS (3 repeats after a warm-up), and per launch the forward and
     adjoint kernels against their plain versions by CUDA events (plus
     split mode's pointwise VJP);
 21. obstacle2d_2048 with the regularized collision (masked emit-u reg,
     masked matvec adjoint, replay) and with KBC (masked kbc, the streaming
     transpose, the pointwise VJP, replay): the 8-step gradient against
     autograd of the torch step along the kernels' trajectory to 1e-5,
     both kernels per launch;
 22. every 16-bit instance (K1e: bfloat16 deviations g = f - w_q, every
     fragment but the closed-form MRT bases; K1f: bfloat16 and float16
     states, every fragment) against its plain version on the grids of
     phase 2, periodic and masked (phase 9's codes and frozen planes), 3
     steps each from the plain state of the step before: steps 1 and 3
     within one storage ulp entrywise (deviations: plus 2^-23, KBC 2^-19,
     the float32 roundoff of a rebuilt population), the worst ulps and the
     fraction of entries that differ printed; launches equal steps;
 23. the main path under ``Simulation(half_storage=True)``: 20 + 200 steps
     with one bf16-dev launch each, finite, mass to 1e-4; u after 10 steps
     within 2 % of the float32 kernel path's; MLUPS, kernel and plain ms by
     CUDA events in turns, GB/s at 76 B per update, the share of the saxpy;
     ``rollout(20, [energy], interval=5)`` ends bitwise where
     ``simulation(20)`` does;
 24. phase 14's cells under half storage (bf16-dev, the Poiseuille cell
     masked): 20 + 100 steps with one launch each, kernel vs plain at the
     cell's state, MLUPS, kernel and plain ms, the share of the saxpy;
 25. 16-bit states: ``benchmark -p half`` and ``benchmark --half-storage``
     (TGV3D 256^3) in process; a float16 and a bfloat16 D3Q19 256^3 state
     timed against plain; tests/test_native.py's D2Q9 bfloat16 and float16
     sanity runs; an analytic MRT under half storage warns and runs at
     full precision. Phase 1 fails if a 16-bit instance spills;
 26. every periodic K2 instance (BGK and every fragment; float32, float64,
     bfloat16 and float16 states, bfloat16 deviations) against its plain
     version on the grids of phase 2 at n_sub 2, 3 and 4: two launches
     each (the second from the plain state of the first), counted;
     float32 and float64 to ATOL and against n_sub K1 launches; 16 bits
     within one storage ulp (deviations plus n_sub times the floor);
 27. the main path with ``LETTUCE_NSUB=2`` and 4, float32 and under half
     storage: step_path ``'cuda x<span>'``, 20 + 200 steps in 220 / span
     K2 launches and no single-step one, finite, mass to 1e-5 (1e-4 half);
     MLUPS; K2 per launch and per step by CUDA events in turns with K1a or
     K1e and its plain version, the share of the saxpy; the CLI benchmark
     in process under ``LETTUCE_NSUB=2`` printing ``cuda x2``;
 28. K4 against its plain version per spec (bgk, trt, matvec for reg and
     MRT from_feq, none), float32 and float64, n_sub 2 and 4, on the grids
     of phase 2; the 8-step 256^3 gradient through make_segment_fn(8) at
     span 2: 4 K2 and 4 K4 launches and no single-step one, within 1e-5
     of the single-step kernels' gradient, bitwise equal under
     checkpoint_every=4, fwd+bwd MLUPS against phase 7's, peak memory of
     both; K2 + K4 per step in turns with K1d + K3a, K4 against plain;
 29. every masked K2 instance against its plain version at n_sub 2-4 and
     against n_sub masked K1 launches;
 30. the bounded 2D cells at span 1, 2 and 4 through the blocked kernel
     and the outlets' n_sub window replay, float32 and half storage;
 31. the Ghia cavity gate at span 2;
 32. the gradient of a 16-bit state, instance by instance, bfloat16 and
     float16 on the grids of phase 2: K1d at 16 bits (bgk, trt, reg,
     mrt_from_feq; periodic and masked; the state within one storage ulp,
     u in float32 within 5e-6), K3 at 16 bits (every full-mode spec;
     periodic, codes, codes+frozen, nsm-only; one storage ulp at the
     largest magnitude) and K4 at 16 bits (n_sub 2-4; one ulp plus n_sub
     float32 floors), each against its plain version, one launch each;
 33. the 16-bit gradient path at full width: the main path in bfloat16
     and float16 through make_segment_fn(8) (8 emit-u and 8 adjoint
     launches at 16 bits, nothing else; inf and subnormal counts; within
     one storage ulp per step of the plain chain at 16 bits; against the
     float32 gradient of the same loss from the upcast state, float16
     within 2 %, bfloat16 reported;
     peak memory; fwd+bwd MLUPS; K1d and K3 at 16 bits per launch against
     plain and their bounds at 3.35 TB/s and at the saxpy), then in
     bfloat16 the TRT, MRT, Smagorinsky D3Q19 and regularized D3Q27 cells
     at 256^3, split mode's Guo BGK D2Q9 2048^2 and obstacle2d_2048
     through the replay (each against its float32 gradient, reported);
 34. the blocked bfloat16 gradient at LETTUCE_NSUB=2: 4 K2 and 4 K4
     launches at 16 bits, within one storage ulp per launch of the plain
     chain and 2 % of the float32 gradient, fwd+bwd
     MLUPS against phase 33's single-step run, K2 + K4 per two steps in
     turns with K1d + K3, K4 against plain;
 35. the periodic K2's and K4's march plans at full width (D3Q19 BGK
     256^3: K2 float32 and bfloat16 deviations at x2 and x4, K4 float32
     and bfloat16 at x2): every candidate of build.march_candidates (two
     budgets, narrow and wide rows, more segments) against the default
     plan's output, timed in turns with K1a; ms per launch and per step,
     the share of the saxpy, the default and the fastest;
 36. the single-step kernels' cell-flat launch (build.plan_cells): every
     masked 16-bit instance through its shipped cells a thread (vectors,
     nothing frozen) against its plain version on the grids of phase 2;
     then row by row, each candidate bitwise equal to the default plan's
     output, event ms (200 launches, in turns with the plain version),
     torch.profiler's device ms per launch, the bound at 3.35 TB/s and at
     the saxpy: K1c hermite27 masked on the 3D obstacle at 96x48x48 and
     320x160x160 and periodic at 256^3 (the __launch_bounds__ minimum
     blocks per SM 1-4, 32-bit division), K1a (32-bit division), K1e
     bgk_force masked on the Poiseuille 2048^2 cell (1, 2, 4 cells a
     thread), K3c, K1d@16, K1f and K3@16 masked on obstacle2d_2048, K1c
     none/lallemand/dellar masked on it, and BGK masked per stencil and
     16-bit storage at 1, 2 and 4 cells a thread (the obstacles at
     2048x1024 and 320x160x160), the fastest printed beside the shipped;
 37. the velocity moment of Flow.u and its adjoint (K5, csrc/moments.cu):
     every instance (D1Q3, D2Q9, D3Q15, D3Q19, D3Q27; float32, bfloat16,
     float16; the 16-byte path, a cell count it does not divide, a
     misaligned state) against the plain versions, the C entry refusing
     16-byte accesses on a misaligned pointer; then D3Q19 256^3 and D2Q9
     2048x1024 in each dtype: against plain, event ms in turns with the
     plain versions and with the torch expression's forward and autograd
     backward, torch.profiler's device ms, the bound at 3.35 TB/s and at
     the saxpy (92 and 104 B a cell in float32), the launches of one
     Flow.u loss step on each state; a 256^3 Flow.u under autograd
     against the expression's gradient.
Phases 26-28 and 34 also print each launch's march plan, phase 26 how
many float32 and float64 instance-spans are bitwise equal to n_sub K1
launches.

Prints, before the last line, one JSON line describing the kernels (K2
and K4 with their span and per-step time; with each launch's bound: its
bytes over an H100 SXM's 3.35 TB/s and its operations over 67 TFLOP/s
float32, the larger), and last ``{"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": N}}``.
"""

import json
import os
import re
import shutil
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
# the mask pipeline of the TPU kernels: stream_collide.py:1565-1605,
# adjoint.py:218-241
MASKED_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1565"
ADJOINT_MASKED_REPLACES = "lettuce_tpu/ops/pallas/adjoint.py:218"
# D2Q9 float32 masked step: q populations in and out plus the 1-byte code
MASKED_BYTES_PER_UPDATE = 9 * 4 * 2 + 1
# Ghia, Ghia & Shin (1982), Table I: u_x / u_lid on the vertical
# centreline, Re = 100 (as benchmarks/validate_cavity.py)
GHIA_Y = np.array([
    0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
    0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766])
GHIA_U = np.array([
    -0.03717, -0.04192, -0.04775, -0.06434, -0.10150, -0.15662, -0.21090,
    -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.73722, 0.78871,
    0.84123])
GHIA_GATE = 0.03
BYTES_PER_UPDATE = 19 * 4 * 2  # D3Q19 float32: q populations in and out
# emit-u: q in, q + d out; adjoint: q + d in, q out
GRAD_BYTES_PER_UPDATE = (19 * 2 + 3) * 4
SEGMENT_STEPS = 8
# the least time the card could take (bound_ms in the kernels line): an
# H100 SXM's published HBM3 rate and float32 rate outside the tensor cores
# (NVIDIA's H100 datasheet), against the bytes each launch
# must move (inputs read once, outputs written once) and its operations
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per population of each kernel, counted from csrc/ (a
# multiply-add counts two; approximate, and far below the bytes' time)
OPS_PER_POPULATION = {
    "bgk": 10, "emit_u": 11, "none": 0, "bgk_force": 14, "trt": 12,
    "reg": 16, "smag": 20, "mrt_from_feq": 31, "mrt_lallemand": 40,
    "mrt_dellar": 40, "mrt_hermite27": 66, "kbc": 40, "adjoint_bgk": 14,
    "adjoint_trt": 16, "adjoint_matvec": 40, "adjoint_smag": 30,
    "adjoint_none": 0}


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
    from lettuce_tpu_torch.ops.cuda import adjoint, build, moments
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    cached = all(build.library_path(name).exists() for name in build.SOURCES)
    beg = time.perf_counter()
    paths = build.build_libraries()
    sc.load_libraries()
    adjoint.load_libraries()
    moments.load_library()
    seconds = time.perf_counter() - beg
    print(f"phase 1: kernel libraries "
          f"{', '.join(path.name for path in paths.values())} "
          f"{'loaded from cache' if cached else 'built'} in {seconds:.2f} s")
    ptxas_summary()
    sass_loops()
    return seconds


def tgv_state(stencil, shape, dtype, seed, scale=1e-3):
    """TGV initial state on the card plus seeded numpy noise of ``scale``."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=dtype, use_native=False)
    flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                stencil=stencil, initialize_fneq=False)
    noise = scale * np.random.default_rng(seed).standard_normal(
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
                before = launch_counts()[0]
                got, ref = f, f
                for _ in range(steps):
                    got = sc.stream_collide(got, *args)
                    ref = sc.stream_collide_plain(ref, *args)
                torch.cuda.synchronize()
                launched = launch_counts()[0] - before
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
    before = launch_counts()[0]
    rc = cli.main(["--device", "cuda", "-p", "double", "convergence",
                   "--max-resolution-exponent", "7"])
    launched = launch_counts()[0] - before
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


FULL_STORAGE = ("f32", "f64")
HALF_STORAGE = ("bf16", "f16", "bf16_dev")


def launched(kernel, storages=FULL_STORAGE + HALF_STORAGE, bgk=True):
    """``{key: launches}`` of ``kernel`` (``"K1"`` .. ``"K4"``) in the
    port's launch counter (``tracing.counts``), each key without its
    ``"<kernel>:"``, over ``storages`` (the key's storage suffix, before a
    blocked kernel's ``_x<n_sub>``); ``bgk=False`` leaves out the BGK
    fragment."""
    from lettuce_tpu_torch import tracing
    out = {}
    for key, n in tracing.counts.items():
        family, _, rest = key.partition(":")
        head = re.sub(r"_x\d+$", "", rest)
        storage = next((s for s in sorted(storages, key=len, reverse=True)
                        if head.endswith("_" + s)), None)
        if family != kernel or storage is None or not n:
            continue
        fragment = re.sub(r"^(masked_|frozen_)?(emit_u_)?", "",
                          head[:-len(storage) - 1])
        if bgk or fragment != "bgk":
            out[rest] = n
    return out


def _full(key):
    """Launches under ``key`` at float32 and float64."""
    from lettuce_tpu_torch import tracing
    return sum(tracing.counts[f"{key}_{s}"] for s in FULL_STORAGE)


def launch_counts():
    """(primal, emit-u, adjoint) periodic BGK kernel launch counts."""
    return _full("K1:bgk"), _full("K1:emit_u_bgk"), _full("K3:bgk")


def masked_launch_counts():
    """(primal, emit-u, adjoint) masked BGK kernel launch counts; the
    adjoint's include its frozen-populations-only launches."""
    return (_full("K1:masked_bgk"), _full("K1:masked_emit_u_bgk"),
            _full("K3:masked_bgk") + _full("K3:frozen_bgk"))


def reset_launch_counts():
    from lettuce_tpu_torch import tracing
    tracing.counts.clear()


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


def bounded_case(stencil, shape, dtype, seed):
    """A masked-kernel case on the card: a state near rest with seeded
    noise and the masks of a bounded flow. Codes: 1 bounce back (a
    cylinder or sphere), 2 a constant equilibrium (inlet plane x = 0),
    3 a per-node equilibrium field (wall plane y = 0), 4 identity (outlet
    plane x = -1); every population frozen on the plane x = n0 // 2, the
    odd ones on y = 1."""
    rng = np.random.default_rng(seed)
    q, d = stencil.e.shape
    w = stencil.w.reshape((-1,) + (1,) * d)
    f = w * (1 + rng.uniform(-0.1, 0.1, (q, *shape)))
    feq = w * (1 + rng.uniform(-0.05, 0.05, (q, *shape)))
    ncm = np.zeros(shape, np.uint8)
    grid = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    r2 = sum((x - n / 2) ** 2 for x, n in zip(grid, shape))
    ncm[r2 < (min(shape) / 5) ** 2] = 1
    ncm[0] = 2
    ncm[:, 0] = 3
    ncm[-1] = 4
    nsm = np.zeros((q, *shape), bool)
    nsm[:, shape[0] // 2] = True
    nsm[1::2, :, 1] = True
    table = (("collide", None), ("bounce_back", None),
             ("equilibrium_pu", tuple(1.01 * stencil.w)),
             ("equilibrium_pu_field", None), ("identity", None))
    masks = dict(ncm=torch.as_tensor(ncm, device="cuda"),
                 nsm=torch.as_tensor(nsm, device="cuda"), table=table,
                 feq_field=torch.as_tensor(feq, dtype=dtype, device="cuda"))
    return torch.as_tensor(f, dtype=dtype, device="cuda"), masks


def phase9_masked_kernels_vs_plain():
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst_fwd = worst_emit = worst_adjoint = 0.0
    seed = 200
    for stencil, shape in phase2_cases():
        for dtype in (torch.float32, torch.float64):
            seed += 1
            f, masks = bounded_case(stencil, shape, dtype, seed)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    1.0 / 0.6)
            g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                tuple(f.shape)), dtype=dtype, device="cuda")
            u = torch.empty((stencil.d, *shape), dtype=dtype, device="cuda")
            before = masked_launch_counts()
            got = sc.stream_collide(f, *args, **masks)
            got_emit, _ = sc.stream_collide(f, *args, **masks, u_out=u)
            ct = adjoint.stream_collide_adjoint(g, u, *args, **masks)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in
                             zip(masked_launch_counts(), before))
            ref, u_ref = sc.stream_collide_plain(f, *args, **masks,
                                                 emit_u=True)
            ct_ref = adjoint.stream_collide_adjoint_plain(g, u, *args,
                                                          **masks)
            err_f = (got - ref).abs().max().item()
            err_e = max((got_emit - ref).abs().max().item(),
                        (u - u_ref).abs().max().item())
            err_ct, scale = scaled_err(ct, ct_ref)
            name = type(stencil).__name__
            print(f"phase 9: {name} {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]} masked: primal {err_f:.3e}, emit-u "
                  f"{err_e:.3e} (atol {ATOL[dtype]:.0e}); adjoint "
                  f"{err_ct:.3e} of {scale:.3e} (rtol "
                  f"{GRAD_RTOL[dtype]:.0e}); launches {launched}")
            check(launched == (1, 1, 1), f"{name}: masked launches "
                                         f"{launched}")
            check(bool(torch.isfinite(got).all() and torch.isfinite(ct).all()
                       and torch.isfinite(u).all()), f"{name}: not finite")
            check(max(err_f, err_e) <= ATOL[dtype],
                  f"{name} {dtype}: masked forward error {err_f}, {err_e}")
            check(err_ct <= GRAD_RTOL[dtype] * scale,
                  f"{name} {dtype}: masked adjoint error {err_ct} of "
                  f"{scale}")
            worst_fwd = max(worst_fwd, err_f)
            worst_emit = max(worst_emit, err_e)
            worst_adjoint = max(worst_adjoint, err_ct)
    return worst_fwd, worst_emit, worst_adjoint


def obstacle_flow(context, nx=2048, ny=1024, outlet=None):
    """``obstacle2d_2048`` of benchmarks/run_benchmarks.py:76-88,136 on
    the card: a cylinder in a 2048x1024 D2Q9 channel. ``outlet`` (a
    boundary class name) replaces its anti-bounce-back outlet."""
    import lettuce_tpu_torch as lt

    class Channel(lt.Obstacle):
        @property
        def boundaries(self):
            inlet, abb, cylinder = lt.Obstacle.boundaries.fget(self)
            if outlet is not None:
                abb = getattr(lt, outlet)([1, 0], self)
            return [inlet, abb, cylinder]

    flow = Channel(context, [nx, ny], reynolds_number=100, mach_number=0.1,
                   domain_length_x=float(nx))
    x, y = flow.grid
    r = 0.05 * ny
    flow.mask = (x - 0.25 * nx) ** 2 + (y - 0.5 * ny) ** 2 < r ** 2
    flow.initialize()
    return flow


def obstacle_simulation(use_native, nx=2048, ny=1024, outlet=None,
                        make_collision=None):
    """The obstacle flow (:func:`obstacle_flow`) in float32 on the card;
    ``make_collision(flow)`` replaces its BGK collision."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=use_native)
    flow = obstacle_flow(context, nx, ny, outlet)
    if make_collision is None:
        return lt.Simulation(
            flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu),
            [])
    return lt.Simulation(flow, make_collision(flow), [])


def probe_on_card():
    """The probe picks the kernel for every outlet kind and for Couette
    (kernel against torch step over 4 steps, 256x128), and keeps the torch
    step for PeriodicPressureBC with its reason printed."""
    import contextlib
    import io
    import lettuce_tpu_torch as lt
    for outlet in ("AntiBounceBackOutlet", "EquilibriumOutletP",
                   "SpongeOutlet", "couette"):
        sims = []
        for native in (True, False):
            if outlet == "couette":
                context = lt.Context(device="cuda", dtype=torch.float32,
                                     use_native=native)
                flow = lt.CouetteFlow2D(context, [256, 128], 10, 0.05)
                sims.append(lt.Simulation(flow, lt.BGKCollision(
                    tau=flow.units.relaxation_parameter_lu), []))
            else:
                sims.append(obstacle_simulation(native, 256, 128, outlet))
        check(sims[0]._step_kind == "cuda" and sims[1]._step_kind == "torch",
              f"{outlet}: step kinds {sims[0]._step_kind}, "
              f"{sims[1]._step_kind}")
        for sim in sims:
            sim(4)
        err = (sims[0].flow.f - sims[1].flow.f).abs().max().item()
        print(f"phase 10: {outlet} 256x128: {sims[0].step_path} vs "
              f"{sims[1].step_path} over 4 steps: {err:.3e} (atol 5e-6)")
        check(err <= ATOL[torch.float32], f"{outlet}: {err}")

    class Driven(lt.CouetteFlow2D):
        @property
        def boundaries(self):
            return (lt.CouetteFlow2D.boundaries.fget(self)
                    + [lt.PeriodicPressureBC(self, 1e-3,
                                             lt.BGKCollision(0.8))])

    context = lt.Context(device="cuda", dtype=torch.float32, use_native=True)
    flow = Driven(context, [64, 32], 10, 0.05)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        sim = lt.Simulation(flow, lt.BGKCollision(0.8), [])
    reason = printed.getvalue().strip()
    print(f"phase 10: PeriodicPressureBC keeps the {sim._step_kind} step: "
          f"{reason!r}")
    check(sim._step_kind == "torch" and "PeriodicPressureBC" in reason,
          "PeriodicPressureBC: the probe did not keep the torch step with "
          "its reason")


def time_in_turns(kernel, plain, kernel_repeats=200, plain_repeats=5):
    """(kernel ms, plain ms, the four readings) by CUDA events, in turns:
    plain, kernel, kernel, plain."""
    kernel()
    plain()
    plain_a = cuda_ms(plain, plain_repeats)
    kernel_a = cuda_ms(kernel, kernel_repeats)
    kernel_b = cuda_ms(kernel, kernel_repeats)
    plain_b = cuda_ms(plain, plain_repeats)
    return ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2,
            (plain_a, kernel_a, kernel_b, plain_b))


def phase10_obstacle(card, saxpy_gbps):
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    probe_on_card()
    simulation = obstacle_simulation(True)
    plain_sim = obstacle_simulation(False)
    flow = simulation.flow
    check(simulation._step_kind == "cuda"
          and simulation.step_path == "cuda+hybrid x1",
          f"obstacle runs {simulation.step_path!r}, not 'cuda+hybrid x1'")
    check(plain_sim._step_kind == "torch", "plain obstacle is not torch")
    params = simulation._kernel_params
    check(params["nsm"] is None, "the obstacle kernel reads the nsm")
    cells = flow.f[0].numel()

    # kernel + replay against the torch step, 4 steps from one state
    simulation(4)
    plain_sim(4)
    err4 = (flow.f - plain_sim.flow.f).abs().max().item()
    print(f"phase 10: obstacle 2048x1024 D2Q9 float32, 4 steps: max "
          f"|kernel+replay - torch step| {err4:.3e} (atol 5e-6)")
    check(err4 <= ATOL[torch.float32], f"obstacle 4 steps: {err4}")

    # the throughput run
    reset_launch_counts()
    simulation(20)
    mlups = simulation(100)
    torch.cuda.synchronize()
    launched = masked_launch_counts()
    periodic = launch_counts()
    check(launched == (120, 0, 0) and periodic == (0, 0, 0),
          f"obstacle launches masked {launched}, periodic {periodic} for "
          f"120 steps")
    check(bool(torch.isfinite(flow.f).all()), "obstacle state not finite")
    plain_sim(3)
    plain_mlups = plain_sim(20)
    check(bool(torch.isfinite(plain_sim.flow.f).all()),
          "plain obstacle state not finite")
    print(f"phase 10: obstacle {simulation.step_path} {mlups:.1f} MLUPS, "
          f"{plain_sim.step_path} {plain_mlups:.1f} MLUPS; launches "
          f"{launched} ({card})")

    # per step by CUDA events: the masked kernel, the replay, the whole
    # step, and the plain masked step
    f = flow.f.clone()
    out = torch.empty_like(f)
    ref = sc.stream_collide_plain(f, **params)
    got = sc.stream_collide(f, **params, out=out)
    torch.cuda.synchronize()
    err1 = (got - ref).abs().max().item()
    check(err1 <= ATOL[torch.float32], f"masked 2048x1024: {err1}")
    del ref
    kernel_ms, plain_ms, turns = time_in_turns(
        lambda: sc.stream_collide(f, **params, out=out),
        lambda: sc.stream_collide_plain(f, **params))
    replay_ms = (cuda_ms(lambda: simulation._fixup(f, out), 20)
                 + cuda_ms(lambda: simulation._fixup(f, out), 20)) / 2
    step_ms = cuda_ms(lambda: simulation._cuda_step(f, out), 50)
    gbps = MASKED_BYTES_PER_UPDATE * cells / (kernel_ms * 1e-3) / 1e9
    print(f"phase 10: per step, CUDA events: masked kernel "
          f"{turns[1]:.4f} / {turns[2]:.4f} ms, plain masked step "
          f"{turns[0]:.4f} / {turns[3]:.4f} ms ({plain_ms / kernel_ms:.1f}x); "
          f"replay {replay_ms:.4f} ms; kernel + replay {step_ms:.4f} ms; "
          f"{MASKED_BYTES_PER_UPDATE} B/update, {gbps:.1f} GB/s, "
          f"{gbps / saxpy_gbps:.1%} of the saxpy ({card})")

    # the gradient kernels at this size
    u = torch.empty((2, *f.shape[1:]), dtype=f.dtype, device="cuda")
    g = torch.randn(f.shape, generator=torch.Generator(
        device="cuda").manual_seed(10), device="cuda")
    ct = torch.empty_like(f)
    sc.stream_collide(f, **params, out=out, u_out=u)
    adjoint.stream_collide_adjoint(g, u, **params, out=ct)
    ref_out, ref_u = sc.stream_collide_plain(f, **params, emit_u=True)
    ref_ct = adjoint.stream_collide_adjoint_plain(g, u, **params)
    torch.cuda.synchronize()
    err_emit = max((out - ref_out).abs().max().item(),
                   (u - ref_u).abs().max().item())
    err_adj, scale_adj = scaled_err(ct, ref_ct)
    check(err_emit <= ATOL[torch.float32], f"masked emit-u: {err_emit}")
    check(err_adj <= GRAD_RTOL[torch.float32] * scale_adj,
          f"masked adjoint: {err_adj} of {scale_adj}")
    del ref_out, ref_u, ref_ct
    emit_ms, emit_plain_ms, _ = time_in_turns(
        lambda: sc.stream_collide(f, **params, out=out, u_out=u),
        lambda: sc.stream_collide_plain(f, **params, emit_u=True))
    adj_ms, adj_plain_ms, _ = time_in_turns(
        lambda: adjoint.stream_collide_adjoint(g, u, **params, out=ct),
        lambda: adjoint.stream_collide_adjoint_plain(g, u, **params))
    print(f"phase 10: masked emit-u {emit_ms:.4f} ms (plain "
          f"{emit_plain_ms:.4f}), masked adjoint {adj_ms:.4f} ms (plain "
          f"{adj_plain_ms:.4f}) per launch ({card})")

    # the 8-step gradient through kernels and replay, against autograd of
    # the torch step
    f0 = flow.f.detach().clone().requires_grad_(True)

    def grad_of(seg):
        (grad,) = torch.autograd.grad((seg(f0) ** 2).sum(), f0)
        return grad

    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    reset_launch_counts()
    grad = grad_of(segment)
    torch.cuda.synchronize()
    grad_launches = masked_launch_counts()
    check(grad_launches == (0, SEGMENT_STEPS, SEGMENT_STEPS)
          and launch_counts() == (0, 0, 0),
          f"masked (primal, emit-u, adjoint) launches {grad_launches} for "
          f"an {SEGMENT_STEPS}-step gradient")
    check(bool(torch.isfinite(grad).all()), "obstacle gradient not finite")
    check(grad.abs().max().item() > 0, "obstacle gradient is zero")
    ref = grad_of(plain_sim.make_segment_fn(SEGMENT_STEPS))
    err_g, scale_g = scaled_err(grad, ref)
    del ref
    print(f"phase 10: {SEGMENT_STEPS}-step gradient: launches "
          f"{grad_launches}; max |kernels+replay - autograd of the torch "
          f"step| {err_g:.3e} of {scale_g:.3e} ({err_g / scale_g:.2e} "
          f"relative, rtol 1e-5)")
    check(err_g <= GRAD_RTOL[torch.float32] * scale_g,
          f"obstacle gradient: {err_g} of {scale_g}")
    grad_ck = grad_of(simulation.make_segment_fn(SEGMENT_STEPS,
                                                 checkpoint_every=4))
    torch.cuda.synchronize()
    check(torch.equal(grad, grad_ck),
          "obstacle checkpoint_every=4 gradient differs")
    print("phase 10: checkpoint_every=4 gradient is bitwise equal")
    grad_of(segment)
    torch.cuda.synchronize()
    beg = time.perf_counter()
    for _ in range(3):
        grad_of(segment)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / 3
    grad_mlups = cells * SEGMENT_STEPS / seconds / 1e6
    print(f"phase 10: fwd+bwd {grad_mlups:.1f} MLUPS ({seconds * 1e3:.2f} "
          f"ms per {SEGMENT_STEPS}-step gradient) ({card})")
    del simulation, plain_sim, flow, f, out, u, g, ct, f0, grad, grad_ck
    torch.cuda.empty_cache()
    return dict(launches=launched[0], grad_launches=grad_launches,
                err=max(err1, err4), err_emit=err_emit, err_adjoint=err_adj,
                kernel_ms=kernel_ms, plain_ms=plain_ms, emit_ms=emit_ms,
                emit_plain_ms=emit_plain_ms, adjoint_ms=adj_ms,
                adjoint_plain_ms=adj_plain_ms)


def cavity_simulation(use_native, n=256):
    """The lid-driven cavity of benchmarks/validate_cavity.py on the card:
    256^2 D2Q9 float32, Re 100, Ma 0.05."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=use_native)
    flow = lt.Cavity2D(context, n, reynolds_number=100, mach_number=0.05)
    return lt.Simulation(
        flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu), [])


def masked_vs_plain(f, params):
    """max |masked kernel - plain masked step| for one step from ``f``."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    got = sc.stream_collide(f, **params)
    ref = sc.stream_collide_plain(f, **params)
    torch.cuda.synchronize()
    return (got - ref).abs().max().item()


def phase11_cavity(card):
    n = 256
    simulation = cavity_simulation(True, n)
    flow = simulation.flow
    check(simulation.step_path == "cuda x1",
          f"cavity runs {simulation.step_path!r}, not the masked kernel")
    params = simulation._kernel_params
    check([kind for kind, _ in params["table"]]
          == ["collide", "bounce_back", "equilibrium_pu"],
          f"cavity table {[kind for kind, _ in params['table']]}")

    # the masked kernel at this path's shape and table (bounce-back walls,
    # the lid's constant equilibrium) against its plain version, on the
    # initial state plus seeded noise; then 20 steps of the kernel path
    # against the torch step
    noise = 1e-3 * np.random.default_rng(11).standard_normal(
        tuple(flow.f.shape))
    err_noise = masked_vs_plain(
        (flow.f + torch.as_tensor(noise, dtype=flow.f.dtype,
                                  device="cuda")).contiguous(), params)
    check(err_noise <= ATOL[torch.float32],
          f"cavity masked kernel vs plain: {err_noise}")
    lockstep = cavity_simulation(True, n)
    plain_sim = cavity_simulation(False, n)
    check(plain_sim._step_kind == "torch", "plain cavity is not torch")
    lockstep(20)
    plain_sim(20)
    err_steps = (lockstep.flow.f - plain_sim.flow.f).abs().max().item()
    print(f"phase 11: cavity {n}^2 masked kernel vs plain, one step from a "
          f"noisy state: {err_noise:.3e}; kernel path vs torch step over 20 "
          f"steps: {err_steps:.3e} (atol 5e-6)")
    check(err_steps <= ATOL[torch.float32],
          f"cavity kernel path vs torch step: {err_steps}")
    del lockstep, plain_sim

    reset_launch_counts()
    gate = cavity_gate(simulation)
    steps = gate["steps"]
    launched = masked_launch_counts()
    check(launched == (steps, 0, 0) and launch_counts() == (0, 0, 0),
          f"cavity launches {launched} for {steps} steps")
    print(f"phase 11: cavity 256^2 Re 100 Ma 0.05 float32, "
          f"{simulation.step_path}: {steps} steps "
          f"({'converged' if gate['change'] < 1e-4 else 'not converged'}, "
          f"last change {gate['change']:.2e}) in {gate['seconds']:.2f} s, "
          f"{gate['mlups']:.1f} MLUPS; max deviation from Ghia "
          f"{gate['dev']:.5f}, rms {gate['rms']:.5f} (gate {GHIA_GATE}) "
          f"({card})")
    check(gate["dev"] < GHIA_GATE, f"cavity deviation {gate['dev']} from "
                                   f"Ghia")
    # and once more on the converged state, where the flow fills the box
    err_converged = masked_vs_plain(flow.f, params)
    print(f"phase 11: masked kernel vs plain on the converged state: "
          f"{err_converged:.3e} (atol 5e-6)")
    check(err_converged <= ATOL[torch.float32],
          f"converged cavity masked kernel vs plain: {err_converged}")
    del simulation, flow
    torch.cuda.empty_cache()
    return max(err_noise, err_steps, err_converged), gate["dev"]


def cavity_gate(simulation):
    """Run the cavity in chunks of 5000 steps until the velocity field
    changes by less than 1e-4 (at most 200,000 steps); the centreline's
    deviation from Ghia et al. (1982) Table I, with the walls half a link
    outside their node rows and the lid on the top row
    (benchmarks/validate_cavity.py). Returns the steps, the last change,
    the seconds, MLUPS and the max and rms deviation."""
    flow = simulation.flow
    n = flow.resolution[0]
    steps, chunk, max_steps = 0, 5000, 200_000
    prev, change = None, float("inf")
    beg = time.perf_counter()
    while steps < max_steps:
        simulation(chunk)
        steps += chunk
        u = flow.u()
        if prev is not None:
            change = ((u - prev).abs().max()
                      / u.abs().max().clamp_min(1e-30)).item()
            if change < 1e-4:
                break
        prev = u
    torch.cuda.synchronize()
    seconds = time.perf_counter() - beg
    check(bool(torch.isfinite(flow.f).all()), "cavity state not finite")
    u_np = u.cpu().numpy()
    u_lid = float(flow.units.characteristic_velocity_lu)
    y_nodes = (np.arange(n) - 0.5) / (n - 1.5)
    ux_center = (u_np[0][n // 2 - 1, :] + u_np[0][n // 2, :]) / 2 / u_lid
    dev = np.abs(np.interp(GHIA_Y, y_nodes, ux_center) - GHIA_U)
    return dict(steps=steps, change=change, seconds=seconds,
                mlups=steps * n * n / seconds / 1e6, dev=float(dev.max()),
                rms=float(np.sqrt((dev ** 2).mean())))


def profiled_device_ms(fn):
    """(device ms, device launches) of ``fn()`` under ``torch.profiler``,
    and the device ms and the launches the profiler recorded of every
    kernel by name (a template's name without its arguments); None when
    the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None
    by_name, counts = {}, {}
    for e in device:
        # "void lt::masked_stream_collide_kernel<...>(...)"
        name = re.search(r"(\w+)<", e.name)
        name = name.group(1) if name else e.name
        by_name[name] = (by_name.get(name, 0.0)
                         + e.time_range.elapsed_us() / 1e3)
        counts[name] = counts.get(name, 0) + 1
    return (sum(e.time_range.elapsed_us() for e in device) / 1e3,
            len(device), {k: round(v, 4) for k, v in by_name.items()},
            counts)


def phase12_profile(card):
    """Where the bounded path's time goes: K1a against K1b back to back on
    the obstacle's grid; the host time per masked launch at the cavity's
    size, with the gate's packed table and with an unpacked one; the
    obstacle step and its 8-step gradient under torch.profiler, with the
    device idle share against the same work's unprofiled wall time."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    simulation = obstacle_simulation(True)
    params = simulation._kernel_params
    f = simulation.flow.f.clone()
    out = torch.empty_like(f)
    periodic, tau_inv = tgv_state(lt.D2Q9(), tuple(f.shape[1:]),
                                  torch.float32, 12)
    periodic_params = dict(e=params["e"], w=params["w"],
                           opposite=params["opposite"], cs=params["cs"],
                           tau_inv=tau_inv)
    k1b_ms, k1a_ms, turns = time_in_turns(
        lambda: sc.stream_collide(f, **params, out=out),
        lambda: sc.stream_collide(periodic, **periodic_params, out=out),
        kernel_repeats=200, plain_repeats=200)
    print(f"phase 12: 2048x1024 D2Q9 float32 per launch, CUDA events, in "
          f"turns: periodic K1a {turns[0]:.4f} / {turns[3]:.4f} ms, masked "
          f"K1b {turns[1]:.4f} / {turns[2]:.4f} ms ({k1b_ms / k1a_ms:.3f}x) "
          f"({card})")
    del periodic

    # host time per masked launch where the kernel is short: 256^2
    cavity = cavity_simulation(True)
    cparams = cavity._kernel_params
    unpacked = dict(cparams, table=tuple(cparams["table"]))
    cf = cavity.flow.f
    cout = torch.empty_like(cf)
    host_us = {}
    for name, kw in (("packed", cparams), ("unpacked", unpacked),
                     ("packed again", cparams)):
        sc.stream_collide(cf, **kw, out=cout)
        torch.cuda.synchronize()
        beg = time.perf_counter()
        for _ in range(2000):
            sc.stream_collide(cf, **kw, out=cout)
        host_us[name] = (time.perf_counter() - beg) / 2000 * 1e6
        torch.cuda.synchronize()
    step_us = cf[0].numel() / cavity(2000)  # cells / MLUPS
    print(f"phase 12: host us per masked launch at 256^2 (2000 launches): "
          f"{', '.join(f'{k} table {v:.2f}' for k, v in host_us.items())}; "
          f"cavity step through Simulation {step_us:.2f} us ({card})")
    del cavity, cf, cout

    # the obstacle step and its gradient under the profiler
    wall_step_ms = 1e3 / simulation(100) * f[0].numel() / 1e6
    profiled = profiled_device_ms(lambda: simulation(10))
    if profiled is None:
        print("phase 12: obstacle step device time not measured (the "
              "profiler saw no device activity)")
    else:
        device_ms, launches, by_name, _ = profiled
        print(f"phase 12: obstacle step under torch.profiler (10 steps): "
              f"{launches / 10:.1f} device launches and "
              f"{device_ms / 10:.4f} ms of device time per step, "
              f"kernels {by_name}; unprofiled wall "
              f"{wall_step_ms:.4f} ms per step: device idle "
              f"{1 - device_ms / 10 / wall_step_ms:.1%} ({card})")
    f0 = simulation.flow.f.detach().clone().requires_grad_(True)
    segment = simulation.make_segment_fn(SEGMENT_STEPS)

    def gradient():
        torch.autograd.grad((segment(f0) ** 2).sum(), f0)

    gradient()
    torch.cuda.synchronize()
    beg = time.perf_counter()
    for _ in range(3):
        gradient()
    torch.cuda.synchronize()
    wall_grad_ms = (time.perf_counter() - beg) / 3 * 1e3
    profiled = profiled_device_ms(gradient)
    if profiled is None:
        print("phase 12: gradient device time not measured")
    else:
        device_ms, launches, by_name, _ = profiled
        print(f"phase 12: {SEGMENT_STEPS}-step obstacle gradient under "
              f"torch.profiler: {launches} device launches, "
              f"{device_ms:.4f} ms of device time, kernels "
              f"{by_name}; unprofiled wall {wall_grad_ms:.4f} ms: device "
              f"idle {1 - device_ms / wall_grad_ms:.1%} ({card})")
    del simulation, f, out, f0, segment
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the collision-model path: the K1c fragments
# ----------------------------------------------------------------------
# the fragments of lettuce_tpu/ops/pallas/stream_collide.py::_make_collide
FRAGMENT_REPLACES = {
    "none": 520, "bgk_force": 592, "trt": 712, "reg": 747, "smag": 800,
    "mrt_from_feq": 866, "mrt_lallemand": 895, "mrt_dellar": 904,
    "mrt_hermite27": 912, "kbc": 997}
FRAGMENT_TAU = 0.6


def fragment_collisions(flow, tau):
    """One collision per K1c fragment compiled for the flow's stencil."""
    import lettuce_tpu_torch as lt
    stencil, context = flow.stencil, flow.context
    d = stencil.d
    out = {"none": lt.NoCollision(),
           "bgk_force": lt.BGKCollision(tau, force=lt.Guo(
               flow, tau, [1e-4, -5e-5, 2e-5][:d])),
           "trt": lt.TRTCollision(tau, 1.1),
           "reg": lt.RegularizedCollision(tau),
           "smag": lt.SmagorinskyCollision(tau)}
    if isinstance(stencil, lt.D2Q9):
        taus = [1.0, 1.0, 1.0, tau, tau, 1.2, 1.1, 1.1, 1.2]
        out["mrt_lallemand"] = lt.MRTCollision(
            lt.D2Q9Lallemand(stencil, context), taus, context)
        out["mrt_dellar"] = lt.MRTCollision(
            lt.D2Q9Dellar(stencil, context), taus, context)
    if isinstance(stencil, lt.D3Q19):
        out["mrt_from_feq"] = lt.MRTCollision(
            lt.D3Q19DHumieres(stencil, context),
            [1.0] * 3 + [1.1, tau] * 8, context)
    if isinstance(stencil, lt.D3Q27):
        out["mrt_hermite27"] = lt.MRTCollision(
            lt.D3Q27Hermite(stencil, context),
            [1.0] * 4 + [tau] * 6 + [1.2] * 17, context)
    if isinstance(stencil, (lt.D2Q9, lt.D3Q27)):
        out["kbc"] = lt.KBCCollision(tau)
    return out


def fragment_spec(flow, collision):
    """The packed collision spec the gate builds for ``collision``."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    spec, reason = sc.collision_spec_of(lt.Simulation(flow, collision, []))
    check(reason is None, f"no spec: {reason}")
    stencil = flow.stencil
    return sc.pack_spec(spec, stencil.e, stencil.w, stencil.opposite)


def _without_storage(counts):
    """``counts`` with float32 and float64 launches summed under one key
    without the storage suffix."""
    out = {}
    for key, n in counts.items():
        key = re.sub(r"_f(32|64)$", "", key)
        out[key] = out.get(key, 0) + n
    return out


def fragment_launches():
    """Single-step launches of the other fragments at float32 and float64,
    by variant and fragment ("trt", "masked_trt", "emit_u_trt", ...)."""
    return _without_storage(launched("K1", FULL_STORAGE, bgk=False))


def adjoint_fragment_launches():
    """Adjoint launches of the other specs at float32 and float64, by
    variant and spec ("trt", "masked_matvec", "frozen_none", ...)."""
    return _without_storage(launched("K3", FULL_STORAGE, bgk=False))


def phase13_fragments_vs_plain():
    """Every K1c instance (fragment x stencil x dtype, periodic and masked)
    against its plain version on the card at the grids of phase 2."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 300
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        for dtype in (torch.float32, torch.float64):
            context = lt.Context(device="cuda", dtype=dtype, use_native=False)
            flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                        stencil=stencil,
                                        initialize_fneq=False)
            for fragment, collision in fragment_collisions(
                    flow, FRAGMENT_TAU).items():
                spec = fragment_spec(flow, collision)
                args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                        None)
                errs = []
                for masked, steps in ((False, 1), (False, 3), (True, 2)):
                    seed += 1
                    # the TGV state with noise, masked or not: the masked
                    # cases take bounded_case's codes and frozen planes,
                    # but not its far-from-equilibrium populations, on
                    # which KBC's stabiliser is ill-conditioned in float32
                    f, _ = tgv_state(stencil, shape, dtype, seed)
                    masks = (bounded_case(stencil, shape, dtype, seed)[1]
                             if masked else {})
                    key = ("masked_" if masked else "") + fragment
                    before = fragment_launches().get(key, 0)
                    got = ref = f
                    for _ in range(steps):
                        got = sc.stream_collide(got, *args, **masks,
                                                collision_spec=spec)
                        ref = sc.stream_collide_plain(ref, *args, **masks,
                                                      collision_spec=spec)
                    torch.cuda.synchronize()
                    launched = fragment_launches().get(key, 0) - before
                    check(launched == steps,
                          f"{key} {name}: {launched} launches for {steps} "
                          f"steps")
                    check(bool(torch.isfinite(got).all()),
                          f"{key} {name} {dtype}: not finite")
                    err = (got - ref).abs().max().item()
                    check(err <= ATOL[dtype],
                          f"{key} {name} {dtype} {steps} steps: max error "
                          f"{err}")
                    errs.append(err)
                    worst[key] = max(worst.get(key, 0.0), err)
                print(f"phase 13: {fragment} {name} "
                      f"{'x'.join(map(str, shape))} {str(dtype)[6:]}: max "
                      f"|kernel - plain| periodic 1 step {errs[0]:.3e}, "
                      f"3 steps {errs[1]:.3e}, masked 2 steps {errs[2]:.3e} "
                      f"(atol {ATOL[dtype]:.0e})")
    return worst


def fragment_cells():
    """The JAX suite's fragment cells (benchmarks/run_benchmarks.py:
    129-171), uncut, float32: (name, fragment, flow factory, collision
    factory)."""
    import lettuce_tpu_torch as lt

    def tgv(stencil):
        def make(context):
            return lt.TaylorGreenVortex(context, 256, 1600, 0.05,
                                        stencil=stencil,
                                        initialize_fneq=False)
        return make

    def tau(flow):
        return flow.units.relaxation_parameter_lu

    def guo(flow):
        acc = flow.units.convert_acceleration_to_lu(flow.acceleration)
        return lt.BGKCollision(tau(flow), force=lt.Guo(flow, tau(flow), acc))

    return [
        ("kbc3d_256_d3q27", "kbc", tgv(lt.D3Q27()),
         lambda flow: lt.KBCCollision()),
        ("reg3d_256_d3q27", "reg", tgv(lt.D3Q27()),
         lambda flow: lt.RegularizedCollision(tau(flow))),
        ("mrt3d_256_d3q19", "mrt_from_feq", tgv(lt.D3Q19()),
         lambda flow: lt.MRTCollision(
             lt.D3Q19DHumieres(flow.stencil, flow.context),
             [tau(flow)] * 19, flow.context)),
        ("trt3d_256_d3q19", "trt", tgv(lt.D3Q19()),
         lambda flow: lt.TRTCollision(tau(flow))),
        ("smag3d_256_d3q19", "smag", tgv(lt.D3Q19()),
         lambda flow: lt.SmagorinskyCollision(tau(flow))),
        ("poiseuille2d_2048_guo", "masked_bgk_force",
         lambda context: lt.PoiseuilleFlow2D(context, 2048, 100, 0.05), guo),
    ]


def phase14_fragment_cells(card, saxpy_gbps):
    """Each fragment cell through Simulation.__call__ on 'cuda x1': 20
    warm-up and 100 timed steps, one launch per step, finite state, mass
    conserved; kernel vs plain at the cell's state; kernel and plain ms by
    CUDA events in turns; MLUPS and the share of the saxpy."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    results = {}
    for cell, key, make_flow, make_collision in fragment_cells():
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=True)
        flow = make_flow(context)
        simulation = lt.Simulation(flow, make_collision(flow), [])
        check(simulation.step_path == "cuda x1",
              f"{cell} runs {simulation.step_path!r}, not 'cuda x1'")
        params = simulation._kernel_params
        mass0 = torch.sum(flow.f, dtype=torch.float64).item()
        reset_launch_counts()
        simulation(20)
        mlups = simulation(100)
        torch.cuda.synchronize()
        launched = fragment_launches()
        check(launched == {key: 120} and launch_counts() == (0, 0, 0)
              and masked_launch_counts() == (0, 0, 0),
              f"{cell}: launches {launched} for 120 steps")
        check(bool(torch.isfinite(flow.f).all()), f"{cell}: not finite")
        drift = abs(torch.sum(flow.f, dtype=torch.float64).item() - mass0
                    ) / mass0
        check(drift < 1e-5, f"{cell}: mass drift {drift}")

        f = flow.f.clone()
        out = torch.empty_like(f)
        ref = sc.stream_collide_plain(f, **params)
        got = sc.stream_collide(f, **params, out=out)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(err <= ATOL[torch.float32], f"{cell} kernel vs plain: {err}")
        del ref
        kernel_ms, plain_ms, turns = time_in_turns(
            lambda: sc.stream_collide(f, **params, out=out),
            lambda: sc.stream_collide_plain(f, **params),
            kernel_repeats=50, plain_repeats=3)
        cells = f[0].numel()
        bytes_per_update = 2 * flow.stencil.q * 4
        gbps = bytes_per_update * cells / (kernel_ms * 1e-3) / 1e9
        print(f"phase 14: {cell} ({key}), {simulation.step_path}: "
              f"{mlups:.1f} MLUPS, mass drift {drift:.2e}; per step, CUDA "
              f"events: kernel {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"({cells / kernel_ms / 1e3:.1f} MLUPS), plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms "
              f"({plain_ms / kernel_ms:.1f}x); max |kernel - plain| "
              f"{err:.3e}; {bytes_per_update} B/update,"
              f" {gbps:.1f} GB/s, {gbps / saxpy_gbps:.1%} of the saxpy "
              f"({card})")
        results[key] = dict(cell=cell, mlups=mlups, launches=launched[key],
                            err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                            cells=cells, bytes=bytes_per_update
                            + (1 if key.startswith("masked_") else 0),
                            q=flow.stencil.q)
        del simulation, flow, f, out, got
        torch.cuda.empty_cache()
    return results


def phase15_tgv3d_kbc(card):
    """BASELINE config 3, the physics gate: D3Q27 KBC TGV at 256^3, Re
    1600 (2 pi), Ma 0.05, float32, to t = 10 with E and the enstrophy
    every ~0.05 time units, as benchmarks/validate_tgv3d.py runs it; the
    dissipation peaks against benchmarks/tgv3d_validation_kbc.json."""
    import lettuce_tpu_torch as lt
    with open("benchmarks/tgv3d_validation_kbc.json") as fh:
        reference = json.load(fh)
    context = lt.Context(device="cuda", dtype=torch.float32, use_native=True)
    flow = lt.TaylorGreenVortex(context, 256,
                                reynolds_number=1600 * 2 * np.pi,
                                mach_number=0.05, stencil=lt.D3Q27())
    simulation = lt.Simulation(flow, lt.KBCCollision(), [])
    check(simulation.step_path == "cuda x1",
          f"TGV3D KBC runs {simulation.step_path!r}")
    dt = flow.units.convert_time_to_pu(1)
    interval = max(1, int(round(0.05 / dt)))
    records = int(round(10.0 / dt)) // interval
    energy = lt.IncompressibleKineticEnergy(flow)
    enstrophy = lt.Enstrophy(flow)
    E, ens = [], []
    reset_launch_counts()
    beg = time.perf_counter()
    for _ in range(records):
        simulation(interval)
        E.append(energy().item())
        ens.append(enstrophy().item())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - beg
    steps = records * interval
    check(fragment_launches() == {"kbc": steps},
          f"TGV3D KBC launches {fragment_launches()} for {steps} steps")
    check(bool(torch.isfinite(flow.f).all()), "TGV3D KBC not finite")
    vol = (2 * np.pi) ** 3
    E = np.asarray(E) / vol
    t = np.arange(1, records + 1) * interval * dt
    eps = -np.gradient(E, t)
    eps_ens = (1.0 / 1600.0) * np.asarray(ens) / vol
    peaks = {"energy": (float(t[np.argmax(eps)]), float(eps.max()),
                        reference["t_peak"], reference["eps_peak"]),
             "enstrophy": (float(t[np.argmax(eps_ens)]),
                           float(eps_ens.max()),
                           reference["t_enstrophy_peak"],
                           reference["eps_enstrophy_peak"])}
    print(f"phase 15: TGV3D D3Q27 KBC 256^3 Re 1600 Ma 0.05 float32, "
          f"{steps} steps to t = {steps * dt:.3f} in {seconds:.1f} s "
          f"({steps * 256 ** 3 / seconds / 1e6:.1f} MLUPS with E and the "
          f"enstrophy every {interval} steps) ({card})")
    for name, (t_peak, eps_peak, t_ref, eps_ref) in peaks.items():
        print(f"phase 15: {name} dissipation peak {eps_peak:.5f} at t = "
              f"{t_peak:.3f}; lettuce_tpu's run {eps_ref} at {t_ref} "
              f"(gate: t within 0.15, value within 5%)")
        check(abs(t_peak - t_ref) <= 0.15,
              f"TGV3D {name} peak at {t_peak}, reference {t_ref}")
        check(abs(eps_peak / eps_ref - 1) <= 0.05,
              f"TGV3D {name} peak {eps_peak}, reference {eps_ref}")
    del simulation, flow
    torch.cuda.empty_cache()
    return peaks, seconds, steps


def phase16_poiseuille():
    """tests/test_force.py's Poiseuille gate through the masked forced-BGK
    kernel, Guo and Shan-Chen: 16^2, Re 1, Ma 0.02, float64 as that test
    runs it (the lattice acceleration, ~9e-9, is below float32's
    resolution of the populations), 500 steps, profile error under
    0.06."""
    import lettuce_tpu_torch as lt
    errors = {}
    for force_cls in (lt.Guo, lt.ShanChen):
        context = lt.Context(device="cuda", dtype=torch.float64,
                             use_native=True)
        flow = lt.PoiseuilleFlow2D(context, 16, 1, 0.02,
                                   initialize_with_zeros=True)
        acc = flow.units.convert_acceleration_to_lu(flow.acceleration)
        tau = flow.units.relaxation_parameter_lu
        simulation = lt.Simulation(flow, lt.BGKCollision(
            tau, force=force_cls(flow, tau, acc)), [])
        check(simulation.step_path == "cuda x1",
              f"Poiseuille {force_cls.__name__}: {simulation.step_path!r}")
        reset_launch_counts()
        simulation(500)
        check(fragment_launches() == {"masked_bgk_force": 500},
              f"Poiseuille launches {fragment_launches()}")
        u = flow.units.convert_velocity_to_pu(flow.u(acceleration=acc))
        u = u.cpu().numpy()[:, 1:-1, 1:-1]
        u_ref = flow.analytic_solution()[1].cpu().numpy()[:, 1:-1, 1:-1]
        err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        print(f"phase 16: Poiseuille 16^2 float64 {force_cls.__name__}, "
              f"{simulation.step_path}: 500 steps, profile error {err:.4f} "
              f"(gate 0.06)")
        check(err < 0.06, f"Poiseuille {force_cls.__name__}: {err}")
        errors[force_cls.__name__] = err
    return errors


def masked_sweep(card):
    """Each D2Q9 fragment on obstacle2d_2048 ('cuda+hybrid x1': masked
    kernel and replay) against the torch step over 4 steps; the D3Q19 and
    D3Q27 MRT fragments on a 3D obstacle (96x48x48) the same way. Then
    each masked kernel against its plain version on the state reached,
    both timed by CUDA events in turns."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    results = {}
    for shape in ((2048, 1024), (96, 48, 48)):
        stencils = ((lt.D2Q9(),) if len(shape) == 2
                    else (lt.D3Q19(), lt.D3Q27()))
        for stencil in stencils:
            def make(use_native):
                context = lt.Context(device="cuda", dtype=torch.float32,
                                     use_native=use_native)
                flow = lt.Obstacle(context, list(shape), reynolds_number=100,
                                   mach_number=0.1,
                                   domain_length_x=float(shape[0]),
                                   stencil=stencil)
                grid = flow.grid
                centre = [0.25 * shape[0]] + [0.5 * n for n in shape[1:]]
                r = 0.05 * shape[1]
                flow.mask = (sum((x - c) ** 2 for x, c in zip(grid, centre))
                             < r ** 2).cpu().numpy()
                flow.initialize()
                return flow
            probe = make(False)
            fragments = fragment_collisions(
                probe, probe.units.relaxation_parameter_lu)
            if len(shape) == 3:
                fragments = {k: v for k, v in fragments.items()
                             if k.startswith("mrt")}
            for fragment in fragments:
                sims = []
                for native in (True, False):
                    flow = make(native)
                    tau = flow.units.relaxation_parameter_lu
                    sims.append(lt.Simulation(
                        flow, fragment_collisions(flow, tau)[fragment], []))
                check(sims[0].step_path == "cuda+hybrid x1"
                      and sims[1].step_path == "torch x1",
                      f"{fragment} obstacle: {sims[0].step_path}, "
                      f"{sims[1].step_path}")
                reset_launch_counts()
                sims[0](4)
                key = f"masked_{fragment}"
                launched = fragment_launches()
                check(launched == {key: 4},
                      f"{fragment} obstacle launches {launched}")
                sims[1](4)
                err = (sims[0].flow.f - sims[1].flow.f).abs().max().item()
                check(err <= ATOL[torch.float32],
                      f"{fragment} obstacle: {err}")
                # the masked kernel alone against its plain version, on
                # this state, timed in turns
                params = sims[0]._kernel_params
                f = sims[0].flow.f.clone()
                out = torch.empty_like(f)
                err1 = (sc.stream_collide(f, **params, out=out)
                        - sc.stream_collide_plain(f, **params)
                        ).abs().max().item()
                check(err1 <= ATOL[torch.float32],
                      f"{fragment} masked kernel vs plain: {err1}")
                # ~0.07 ms kernels: 200 launches, as phase 10 times K1b
                kernel_ms, plain_ms, _ = time_in_turns(
                    lambda: sc.stream_collide(f, **params, out=out),
                    lambda: sc.stream_collide_plain(f, **params),
                    kernel_repeats=200, plain_repeats=3)
                print(f"phase 17: {fragment} obstacle "
                      f"{'x'.join(map(str, shape))} "
                      f"{type(stencil).__name__}: {sims[0].step_path} vs "
                      f"{sims[1].step_path} over 4 steps: {err:.3e}; masked "
                      f"kernel vs plain {err1:.3e} (atol 5e-6); kernel "
                      f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms per "
                      f"step ({card})")
                q = stencil.q
                results[key] = dict(launches=launched[key],
                                    err=max(err, err1), kernel_ms=kernel_ms,
                                    plain_ms=plain_ms, cells=f[0].numel(),
                                    bytes=2 * q * 4 + 1, q=q)
                del sims, f, out
                torch.cuda.empty_cache()
    return results


def probe_fragments():
    """The probe keeps the torch step, with its reason printed, for an MRT
    transform without a closed form (the stand-in for the cumulant
    collision, which the port does not have yet), Smagorinsky with a
    force and a per-node acceleration; a TRT state that requires grad runs
    the emit-u TRT fragment and the TRT adjoint (K3b) and prints nothing,
    and the forward outside autograd launches the TRT fragment."""
    import contextlib
    import io
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32, use_native=True)

    def probed(make_flow, make_collision):
        flow = make_flow()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            sim = lt.Simulation(flow, make_collision(flow), [])
        return sim, printed.getvalue().strip()

    def tgv3d():
        return lt.TaylorGreenVortex(context, 32, 1600, 0.05,
                                    stencil=lt.D3Q27(), initialize_fneq=False)

    def poiseuille():
        return lt.PoiseuilleFlow2D(context, 32, 10, 0.05)

    refused = {
        "MRT without a closed form": (tgv3d, lambda flow: lt.MRTCollision(
            lt.Transform(flow.stencil, context), [0.6] * 27, context),
            "no closed-form equilibrium"),
        "Smagorinsky with a force": (poiseuille, lambda flow: (
            lt.SmagorinskyCollision(0.6, force=lt.Guo(flow, 0.6,
                                                      [1e-4, 0.0]))),
            "with a force has no CUDA fragment"),
        "per-node acceleration": (poiseuille, lambda flow: lt.BGKCollision(
            0.6, force=lt.Guo(flow, 0.6, torch.full(
                (2, 32, 32), 1e-5, device="cuda"))),
            "per-node acceleration"),
    }
    for name, (make_flow, make_collision, reason) in refused.items():
        sim, printed = probed(make_flow, make_collision)
        print(f"phase 17: {name}: {sim.step_path} path, {printed!r}")
        check(sim.step_path == "torch x1" and reason in printed,
              f"{name}: the probe did not keep the torch step with its "
              f"reason")
        sim(2)
        check(bool(torch.isfinite(sim.flow.f).all()), f"{name}: not finite")

    sim, _ = probed(tgv3d, lambda flow: lt.TRTCollision(0.6, 1.1))
    check(sim.step_path == "cuda x1" and sim.adjoint_mode == "full",
          f"TRT: {sim.step_path}, {sim.adjoint_mode}")
    f0 = sim.flow.f.detach().clone().requires_grad_(True)
    printed = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        segment = sim.make_segment_fn(3)
        (grad,) = torch.autograd.grad((segment(f0) ** 2).sum(), f0)
    torch.cuda.synchronize()
    grad_launches = (launch_counts(), masked_launch_counts(),
                     fragment_launches(), adjoint_fragment_launches())
    check(grad_launches == ((0, 0, 0), (0, 0, 0), {"emit_u_trt": 3},
                            {"trt": 3}),
          f"TRT gradient launches: {grad_launches}")
    check(bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0,
          "TRT gradient not finite or zero")
    reason = printed.getvalue().strip()
    check(reason == "", f"TRT gradient printed {reason!r}")
    reset_launch_counts()
    sim(3)
    check(fragment_launches() == {"trt": 3},
          f"TRT forward launches {fragment_launches()}")
    print(f"phase 17: TRT with a state that requires grad: launches "
          f"(BGK periodic, BGK masked, fragments, fragment adjoints) "
          f"{grad_launches}, nothing printed; the forward outside autograd "
          f"launched {fragment_launches()}")


def phase17_probe_and_masked(card):
    results = masked_sweep(card)
    probe_fragments()
    return results


def phase18_decaying_turbulence(card):
    """BASELINE config 4 on one card: decaying turbulence, D3Q19
    Smagorinsky at 256^3 (initialize_pressure=False), float32: the kernel
    path against the torch step over 4 steps, then 20 steps losing
    kinetic energy monotonically."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32, use_native=True)
    beg = time.perf_counter()
    flow = lt.DecayingTurbulence(context, [256] * 3, 2000, 0.05,
                                 stencil=lt.D3Q19(), randseed=0,
                                 initialize_pressure=False)
    setup = time.perf_counter() - beg
    simulation = lt.Simulation(flow, lt.SmagorinskyCollision(
        flow.units.relaxation_parameter_lu), [])
    check(simulation.step_path == "cuda x1",
          f"decaying turbulence runs {simulation.step_path!r}")
    ref = flow.f
    with torch.no_grad():
        for _ in range(4):
            ref = simulation._torch_step(ref)
    energy = lt.IncompressibleKineticEnergy(flow)
    energies = [energy().item()]
    reset_launch_counts()
    simulation(4)
    err = (flow.f - ref).abs().max().item()
    del ref
    check(err <= ATOL[torch.float32],
          f"decaying turbulence kernel vs torch step: {err}")
    energies.append(energy().item())
    for _ in range(16):
        simulation(1)
        energies.append(energy().item())
    check(fragment_launches() == {"smag": 20},
          f"decaying turbulence launches {fragment_launches()}")
    check(all(b < a for a, b in zip(energies, energies[1:])),
          f"energy not monotonically decreasing: {energies}")
    print(f"phase 18: decaying turbulence D3Q19 Smagorinsky 256^3 float32 "
          f"(set-up {setup:.1f} s), {simulation.step_path}: kernel vs torch "
          f"step over 4 steps {err:.3e} (atol 5e-6); kinetic energy "
          f"{energies[0]:.6e} -> {energies[-1]:.6e} over 20 steps, "
          f"monotone ({card})")
    del simulation, flow
    torch.cuda.empty_cache()
    return err


# ----------------------------------------------------------------------
# the gradients of the collision fragments: the emit-u fragment instances
# (K1d), their adjoints (K3b) and split mode (K3d)
# ----------------------------------------------------------------------
ADJOINT_FRAGMENTS_SOURCE = "lettuce_tpu_torch/csrc/adjoint_fragments.cu"
# the adjoint specs of lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel
ADJOINT_SPEC_REPLACES = {"none": 257, "smag": 299, "trt": 423, "matvec": 434}
# the emit-u body of the TPU kernel, fragment-independent
EMIT_U_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1535"


def perturbed(f, seed, rel=1e-2):
    """``f`` times (1 + rel U(-1, 1)), seeded numpy noise: off equilibrium,
    where KBC's guard is no subgradient choice (phase 13's reason)."""
    noise = np.random.default_rng(seed).uniform(-1, 1, tuple(f.shape))
    return (f * (1 + rel * torch.as_tensor(noise, dtype=f.dtype,
                                           device=f.device))).contiguous()


def adjoint_key(spec):
    """The fragment-adjoint counter key of a spec's backward kernel (split
    mode: the identity's)."""
    return "none" if spec.mode == "split" else spec.adjoint[0]


def phase19_gradient_instances_vs_plain():
    """Every new instance against its plain version at the grids of phase
    2, float32 to 5e-6 and float64 to 1e-12 (adjoints scaled by the
    plain's largest magnitude): the emit-u instances of trt, reg and
    mrt_from_feq, periodic and masked (phase 9's codes and frozen planes);
    the adjoint of every full-mode spec (trt, matvec for reg and
    mrt_from_feq, smag, none) periodic, masked and with the no-streaming
    mask alone (the nsm-only entry split mode runs), and BGK's nsm-only
    path. One launch each."""
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 400
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        d = stencil.d
        args = (stencil.e, stencil.w, stencil.opposite, stencil.cs, None)
        for dtype in (torch.float32, torch.float64):
            context = lt.Context(device="cuda", dtype=dtype, use_native=False)
            flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                        stencil=stencil,
                                        initialize_fneq=False)
            collisions = fragment_collisions(flow, FRAGMENT_TAU)
            collisions["bgk"] = lt.BGKCollision(FRAGMENT_TAU)
            for fragment, collision in collisions.items():
                spec = fragment_spec(flow, collision)
                if spec.mode == "split":
                    continue  # K1c forward (phase 13), the none adjoint here
                seed += 1
                f, _ = tgv_state(stencil, shape, dtype, seed)
                masks = bounded_case(stencil, shape, dtype, seed)[1]
                g = torch.as_tensor(np.random.default_rng(seed)
                                    .standard_normal(tuple(f.shape)),
                                    dtype=dtype, device="cuda")
                errs = []
                if fragment in ("trt", "reg", "mrt_from_feq"):
                    for variant, mk in (("emit_u_", {}),
                                        ("masked_emit_u_", masks)):
                        key = variant + fragment
                        u = torch.empty((d, *shape), dtype=dtype,
                                        device="cuda")
                        before = fragment_launches().get(key, 0)
                        out, _ = sc.stream_collide(f, *args, **mk, u_out=u,
                                                   collision_spec=spec)
                        torch.cuda.synchronize()
                        launched = fragment_launches().get(key, 0) - before
                        ref, u_ref = sc.stream_collide_plain(
                            f, *args, **mk, collision_spec=spec, emit_u=True)
                        err = max((out - ref).abs().max().item(),
                                  (u - u_ref).abs().max().item())
                        check(launched == 1, f"{key} {name}: {launched} "
                                             f"launches")
                        check(bool(torch.isfinite(out).all()
                                   and torch.isfinite(u).all()),
                              f"{key} {name} {dtype}: not finite")
                        check(err <= ATOL[dtype],
                              f"{key} {name} {dtype}: max error {err}")
                        worst[key] = max(worst.get(key, 0.0), err)
                        errs.append(f"{variant}fwd {err:.2e}")
                _, u = sc.stream_collide_plain(f, *args, collision_spec=spec,
                                               emit_u=True) \
                    if spec.residual == "u" else (None, None)
                res = {"u": u, "f": f, None: None}[spec.residual]
                kind = spec.adjoint[0]
                for variant, mk in (("", {}), ("masked_", masks),
                                    ("frozen_", {"nsm": masks["nsm"]})):
                    if kind == "bgk" and variant != "frozen_":
                        continue  # phases 6 and 9
                    key = variant + kind
                    before = (adjoint_fragment_launches().get(key, 0),
                              masked_launch_counts()[2])
                    ct = adjoint.stream_collide_adjoint(g, res, *args, **mk,
                                                        collision_spec=spec)
                    torch.cuda.synchronize()
                    after = (adjoint_fragment_launches().get(key, 0),
                             masked_launch_counts()[2])
                    launched = after[kind == "bgk"] - before[kind == "bgk"]
                    ref = adjoint.stream_collide_adjoint_plain(
                        g, res, *args, **mk, collision_spec=spec)
                    err, scale = scaled_err(ct, ref)
                    check(launched == 1, f"adjoint {key} {name}: {launched} "
                                         f"launches")
                    check(bool(torch.isfinite(ct).all()),
                          f"adjoint {key} {name} {dtype}: not finite")
                    check(err <= GRAD_RTOL[dtype] * scale,
                          f"adjoint {key} ({fragment}) {name} {dtype}: "
                          f"{err} of {scale}")
                    worst["adjoint_" + key] = max(
                        worst.get("adjoint_" + key, 0.0), err)
                    errs.append(f"adjoint {variant or 'periodic_'}{kind} "
                                f"{err / scale:.2e}")
                print(f"phase 19: {fragment} {name} "
                      f"{'x'.join(map(str, shape))} {str(dtype)[6:]}: "
                      f"{', '.join(errs)} (atol {ATOL[dtype]:.0e}; adjoints "
                      f"relative, rtol {GRAD_RTOL[dtype]:.0e})")
    return worst


def gradient_cells():
    """The gradient cells, uncut, float32: (cell, flow factory, collision
    factory, mode). The full-mode cells are the fragment cells of
    benchmarks/run_benchmarks.py:129-171 and bench_adjoint.py's
    smagorinsky_d3q19; the split-mode ones bench_adjoint.py:102-126's."""
    import lettuce_tpu_torch as lt
    by_name = {cell: (make_flow, make_collision)
               for cell, _, make_flow, make_collision in fragment_cells()}

    def tgv(stencil, n):
        def make(context):
            return lt.TaylorGreenVortex(context, n, 1600, 0.05,
                                        stencil=stencil,
                                        initialize_fneq=False)
        return make

    def tau(flow):
        return flow.units.relaxation_parameter_lu

    return [
        ("trt3d_256_d3q19", *by_name["trt3d_256_d3q19"], "full"),
        ("mrt3d_256_d3q19", *by_name["mrt3d_256_d3q19"], "full"),
        ("reg3d_256_d3q27", *by_name["reg3d_256_d3q27"], "full"),
        ("smagorinsky_d3q19", tgv(lt.D3Q19(), 256),
         lambda flow: lt.SmagorinskyCollision(tau(flow)), "full"),
        ("kbc_d3q27", tgv(lt.D3Q27(), 128),
         lambda flow: lt.KBCCollision(tau(flow)), "split"),
        ("mrt_lallemand_d2q9", tgv(lt.D2Q9(), [2048, 2048]),
         lambda flow: lt.MRTCollision(
             lt.D2Q9Lallemand(flow.stencil, flow.context), [1.1] * 9,
             flow.context), "split"),
        ("bgk_guo_d2q9", tgv(lt.D2Q9(), [2048, 2048]),
         lambda flow: lt.BGKCollision(0.8, force=lt.Guo(flow, 0.8,
                                                        [1e-5, 0.0])),
         "split"),
    ]


def kernel_pair(params, f, g):
    """The step's forward and adjoint kernels as the Function runs them
    (emit-u or primal; the spec's adjoint, or split mode's streaming
    transpose), their plain versions, and split mode's pointwise VJP:
    (forward, forward plain, adjoint, adjoint plain, prestream VJP or
    None, residual). Outputs go to preallocated buffers."""
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    spec = params["collision_spec"]
    out = torch.empty_like(f)
    ct = torch.empty_like(f)
    if spec.residual == "u":
        d = np.asarray(params["e"]).shape[1]
        # u in the compute type: float32 for a 16-bit state
        res = torch.empty((d, *f.shape[1:]), dtype=torch.float64
                          if f.dtype == torch.float64 else torch.float32,
                          device=f.device)
        sc.stream_collide(f, **params, out=out, u_out=res)

        def forward():
            sc.stream_collide(f, **params, out=out, u_out=res)

        def forward_plain():
            return sc.stream_collide_plain(f, **params, emit_u=True)
    else:
        res = f if spec.residual == "f" else None

        def forward():
            sc.stream_collide(f, **params, out=out)

        def forward_plain():
            return sc.stream_collide_plain(f, **params)
    if spec.mode == "full":
        def backward():
            adjoint.stream_collide_adjoint(g, res, **params, out=ct)

        def backward_plain():
            return adjoint.stream_collide_adjoint_plain(g, res, **params)
        vjp = None
    else:
        streaming = dict(e=params["e"], w=params["w"],
                         opposite=params["opposite"], cs=params["cs"],
                         tau_inv=None, nsm=params.get("nsm"),
                         collision_spec=adjoint.NONE_SPEC)

        def backward():
            adjoint.stream_collide_adjoint(g, None, **streaming, out=ct)

        def backward_plain():
            return adjoint.stream_collide_adjoint_plain(g, None, **streaming)

        def vjp():
            adjoint.prestream_vjp(
                f, ct, e=params["e"], w=params["w"],
                opposite=params["opposite"], cs=params["cs"],
                collision_spec=spec, ncm=params.get("ncm"),
                table=params.get("table"),
                feq_field=params.get("feq_field"))
    return forward, forward_plain, backward, backward_plain, vjp, out, ct, res


def torch_step_gradient(simulation, f0, steps):
    """The gradient of sum(f_n^2) by autograd of the simulation's torch
    step, linearised along the kernel path's own trajectory f_0 .. f_n:
    the VJP of the torch step at each f_i, chained backwards. Along the
    torch step's own trajectory instead, float32 roundoff in the forward
    moves the states by ~1e-7, and where the Jacobian is ill-conditioned
    (KBC's entropic stabiliser: in float32 the torch step's own gradient
    is ~1e-3 from its float64 gradient on the CPU) that difference, not
    the backward, would dominate; the forward kernels are held to their
    plain versions in phases 13, 14 and 19."""
    step = simulation.make_step_fn()
    states = [f0.detach()]
    with torch.no_grad():
        for _ in range(steps):
            states.append(step(states[-1]))
    ct = 2 * states.pop()
    for x in reversed(states):
        x = x.clone().requires_grad_(True)
        (ct,) = torch.autograd.grad(simulation._torch_step(x), x, ct)
    return ct


def gradient_cell(card, saxpy_gbps, cell, simulation, seed, repeats,
                  reference_steps):
    """One gradient cell: the 8-step gradient through make_segment_fn with
    its launch counts, the gradient over ``reference_steps`` against
    autograd of the torch step (torch_step_gradient), fwd+bwd MLUPS (3
    repeats after a warm-up), and per launch the forward and adjoint
    kernels against their plain versions by CUDA events, in turns."""
    flow = simulation.flow
    params = simulation._kernel_params
    spec = params["collision_spec"]
    masked = params.get("ncm") is not None
    variant = "masked_" if masked else ""
    fwd_key = variant + ("emit_u_" if spec.residual == "u" else "") \
        + spec.fragment
    adj_key = variant * (spec.mode == "full") + adjoint_key(spec)
    f0 = perturbed(flow.f.detach(), seed).requires_grad_(True)
    cells = f0[0].numel()

    def grad_of(seg, x=f0):
        (grad,) = torch.autograd.grad((seg(x) ** 2).sum(), x)
        return grad

    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    reset_launch_counts()
    grad = grad_of(segment)
    torch.cuda.synchronize()
    launches = (fragment_launches(), adjoint_fragment_launches())
    check(launches == ({fwd_key: SEGMENT_STEPS}, {adj_key: SEGMENT_STEPS})
          and launch_counts() == (0, 0, 0)
          and masked_launch_counts() == (0, 0, 0),
          f"{cell}: launches {launches} for an {SEGMENT_STEPS}-step gradient")
    check(bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0,
          f"{cell}: gradient not finite or zero")
    del grad
    # the gradient against autograd of the torch step
    got = grad_of(simulation.make_segment_fn(reference_steps))
    ref = torch_step_gradient(simulation, f0, reference_steps)
    err_g, scale_g = scaled_err(got, ref)
    del got, ref
    torch.cuda.empty_cache()
    check(err_g <= GRAD_RTOL[torch.float32] * scale_g,
          f"{cell}: gradient vs autograd of the torch step {err_g} of "
          f"{scale_g}")
    # fwd+bwd MLUPS
    grad_of(segment)
    torch.cuda.synchronize()
    beg = time.perf_counter()
    for _ in range(3):
        grad_of(segment)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / 3
    mlups = cells * SEGMENT_STEPS / seconds / 1e6
    torch.cuda.empty_cache()
    # the kernels per launch against their plain versions, on the
    # perturbed state; KBC on the flow's own state: its stabiliser's guard
    # (gamma -> 2 below 1e-15) is a jump, random noise puts some cell at
    # gamma ~ 0, and float32 roundoff there moves a population by
    # 2 beta dh (5.9e-4 on the obstacle with 1 % noise)
    f = (flow.f if spec.fragment == "kbc" else f0).detach().contiguous()
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        tuple(f.shape)), dtype=f.dtype, device="cuda")
    (forward, forward_plain, backward, backward_plain, vjp, out, ct,
     res) = kernel_pair(params, f, g)
    forward()
    ref = forward_plain()
    torch.cuda.synchronize()
    if spec.residual == "u":
        ref, ref_u = ref
        err_f = max((out - ref).abs().max().item(),
                    (res - ref_u).abs().max().item())
        del ref_u
    else:
        err_f = (out - ref).abs().max().item()
    del ref
    backward()
    ref = backward_plain()
    torch.cuda.synchronize()
    err_a, scale_a = scaled_err(ct, ref)
    del ref
    torch.cuda.empty_cache()
    check(err_f <= ATOL[torch.float32], f"{cell} forward kernel vs plain: "
                                        f"{err_f}")
    check(err_a <= GRAD_RTOL[torch.float32] * scale_a,
          f"{cell} adjoint kernel vs plain: {err_a} of {scale_a}")
    fwd_ms, fwd_plain_ms, fwd_turns = time_in_turns(
        forward, forward_plain, kernel_repeats=repeats, plain_repeats=2)
    adj_ms, adj_plain_ms, adj_turns = time_in_turns(
        backward, backward_plain, kernel_repeats=repeats, plain_repeats=2)
    vjp_ms = None if vjp is None else cuda_ms(vjp, 3)
    q, d = np.asarray(params["e"]).shape
    code = 1 if masked else 0
    fwd_bytes = (2 * q + (d if spec.residual == "u" else 0)) * 4 + code
    # split mode's streaming transpose reads no code and no residual
    adj_bytes = ((2 * q + {"u": d, "f": q, None: 0}[spec.residual]) * 4
                 + code if spec.mode == "full" else 2 * q * 4)
    print(f"phase {20 if not masked else 21}: {cell} ({spec.mode} mode, "
          f"{fwd_key} + {adj_key}), {simulation.step_path}: "
          f"{SEGMENT_STEPS}-step gradient launches {launches}; "
          f"{reference_steps}-step gradient vs autograd of the torch step "
          f"along the kernels' trajectory "
          f"{err_g:.3e} of {scale_g:.3e} ({err_g / scale_g:.2e}, rtol 1e-5); "
          f"fwd+bwd {mlups:.1f} MLUPS ({seconds * 1e3:.2f} ms per gradient); "
          f"per launch, CUDA events: forward {fwd_turns[1]:.4f} / "
          f"{fwd_turns[2]:.4f} ms (plain {fwd_turns[0]:.4f} / "
          f"{fwd_turns[3]:.4f}; {fwd_bytes} B/update, "
          f"{fwd_bytes * cells / fwd_ms / 1e6 / saxpy_gbps:.1%} of the "
          f"saxpy), adjoint {adj_turns[1]:.4f} / {adj_turns[2]:.4f} ms "
          f"(plain {adj_turns[0]:.4f} / {adj_turns[3]:.4f}; {adj_bytes} "
          f"B/update, {adj_bytes * cells / adj_ms / 1e6 / saxpy_gbps:.1%} "
          f"of the saxpy)"
          + ("" if vjp_ms is None else
             f", split mode's pointwise VJP in torch {vjp_ms:.4f} ms")
          + f"; kernel vs plain: forward {err_f:.3e}, adjoint "
          f"{err_a / scale_a:.2e} relative ({card})")
    del f0, f, g, out, ct, res, segment
    torch.cuda.empty_cache()
    fragment = spec.fragment
    forward_entry = dict(
        key=fwd_key, launches=SEGMENT_STEPS, err=err_f, ms=fwd_ms,
        plain_ms=fwd_plain_ms, cells=cells, bytes=fwd_bytes,
        ops=q * OPS_PER_POPULATION["emit_u" if spec.residual == "u"
                                   and fragment == "bgk" else fragment],
        fragment=fragment, emit_u=spec.residual == "u")
    adjoint_entry = dict(
        key=adj_key, launches=SEGMENT_STEPS, err=err_a, ms=adj_ms,
        plain_ms=adj_plain_ms, cells=cells, bytes=adj_bytes,
        ops=q * OPS_PER_POPULATION["adjoint_" + adjoint_key(spec)],
        spec=adjoint_key(spec))
    return dict(cell=cell, mode=spec.mode, mlups=mlups, err=err_g,
                scale=scale_g, forward=forward_entry, adjoint=adjoint_entry,
                vjp_ms=vjp_ms)


def phase20_gradient_cells(card, saxpy_gbps):
    """The gradient cells at full width (gradient_cells): each through
    Simulation.make_segment_fn(8) with 8 forward fragment launches and 8
    adjoint launches, the gradient over 2 steps against autograd of the
    torch step, fwd+bwd MLUPS, and both kernels per launch."""
    import lettuce_tpu_torch as lt
    results = []
    for seed, (cell, make_flow, make_collision, mode) in enumerate(
            gradient_cells(), start=500):
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=True)
        flow = make_flow(context)
        simulation = lt.Simulation(flow, make_collision(flow), [])
        check(simulation.step_path == "cuda x1"
              and simulation.adjoint_mode == mode,
              f"{cell}: {simulation.step_path!r}, {simulation.adjoint_mode}")
        results.append(gradient_cell(card, saxpy_gbps, cell, simulation,
                                     seed, repeats=20, reference_steps=2))
        del simulation, flow
        torch.cuda.empty_cache()
    return results


def phase21_obstacle_gradients(card, saxpy_gbps):
    """obstacle2d_2048 through the masked kernels and the replay with the
    regularized collision (full mode: masked emit-u reg, masked matvec
    adjoint) and with KBC (split mode: masked kbc, the streaming
    transpose, the pointwise VJP): the 8-step gradient against autograd of
    the torch step, and both kernels per launch."""
    import lettuce_tpu_torch as lt
    results = []
    for seed, (cell, make_collision, mode) in enumerate((
            ("obstacle2d_2048_reg",
             lambda flow: lt.RegularizedCollision(
                 flow.units.relaxation_parameter_lu), "full"),
            ("obstacle2d_2048_kbc",
             lambda flow: lt.KBCCollision(
                 flow.units.relaxation_parameter_lu), "split")), start=600):
        simulation = obstacle_simulation(True, make_collision=make_collision)
        check(simulation.step_path == "cuda+hybrid x1"
              and simulation.adjoint_mode == mode,
              f"{cell}: {simulation.step_path}, {simulation.adjoint_mode}")
        results.append(gradient_cell(card, saxpy_gbps, cell, simulation,
                                     seed, repeats=200,
                                     reference_steps=SEGMENT_STEPS))
        del simulation
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# 16-bit storage: bfloat16 deviations (K1e) and 16-bit states (K1f)
# ----------------------------------------------------------------------
# the 16-bit instances of every forward fragment, computing in float32:
# csrc/half_storage.cuh and csrc/half_*.cu
HALF_STORAGE_SOURCE = "lettuce_tpu_torch/csrc/half_storage.cuh"
# the deviation-storage paths of the TPU kernel (_moments :1260) and its
# 16-bit state (:1492)
DEV_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1260"
HALF_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1492"
# (state dtype, deviation storage) of each storage suffix
HALF_STORAGES = {"bf16_dev": (torch.bfloat16, True),
                 "bf16": (torch.bfloat16, False),
                 "f16": (torch.float16, False)}
HALF_KEYS = {torch.bfloat16: "bf16", torch.float16: "f16"}
# one ulp of each 16-bit type at a magnitude in [2^k, 2^(k+1)): 2^(k - m)
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}
# deviation storage rebuilds each population as g + w_q in float32 before
# the collision (csrc/half_storage.cuh); the plain version decodes in
# float64. Near a deviation's zero crossing the kernel's float32 roundoff
# of a population (a few ulps of 2^-25) exceeds a bf16 ulp of the
# deviation, so deviation storage adds this floor to one ulp.
DEV_FLOOR = 2.0 ** -23
# KBC's stabiliser amplifies that roundoff in the cells next to the
# boundary codes, far from equilibrium (phase 13's reason), past that
# floor on the masked trajectories. KBC takes this floor, below phase
# 13's float32 ATOL.
KBC_DEV_FLOOR = 2.0 ** -19
# D3Q19 in 16 bits: q populations in and out, 2 bytes each
HALF_BYTES_PER_UPDATE = 19 * 2 * 2


def half_launches():
    """Single-step launches at 16 bits, BGK included ("bgk_bf16_dev",
    "masked_trt_f16", "emit_u_bgk_bf16", ...)."""
    return launched("K1", HALF_STORAGE)


def storage_state(f32, w, storage):
    """A float32 state (or per-node field) in the 16-bit storage."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    dtype, dev = HALF_STORAGES[storage]
    return sc.encode_deviations(f32, w) if dev else f32.to(dtype)


def storage_ulps(got, ref, floor=DEV_FLOOR):
    """(the worst |got - ref| in ulps of the storage type at the larger
    magnitude, the same with ``floor`` added to the ulp, the fraction of
    entries that differ at all)."""
    a, b = got.double(), ref.double()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - MANTISSA_BITS[got.dtype])
    if got.dtype == torch.float16:
        ulp = ulp.clamp_min(2.0 ** -24)  # float16's least subnormal
    err = (a - b).abs()
    return ((err / ulp).max().item(), (err / (ulp + floor)).max().item(),
            (err > 0).double().mean().item())


def check_storage(got, ref, storage, what, floor=DEV_FLOOR):
    """One storage ulp entrywise (deviations: plus ``floor``); returns
    (worst ulps, fraction differing, max |got - ref|)."""
    worst, worst_floored, differ = storage_ulps(got, ref, floor)
    limit = worst_floored if storage == "bf16_dev" else worst
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    check(limit <= 1.0, f"{what}: {worst:.2f} ulps ({worst_floored:.2f} "
                        f"with the floor)")
    return worst, differ, (got.double() - ref.double()).abs().max().item()


def phase22_half_instances_vs_plain():
    """Every 16-bit instance (bf16-dev, bf16, f16; BGK and every K1c
    fragment) against its plain version at the grids of phase 2: periodic
    and masked (phase 9's codes, frozen planes), 3 steps from the TGV
    state, each step from the plain state of the step before (a one-ulp
    rounding difference would carry into the next input); steps 1 and 3
    within one storage ulp entrywise; launches equal steps."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 700
    count = 0
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=False)
        flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                    stencil=stencil, initialize_fneq=False)
        collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                      **fragment_collisions(flow, FRAGMENT_TAU)}
        for fragment, collision in collisions.items():
            spec = fragment_spec(flow, collision)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    spec[1] if fragment == "bgk" else None)
            line = []
            for storage, (dtype, dev) in HALF_STORAGES.items():
                if dev and fragment in sc.DEV_REFUSED:
                    continue
                readings, most = [], 0.0
                for masked in (False, True):
                    seed += 1
                    f32, _ = tgv_state(stencil, shape, torch.float32, seed)
                    masks = {}
                    if masked:
                        masks = bounded_case(stencil, shape, torch.float32,
                                             seed)[1]
                        masks["feq_field"] = storage_state(
                            masks["feq_field"], stencil.w, storage)
                    key = (("masked_" if masked else "") + fragment
                           + "_" + storage)
                    before = half_launches().get(key, 0)
                    x = storage_state(f32, stencil.w, storage)
                    for step in (1, 2, 3):
                        got = sc.stream_collide(x, *args, **masks,
                                                collision_spec=spec,
                                                dev_storage=dev)
                        ref = sc.stream_collide_plain(x, *args, **masks,
                                                      collision_spec=spec,
                                                      dev_storage=dev)
                        torch.cuda.synchronize()
                        check(got.dtype == dtype, f"{key}: {got.dtype}")
                        ulps, differ, err = check_storage(
                            got, ref, storage, f"{key} {name} step {step}",
                            KBC_DEV_FLOOR if fragment == "kbc"
                            else DEV_FLOOR)
                        if step != 2:
                            readings.append(f"{ulps:.1f}")
                            most = max(most, differ)
                        w_ulps, w_err = worst.get(key, (0.0, 0.0))
                        worst[key] = (max(w_ulps, ulps), max(w_err, err))
                        x = ref
                    launched = half_launches().get(key, 0) - before
                    check(launched == 3, f"{key} {name}: {launched} "
                                         f"launches for 3 steps")
                    count += 1
                line.append(f"{storage} {'/'.join(readings)} ulps, "
                            f"{most:.1e} differ")
            print(f"phase 22: {fragment} {name} {'x'.join(map(str, shape))}"
                  f" (periodic 1/3, masked 1/3 steps): " + "; ".join(line))
    print(f"phase 22: {count} runs of 3 steps, worst "
          f"{max(u for u, _ in worst.values()):.2f} ulps (deviations: one "
          f"bf16 ulp + {DEV_FLOOR:.2e}, KBC + {KBC_DEV_FLOOR:.2e})")
    return worst


def tgv256(context, half_storage=False, stencil=None):
    """The main path's flow and Simulation (bench.py:60-73): D3Q19 BGK TGV
    256^3, Re 1600, Ma 0.05, no f_neq."""
    import lettuce_tpu_torch as lt
    flow = lt.TaylorGreenVortex(context, 256, 1600, 0.05,
                                stencil=stencil or lt.D3Q19(),
                                initialize_fneq=False)
    return lt.Simulation(
        flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu), [],
        half_storage=half_storage)


def half_kernel_timing(simulation, plain_repeats=3, kernel_repeats=200,
                       floor=DEV_FLOOR):
    """(kernel ms, plain ms, the four readings, max |kernel - plain|) of
    the simulation's deviation kernel at its own encoded state, by CUDA
    events in turns; one storage ulp checked."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    params = simulation._half_params
    g = simulation._encode(simulation.flow.f)
    out = torch.empty_like(g)
    ref = sc.stream_collide_plain(g, **params)
    got = sc.stream_collide(g, **params, out=out)
    torch.cuda.synchronize()
    _, _, err = check_storage(got, ref, "bf16_dev",
                              f"{simulation.step_path} deviations", floor)
    del ref
    buffers = [g, out]

    def kernel():
        sc.stream_collide(buffers[0], **params, out=buffers[1])
        buffers.reverse()

    kernel_ms, plain_ms, turns = time_in_turns(
        kernel, lambda: sc.stream_collide_plain(g, **params),
        kernel_repeats=kernel_repeats, plain_repeats=plain_repeats)
    return kernel_ms, plain_ms, turns, err


def phase23_half_main_path(card, saxpy_gbps):
    """The main path under half storage: D3Q19 BGK TGV 256^3 through
    Simulation(half_storage=True), 20 + 200 steps, one bf16-dev launch per
    step; finite, mass conserved; u after 10 steps against the float32
    kernel path's; MLUPS, kernel and plain ms by CUDA events in turns, GB/s
    at 76 B per update and the share of phase 5's saxpy; rollout(20) ends
    bitwise where simulation(20) does."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=True)
    simulation = tgv256(context, half_storage=True)
    check(simulation.step_path == "cuda x1"
          and simulation.half_storage_engaged,
          f"half main path: {simulation.step_path}, engaged "
          f"{simulation.half_storage_engaged}")
    flow = simulation.flow
    mass0 = torch.sum(flow.f, dtype=torch.float64).item()

    reset_launch_counts()
    simulation(20)
    mlups = simulation(200)
    torch.cuda.synchronize()
    launched = half_launches()
    check(launched == {"bgk_bf16_dev": 220}
          and launch_counts() == (0, 0, 0) and not fragment_launches(),
          f"half main path launches {launched}, {launch_counts()}")
    check(flow.f.dtype == torch.float32
          and bool(torch.isfinite(flow.f).all()), "half state not finite")
    drift = abs(torch.sum(flow.f, dtype=torch.float64).item() - mass0
                ) / mass0
    check(drift < 1e-4, f"half main path mass drift {drift}")
    kernel_ms, plain_ms, turns, err = half_kernel_timing(simulation)
    cells = 256 ** 3
    gbps = HALF_BYTES_PER_UPDATE * cells / (kernel_ms * 1e-3) / 1e9
    print(f"phase 23: D3Q19 BGK TGV 256^3 half storage (bf16 deviations), "
          f"{simulation.step_path}: {mlups:.1f} MLUPS, 220 launches, mass "
          f"drift {drift:.2e}; per step, CUDA events: kernel "
          f"{turns[1]:.4f} / {turns[2]:.4f} ms "
          f"({cells / kernel_ms / 1e3:.1f} MLUPS), plain {turns[0]:.4f} / "
          f"{turns[3]:.4f} ms; max |kernel - plain| {err:.3e}; "
          f"{HALF_BYTES_PER_UPDATE} B/update, {gbps:.1f} GB/s, "
          f"{gbps / saxpy_gbps:.1%} of the saxpy ({card})")
    del simulation, flow
    torch.cuda.empty_cache()

    # u after 10 steps against the float32 kernel path
    u = []
    for half in (False, True):
        simulation = tgv256(context, half_storage=half)
        simulation(10)
        u.append(simulation.flow.u())
        del simulation
    u_drift = ((u[1] - u[0]).abs().max() / u[0].abs().max()).item()
    check(u_drift < 0.02, f"half storage u drift {u_drift} after 10 steps")
    del u
    torch.cuda.empty_cache()

    # rollout steps in deviations and ends where a call does
    a, b = (tgv256(context, half_storage=True) for _ in range(2))
    energy = lt.IncompressibleKineticEnergy(a.flow)
    records = a.rollout(20, [energy], interval=5)
    b(20)
    check(tuple(records.shape) == (4, 1)
          and bool(torch.isfinite(records).all()),
          f"rollout records {tuple(records.shape)}")
    check(torch.equal(a.flow.f, b.flow.f),
          "rollout(20) under half storage differs from simulation(20)")
    print(f"phase 23: u after 10 steps {u_drift:.3e} of max|u| from the "
          f"float32 kernel path (bound 0.02); rollout(20, [energy], "
          f"interval=5) bitwise equal to simulation(20), energy "
          f"{records[0, 0].item():.6f} -> {records[-1, 0].item():.6f}")
    del a, b, records
    torch.cuda.empty_cache()
    return dict(mlups=mlups, launches=launched["bgk_bf16_dev"], err=err,
                kernel_ms=kernel_ms, plain_ms=plain_ms, cells=cells,
                u_drift=u_drift)


def phase24_half_fragment_cells(card, saxpy_gbps):
    """Phase 14's cells (the five 256^3 fragment cells and the Poiseuille
    2048^2 Guo cell, masked) under half storage: 20 + 100 steps with one
    bf16-dev launch each, finite, mass conserved; kernel vs plain at the
    cell's state; MLUPS, kernel and plain ms, the share of the saxpy."""
    import lettuce_tpu_torch as lt
    results = {}
    for cell, key, make_flow, make_collision in fragment_cells():
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=True)
        flow = make_flow(context)
        simulation = lt.Simulation(flow, make_collision(flow), [],
                                   half_storage=True)
        check(simulation.step_path == "cuda x1"
              and simulation.half_storage_engaged,
              f"{cell} runs {simulation.step_path!r}, engaged "
              f"{simulation.half_storage_engaged}")
        mass0 = torch.sum(flow.f, dtype=torch.float64).item()
        reset_launch_counts()
        simulation(20)
        mlups = simulation(100)
        torch.cuda.synchronize()
        launched = half_launches()
        name = f"{key}_bf16_dev"
        check(launched == {name: 120} and not fragment_launches(),
              f"{cell}: half launches {launched} for 120 steps")
        check(bool(torch.isfinite(flow.f).all()), f"{cell}: not finite")
        drift = abs(torch.sum(flow.f, dtype=torch.float64).item() - mass0
                    ) / mass0
        check(drift < 1e-4, f"{cell}: mass drift {drift}")
        kernel_ms, plain_ms, turns, err = half_kernel_timing(
            simulation, kernel_repeats=50,
            floor=KBC_DEV_FLOOR if key == "kbc" else DEV_FLOOR)
        cells = flow.f[0].numel()
        q = flow.stencil.q
        masked = key.startswith("masked_")
        bytes_per_update = 2 * q * 2 + (1 if masked else 0)
        bound_ms = cells * bytes_per_update / (saxpy_gbps * 1e9) * 1e3
        print(f"phase 24: {cell} ({name}), {simulation.step_path}: "
              f"{mlups:.1f} MLUPS, mass drift {drift:.2e}; per step, CUDA "
              f"events: kernel {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"({cells / kernel_ms / 1e3:.1f} MLUPS; saxpy bound "
              f"{bound_ms:.4f} ms, {bound_ms / kernel_ms:.1%} of the saxpy),"
              f" plain {turns[0]:.4f} / {turns[3]:.4f} ms; max |kernel - "
              f"plain| {err:.3e}; {bytes_per_update} B/update ({card})")
        results[name] = dict(cell=cell, mlups=mlups, launches=launched[name],
                             err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                             cells=cells, bytes=bytes_per_update, q=q,
                             fragment=key.removeprefix("masked_"))
        del simulation, flow
        torch.cuda.empty_cache()
    return results


def phase25_half_state(card, saxpy_gbps):
    """16-bit state (K1f) and the half-storage CLI on the card:
    ``benchmark -p half`` (a bfloat16 TGV3D 256^3 state) and ``benchmark
    --half-storage`` in process, each with its step path, storage and
    MLUPS; a float16 D3Q19 256^3 state through Simulation, timed; the
    D2Q9 bfloat16 and float16 sanity runs of tests/test_native.py:409-441
    (10 steps, finite, mass to 2e-2); an analytic MRT under half storage
    warns and runs at full precision."""
    import contextlib
    import io
    import warnings
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    from lettuce_tpu_torch import cli
    steps = 50
    runs = {}
    for argv, key in ((["-p", "half"], "bgk_bf16"),
                      (["-p", "single", "--half-storage"], "bgk_bf16_dev")):
        reset_launch_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["--device", "cuda", *argv[:2], "benchmark", "-r",
                           "256", "-s", str(steps), "-f", "taylor3d",
                           *argv[2:]])
        out = printed.getvalue().strip().splitlines()[-1]
        launched = half_launches()
        check(rc == 0 and launched == {key: steps}
              and "(cuda x1 path)" in out,
              f"cli {' '.join(argv)}: rc {rc}, launches {launched}, {out!r}")
        print(f"phase 25: cli benchmark {' '.join(argv)} -r 256 -s {steps} "
              f"-f taylor3d: {out} ({card})")
        runs[key] = launched[key]

    # a float16 state at the main path's size, through the kernel path
    context = lt.Context(device="cuda", dtype=torch.float16, use_native=True)
    simulation = tgv256(context)
    check(simulation.step_path == "cuda x1", "float16 main path not on the "
                                             "kernel")
    reset_launch_counts()
    simulation(20)
    mlups = simulation(100)
    launched = half_launches()
    check(launched == {"bgk_f16": 120}, f"float16 launches {launched}")
    f = simulation.flow.f
    check(f.dtype == torch.float16 and bool(torch.isfinite(f).all()),
          "float16 state not finite")
    params = simulation._kernel_params
    out = torch.empty_like(f)
    ref = sc.stream_collide_plain(f, **params)
    got = sc.stream_collide(f, **params, out=out)
    torch.cuda.synchronize()
    _, _, err = check_storage(got, ref, "f16", "float16 256^3")
    del ref
    kernel_ms, plain_ms, turns = time_in_turns(
        lambda: sc.stream_collide(f, **params, out=out),
        lambda: sc.stream_collide_plain(f, **params), kernel_repeats=200,
        plain_repeats=3)
    cells = 256 ** 3
    gbps = HALF_BYTES_PER_UPDATE * cells / (kernel_ms * 1e-3) / 1e9
    print(f"phase 25: D3Q19 BGK TGV 256^3 float16 state, "
          f"{simulation.step_path}: {mlups:.1f} MLUPS; per step, CUDA "
          f"events: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
          f"{turns[0]:.4f} / {turns[3]:.4f} ms; max |kernel - plain| "
          f"{err:.3e}; {gbps:.1f} GB/s, {gbps / saxpy_gbps:.1%} of the saxpy "
          f"({card})")
    f16 = dict(launches=launched["bgk_f16"], err=err, kernel_ms=kernel_ms,
               plain_ms=plain_ms, cells=cells)
    del simulation, f, out, got
    torch.cuda.empty_cache()

    # the bfloat16 state at 256^3 timed the same way (the CLI's state)
    context = lt.Context(device="cuda", dtype=torch.bfloat16,
                         use_native=True)
    simulation = tgv256(context)
    f = simulation.flow.f
    params = simulation._kernel_params
    out = torch.empty_like(f)
    ref = sc.stream_collide_plain(f, **params)
    got = sc.stream_collide(f, **params, out=out)
    torch.cuda.synchronize()
    _, _, err = check_storage(got, ref, "bf16", "bfloat16 256^3")
    del ref
    kernel_ms, plain_ms, turns = time_in_turns(
        lambda: sc.stream_collide(f, **params, out=out),
        lambda: sc.stream_collide_plain(f, **params), kernel_repeats=200,
        plain_repeats=3)
    gbps = HALF_BYTES_PER_UPDATE * cells / (kernel_ms * 1e-3) / 1e9
    print(f"phase 25: D3Q19 BGK TGV 256^3 bfloat16 state: per step, CUDA "
          f"events: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
          f"{turns[0]:.4f} / {turns[3]:.4f} ms; max |kernel - plain| "
          f"{err:.3e}; {gbps:.1f} GB/s, {gbps / saxpy_gbps:.1%} of the saxpy "
          f"({card})")
    bf16 = dict(launches=runs["bgk_bf16"], err=err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, cells=cells)
    del simulation, f, out, got
    torch.cuda.empty_cache()

    # tests/test_native.py:409-441 on the card
    for dtype in (torch.bfloat16, torch.float16):
        context = lt.Context(device="cuda", dtype=dtype, use_native=True)
        flow = lt.TaylorGreenVortex(context, [16, 128], 100, 0.05,
                                    stencil=lt.D2Q9(), initialize_fneq=False)
        simulation = lt.Simulation(flow, lt.BGKCollision(
            flow.units.relaxation_parameter_lu), [])
        reset_launch_counts()
        simulation(10)
        key = f"bgk_{HALF_KEYS[dtype]}"
        mass = flow.f.float().sum().item()
        check(half_launches() == {key: 10}
              and bool(torch.isfinite(flow.f.float()).all())
              and abs(mass - 16 * 128) <= 2e-2 * 16 * 128,
              f"{dtype} D2Q9 sanity: launches {half_launches()}, mass "
              f"{mass}")
        print(f"phase 25: D2Q9 16x128 {str(dtype)[6:]} state, "
              f"{simulation.step_path}, 10 steps: finite, mass {mass:.3f} "
              f"(2048 to 2e-2)")

    # an analytic MRT: half storage warns and runs at full precision
    context = lt.Context(device="cuda", dtype=torch.float32, use_native=True)
    flow = lt.TaylorGreenVortex(context, [64, 96], 100, 0.05,
                                stencil=lt.D2Q9(), initialize_fneq=False)
    mrt = fragment_collisions(flow, FRAGMENT_TAU)["mrt_lallemand"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        simulation = lt.Simulation(flow, mrt, [], half_storage=True)
    reasons = [str(w.message) for w in caught]
    reset_launch_counts()
    simulation(4)
    check(not simulation.half_storage_engaged and not half_launches()
          and fragment_launches() == {"mrt_lallemand": 4}
          and any("not shift-invariant" in r for r in reasons),
          f"analytic MRT under half storage: {reasons}, "
          f"{fragment_launches()}, {half_launches()}")
    print(f"phase 25: MRT Lallemand under half storage: {reasons[0]!r}; "
          f"4 float32 mrt_lallemand launches")
    return dict(bf16=bf16, f16=f16)



# ----------------------------------------------------------------------
# temporal blocking: the blocked kernel (K2) and its adjoint (K4)
# ----------------------------------------------------------------------
MULTI_SOURCE = "lettuce_tpu_torch/csrc/multi_stream_collide.cu"
MULTI_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1270"
ADJOINT_MULTI_SOURCE = "lettuce_tpu_torch/csrc/adjoint_multi.cu"
ADJOINT_MULTI_REPLACES = "lettuce_tpu/ops/pallas/adjoint.py:984"
# the blocked kernel's storages: suffix -> (state dtype, deviations)
MULTI_STORAGES = {"f32": (torch.float32, False),
                  "f64": (torch.float64, False), **HALF_STORAGES}
DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# K4 reads f and g and writes the cotangent once per launch (D3Q19
# float32)
ADJOINT_MULTI_BYTES_PER_UPDATE = 19 * 4 * 3


def multi_launches():
    """Blocked forward launches ("bgk_f32_x2", "masked_bgk_f32_x2", ...)."""
    return launched("K2")


def adjoint_multi_launches():
    """Blocked adjoint launches ("bgk_f32_x2", "bgk_bf16_x2", ...)."""
    return launched("K4")


def with_span(span):
    """Set ``LETTUCE_NSUB`` to ``span`` (None unsets it): the span a
    Simulation built afterwards blocks at."""
    if span is None:
        os.environ.pop("LETTUCE_NSUB", None)
    else:
        os.environ["LETTUCE_NSUB"] = str(span)


def plan_text(plan):
    """A march plan in one phrase: the cross-section's interior and
    extent, the segment, the bytes per block, where they live and how many
    blocks share an SM, the units, blocks and threads."""
    cross = [b for a, b in enumerate(plan.interior) if a != plan.axis]
    where = ("global scratch" if plan.scratch
             else f"shared memory, {plan.blocks_per_sm}/SM")
    return (f"march axis {plan.axis}, cross {cross[0]}x{cross[1]} of "
            f"{plan.cells} cells, segment {plan.segment}, {plan.bytes} B "
            f"of rings and grid offsets in {where}, {plan.units} units on "
            f"{plan.blocks} blocks of {plan.threads} threads, stored share "
            f"{plan.share:.3f}")


def phase26_multi_instances_vs_plain():
    """Every periodic K2 instance (BGK and every K1c fragment, in float32,
    float64, bfloat16 and float16 state and bfloat16 deviations) against
    its plain version at the grids of phase 2, at n_sub 2, 3 and 4: two
    launches each, the second from the plain state of the first; float32
    and float64 to ATOL, and also against n_sub launches of the
    single-step kernel (K1), counting those bitwise equal; 16 bits within
    one storage ulp (deviations plus n_sub times the float32 floor);
    launches counted; the march plan of each stencil, storage and span."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 900
    count = 0
    bitwise, differing = 0, []
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        # the specs in float64: an MRT transform built in float32 rounds
        # M^-1, which the plain version applies and the folded kernel
        # parameters assume exact
        context = lt.Context(device="cuda", dtype=torch.float64,
                             use_native=False)
        flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                    stencil=stencil, initialize_fneq=False)
        collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                      **fragment_collisions(flow, FRAGMENT_TAU)}
        for fragment, collision in collisions.items():
            spec = fragment_spec(flow, collision)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    spec[1] if fragment == "bgk" else None)
            line = []
            for suffix, (dtype, dev) in MULTI_STORAGES.items():
                if dev and fragment in sc.DEV_REFUSED:
                    continue
                readings = []
                for span in (2, 3, 4):
                    seed += 1
                    # KBC's gamma guard jumps where 1e-3 noise puts gamma
                    # near 0, and float32 and float64 take either side
                    # (1.6e-4 apart after 3 steps on one such state): KBC
                    # steps a state nearer equilibrium
                    f, _ = tgv_state(stencil, shape, torch.float64
                                     if suffix == "f64" else torch.float32,
                                     seed, 1e-5 if fragment == "kbc"
                                     else 1e-3)
                    x = f if suffix in ("f32", "f64") else storage_state(
                        f, stencil.w, suffix)
                    key = f"{fragment}_{suffix}_x{span}"
                    before = multi_launches().get(key, 0)
                    floor = span * (KBC_DEV_FLOOR if fragment == "kbc"
                                    else DEV_FLOOR)
                    for launch in (1, 2):
                        got = sc.stream_collide(x, *args, collision_spec=spec,
                                                dev_storage=dev, n_sub=span)
                        ref = sc.stream_collide_plain(
                            x, *args, collision_spec=spec, dev_storage=dev,
                            n_sub=span)
                        torch.cuda.synchronize()
                        what = f"{key} {name} launch {launch}"
                        check(got.dtype == x.dtype, f"{what}: {got.dtype}")
                        if suffix in ("f32", "f64"):
                            err = (got - ref).abs().max().item()
                            check(bool(torch.isfinite(got).all()),
                                  f"{what}: not finite")
                            check(err <= ATOL[dtype], f"{what}: max |kernel"
                                                      f" - plain| {err}")
                            reading = f"{err:.1e}"
                            if launch == 1:  # against span K1 launches
                                y = x
                                for _ in range(span):
                                    y = sc.stream_collide(
                                        y, *args, collision_spec=spec)
                                err_k1 = (got - y).abs().max().item()
                                check(err_k1 <= ATOL[dtype],
                                      f"{what}: max |K2 - {span} K1| "
                                      f"{err_k1}")
                                reading += f"/K1 {err_k1:.1e}"
                                if torch.equal(got, y):
                                    bitwise += 1
                                else:
                                    differing.append(f"{key} {name} "
                                                     f"{err_k1:.1e}")
                        else:
                            ulps, _, err = check_storage(got, ref, suffix,
                                                         what, floor)
                            reading = f"{ulps:.1f}"
                        readings.append(reading)
                        was = worst.get(f"{fragment}_{suffix}", 0.0)
                        worst[f"{fragment}_{suffix}"] = max(was, err)
                        x = ref
                    launched = multi_launches().get(key, 0) - before
                    check(launched == 2, f"{key} {name}: {launched} launches "
                                         f"for 2")
                    count += 1
                line.append(f"{suffix} {' '.join(readings[::2])}")
            print(f"phase 26: {fragment} {name} {'x'.join(map(str, shape))} "
                  f"(first launch at n_sub 2/3/4; f32/f64 max |err|, 16-bit "
                  f"ulps): " + "; ".join(line))
        for suffix, (dtype, dev) in MULTI_STORAGES.items():
            x = torch.empty((stencil.q, *shape), dtype=dtype, device="cuda")
            for span in (2, 3, 4):
                print(f"phase 26: {name} {suffix} x{span} plan: "
                      f"{plan_text(sc.march_plan(x, stencil.e, span))}")
    print(f"phase 26: {count} instance-spans of 2 launches each, every one "
          f"within its bound; {bitwise} of {bitwise + len(differing)} "
          f"float32/float64 instance-spans bitwise equal to n_sub K1 "
          f"launches" + (f"; not bitwise: {', '.join(differing)}"
                         if differing else ""))
    return worst


def multi_kernel_timing(simulation, span, half, floor=DEV_FLOOR):
    """K2 at the simulation's own (encoded) state against its plain
    version, and by CUDA events in turns: plain, K1, K2, K2, K1, plain
    (K1 the single-step kernel, K1a or K1e). Returns a dict of per-launch
    ms and the error."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    params = simulation._half_params if half else simulation._kernel_params
    x = (simulation._encode(simulation.flow.f) if half
         else simulation.flow.f.clone())
    out = torch.empty_like(x)
    ref = sc.stream_collide_plain(x, **params, n_sub=span)
    got = sc.stream_collide(x, **params, out=out, n_sub=span)
    torch.cuda.synchronize()
    if half:
        _, _, err = check_storage(got, ref, "bf16_dev", f"K2 x{span} 256^3",
                                  span * floor)
    else:
        err = (got - ref).abs().max().item()
        check(err <= ATOL[torch.float32], f"K2 x{span} 256^3 vs plain: {err}")
    del ref
    buffers = [x, out]

    def launch(n_sub):
        sc.stream_collide(buffers[0], **params, out=buffers[1], n_sub=n_sub)
        buffers.reverse()

    def plain():
        sc.stream_collide_plain(x, **params, n_sub=span)

    repeats = 100 // span
    launch(span)
    launch(1)
    plain()
    plain_a = cuda_ms(plain, 2)
    k1_a = cuda_ms(lambda: launch(1), 100)
    k2_a = cuda_ms(lambda: launch(span), repeats)
    k2_b = cuda_ms(lambda: launch(span), repeats)
    k1_b = cuda_ms(lambda: launch(1), 100)
    plain_b = cuda_ms(plain, 2)
    return dict(ms=(k2_a + k2_b) / 2, k1_ms=(k1_a + k1_b) / 2,
                plain_ms=(plain_a + plain_b) / 2, err=err,
                turns=(plain_a, k1_a, k2_a, k2_b, k1_b, plain_b))


def phase27_blocked_main_path(card, saxpy_gbps):
    """The main path (D3Q19 BGK TGV 256^3) with LETTUCE_NSUB=2 and 4, in
    float32 and under half storage: step_path 'cuda x<span>', 20 + 200
    steps in 220 / span K2 launches and no single-step launch, finite,
    mass to 1e-5 (1e-4 for half); MLUPS; K2 per launch and per step in
    turns with the single-step kernel (K1a, K1e) and against its plain
    version, the share of the saxpy; then the CLI benchmark in process
    under LETTUCE_NSUB=2."""
    import contextlib
    import io
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    from lettuce_tpu_torch import cli
    runs = {}
    cells = 256 ** 3
    for half in (False, True):
        for span in (2, 4):
            with_span(span)
            context = lt.Context(device="cuda", dtype=torch.float32,
                                 use_native=True)
            simulation = tgv256(context, half_storage=half)
            with_span(None)
            check(simulation.step_path == f"cuda x{span}"
                  and simulation.half_storage_engaged == half,
                  f"blocked main path: {simulation.step_path}, half "
                  f"{simulation.half_storage_engaged}")
            flow = simulation.flow
            mass0 = torch.sum(flow.f, dtype=torch.float64).item()
            suffix = "bf16_dev" if half else "f32"
            key = f"bgk_{suffix}_x{span}"
            reset_launch_counts()
            simulation(20)
            mlups = simulation(200)
            torch.cuda.synchronize()
            launched = multi_launches()
            check(launched == {key: 220 // span}
                  and launch_counts() == (0, 0, 0) and not half_launches()
                  and not fragment_launches(),
                  f"{key}: launches {launched}, single-step "
                  f"{launch_counts()}, {half_launches()}")
            check(bool(torch.isfinite(flow.f).all()), f"{key}: not finite")
            drift = abs(torch.sum(flow.f, dtype=torch.float64).item()
                        - mass0) / mass0
            check(drift < (1e-4 if half else 1e-5),
                  f"{key}: mass drift {drift}")
            timing = multi_kernel_timing(simulation, span, half)
            nbytes = 19 * 2 * (2 if half else 4)
            gbps = nbytes * cells / (timing["ms"] * 1e-3) / 1e9
            t = timing["turns"]
            print(f"phase 27: D3Q19 BGK TGV 256^3 "
                  f"{'half storage' if half else 'float32'}, "
                  f"{simulation.step_path}: {mlups:.1f} MLUPS, "
                  f"{launched[key]} K2 launches for 220 steps, mass drift "
                  f"{drift:.2e}; CUDA events in turns: K2 {t[2]:.4f} / "
                  f"{t[3]:.4f} ms per launch ({timing['ms'] / span:.4f} ms "
                  f"per step), single-step K1 {t[1]:.4f} / {t[4]:.4f} ms per "
                  f"step, plain x{span} {t[0]:.2f} / {t[5]:.2f} ms; max "
                  f"|K2 - plain| {timing['err']:.3e}; K2 moves {nbytes} B "
                  f"per update per launch: {gbps:.1f} GB/s, "
                  f"{gbps / saxpy_gbps:.1%} of the saxpy ({card})")
            plan = sc.march_plan(simulation._encode(flow.f) if half
                                 else flow.f, flow.stencil.e, span)
            print(f"phase 27: {key} plan: {plan_text(plan)}")
            runs[key] = dict(timing, mlups=mlups, launches=launched[key],
                             span=span, suffix=suffix, cells=cells,
                             bytes=nbytes)
            del simulation, flow
            torch.cuda.empty_cache()

    with_span(2)
    reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["--device", "cuda", "-p", "single", "benchmark", "-r",
                       "256", "-s", "50", "-f", "taylor3d"])
    with_span(None)
    out = printed.getvalue().strip().splitlines()[-1]
    launched = multi_launches()
    check(rc == 0 and "(cuda x2 path)" in out
          and sum(launched.values()) == 25
          and all(k.endswith("_x2") for k in launched)
          and launch_counts() == (0, 0, 0),
          f"cli benchmark under LETTUCE_NSUB=2: rc {rc}, {launched}, {out!r}")
    print(f"phase 27: LETTUCE_NSUB=2 cli benchmark -r 256 -s 50 -f taylor3d: "
          f"{out} ({card})")
    return runs


def phase28_blocked_gradient(card, saxpy_gbps, single_mlups):
    """K4 against its plain version per spec (bgk, trt, matvec for reg and
    MRT from_feq, none) on each stencil of phase 2, float32 and float64,
    at n_sub 2 and 4, one launch each; then the 8-step gradient of the
    main path at 256^3 through make_segment_fn(8) at span 2: 4 K2 and 4
    K4 launches and no single-step one, within 1e-5 of the single-step
    kernel chain's gradient (phase 7's route), bitwise equal under
    checkpoint_every=4; fwd+bwd MLUPS against phase 7's, peak memory of
    both; K2 + K4 per two steps in turns with K1d + K3a, and K4 against
    its plain version."""
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = 0.0
    seed = 1300
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        for dtype in (torch.float32, torch.float64):
            context = lt.Context(device="cuda", dtype=dtype, use_native=False)
            flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                        stencil=stencil,
                                        initialize_fneq=False)
            collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                          **fragment_collisions(flow, FRAGMENT_TAU)}
            line = []
            for fragment, collision in collisions.items():
                if fragment not in adjoint.ADJOINT_MULTI_FRAGMENTS:
                    continue
                spec = fragment_spec(flow, collision)
                args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                        spec[1] if fragment == "bgk" else None)
                for span in (2, 4):
                    seed += 1
                    f, _ = tgv_state(stencil, shape, dtype, seed)
                    g = torch.as_tensor(np.random.default_rng(seed)
                                        .standard_normal(tuple(f.shape)),
                                        dtype=dtype, device="cuda")
                    key = f"{fragment}_{DTYPE_SUFFIX[dtype]}_x{span}"
                    before = adjoint_multi_launches().get(key, 0)
                    ct = adjoint.stream_collide_adjoint_multi(
                        f, g, span, *args, collision_spec=spec)
                    ref = adjoint.stream_collide_adjoint_multi_plain(
                        f, g, span, *args, collision_spec=spec)
                    torch.cuda.synchronize()
                    launched = adjoint_multi_launches().get(key, 0) - before
                    err, scale = scaled_err(ct, ref)
                    check(launched == 1, f"{key} {name}: {launched} launches")
                    check(bool(torch.isfinite(ct).all()), f"{key}: not finite")
                    check(err <= GRAD_RTOL[dtype] * scale,
                          f"K4 {key} {name}: {err} of {scale}")
                    line.append(f"{fragment} x{span} {err / scale:.1e}")
                    if fragment == "bgk" and dtype == torch.float32:
                        worst = max(worst, err)
            print(f"phase 28: K4 vs plain, {name} {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]} (relative to the largest magnitude): "
                  + ", ".join(line))

    # the 8-step gradient of the main path at span 2
    with_span(2)
    simulation = tgv256_simulation()
    with_span(None)
    check(simulation.step_path == "cuda x2"
          and simulation._step_multi[0].adjoint_kernel,
          f"blocked gradient path: {simulation.step_path}")
    f0 = simulation.flow.f.detach().clone().requires_grad_(True)
    cells = f0[0].numel()

    def grad_of(seg):
        (grad,) = torch.autograd.grad((seg(f0) ** 2).sum(), f0)
        return grad

    def peak_of(seg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grad = grad_of(seg)
        torch.cuda.synchronize()
        return grad, (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    reset_launch_counts()
    grad, peak = peak_of(segment)
    k2, k4 = multi_launches(), adjoint_multi_launches()
    check(k2 == {"bgk_f32_x2": 4} and k4 == {"bgk_f32_x2": 4}
          and launch_counts() == (0, 0, 0),
          f"8-step blocked gradient: K2 {k2}, K4 {k4}, single-step "
          f"{launch_counts()}")
    check(bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0,
          "blocked gradient not finite or zero")
    single = tgv256_simulation()
    check(single.step_path == "cuda x1", "the single-step reference blocks")
    grad_ref, peak_ref = peak_of(single.make_segment_fn(SEGMENT_STEPS))
    err, scale = scaled_err(grad, grad_ref)
    del grad_ref
    check(err <= GRAD_RTOL[torch.float32] * scale,
          f"blocked gradient vs single-step chain: {err} of {scale}")
    grad_ck = grad_of(simulation.make_segment_fn(SEGMENT_STEPS,
                                                 checkpoint_every=4))
    torch.cuda.synchronize()
    check(torch.equal(grad, grad_ck),
          "checkpoint_every=4 blocked gradient differs")
    del grad_ck
    grad_of(segment)
    torch.cuda.synchronize()
    repeats = 3
    beg = time.perf_counter()
    for _ in range(repeats):
        grad = grad_of(segment)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / repeats
    mlups = cells * SEGMENT_STEPS / seconds / 1e6
    print(f"phase 28: {SEGMENT_STEPS}-step gradient at 256^3 float32, span "
          f"2: K2 {k2}, K4 {k4}, no single-step launch; max |blocked - "
          f"single-step chain| {err:.3e} of {scale:.3e} ({err / scale:.2e} "
          f"relative, rtol 1e-5); checkpoint_every=4 bitwise equal; fwd+bwd "
          f"{mlups:.1f} MLUPS ({seconds * 1e3:.2f} ms per gradient) against "
          f"the single-step kernels' {single_mlups:.1f} (phase 7); peak "
          f"memory above the state {peak:.2f} GiB blocked, {peak_ref:.2f} "
          f"GiB single-step ({card})")
    del grad

    # per launch by CUDA events, in turns: K1d + K3a twice (two steps), K2 +
    # K4 (two steps), then K4 against its plain version
    params = simulation._kernel_params
    f = f0.detach()
    g1 = torch.randn(f.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(28), device="cuda")
    out, ct = torch.empty_like(f), torch.empty_like(f)
    u = torch.empty((3, *f.shape[1:]), dtype=f.dtype, device="cuda")
    got = adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)
    ref = adjoint.stream_collide_adjoint_multi_plain(f, g1, 2, **params)
    torch.cuda.synchronize()
    err4, scale4 = scaled_err(got, ref)
    check(err4 <= GRAD_RTOL[torch.float32] * scale4,
          f"256^3 K4 vs plain: {err4} of {scale4}")
    del ref, got

    def single_pair():
        for _ in range(2):
            sc.stream_collide(f, **params, out=out, u_out=u)
            adjoint.stream_collide_adjoint(g1, u, **params, out=ct)

    def blocked_pair():
        sc.stream_collide(f, **params, out=out, n_sub=2)
        adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)

    def k4_launch():
        adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)

    def k4_plain():
        adjoint.stream_collide_adjoint_multi_plain(f, g1, 2, **params)

    single_pair()
    blocked_pair()
    s_a = cuda_ms(single_pair, 20)
    b_a = cuda_ms(blocked_pair, 20)
    b_b = cuda_ms(blocked_pair, 20)
    s_b = cuda_ms(single_pair, 20)
    k4_ms, k4_plain_ms, turns = time_in_turns(k4_launch, k4_plain,
                                              kernel_repeats=20,
                                              plain_repeats=2)
    gbps = ADJOINT_MULTI_BYTES_PER_UPDATE * cells / (k4_ms * 1e-3) / 1e9
    print(f"phase 28: per step, CUDA events in turns: K1d + K3a {s_a / 2:.4f}"
          f" / {s_b / 2:.4f} ms, K2 + K4 at span 2 {b_a / 2:.4f} / "
          f"{b_b / 2:.4f} ms; K4 per launch {turns[1]:.4f} / {turns[2]:.4f} "
          f"ms, plain {turns[0]:.2f} / {turns[3]:.2f} ms, max |K4 - plain| "
          f"{err4:.3e} of {scale4:.3e}; {ADJOINT_MULTI_BYTES_PER_UPDATE} B "
          f"per update per launch: {gbps:.1f} GB/s, "
          f"{gbps / saxpy_gbps:.1%} of the saxpy ({card})")
    e = simulation.flow.stencil.e
    k4_plan = sc.march_plan(f, e, 2, adjoint=True,
                            halo=adjoint.adjoint_multi_halo(2))
    print(f"phase 28: K2 x2 plan: {plan_text(sc.march_plan(f, e, 2))}; K4 "
          f"x2 plan: {plan_text(k4_plan)}")
    del simulation, single, f0, f, out, ct, u, g1, segment
    torch.cuda.empty_cache()
    return dict(k2_launches=k2["bgk_f32_x2"], k4_launches=k4["bgk_f32_x2"],
                err=max(worst, err4), ms=k4_ms, plain_ms=k4_plain_ms,
                cells=cells, mlups=mlups, peak=peak, peak_ref=peak_ref,
                pair_ms=(b_a + b_b) / 4, single_pair_ms=(s_a + s_b) / 4)


# ----------------------------------------------------------------------
# temporal blocking of bounded flows: K2's masked form and the outlets'
# n_sub window replay
# ----------------------------------------------------------------------
# the masked sweep of the TPU kernel: _multi_sweep with the code, field and
# frozen-population slabs (stream_collide.py:1299-1367)
MULTI_MASKED_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1299"
# the cube-tiled masked K2 this march replaced, ms per launch (PERF.md §6:
# this script's phase 30 on NVIDIA H100 80GB HBM3, 700.00 W), quoted beside
# phase 30's times
CUBE_MS = {("obstacle2d_2048", "f32", 2): "0.2138-0.2150",
               ("obstacle2d_2048", "f32", 4): "0.2825-0.2828",
               ("f32", 2): "0.3760-0.3775", ("f32", 4): "0.5253-0.5282",
               ("bf16_dev", 2): "0.3714-0.3730"}


def cube_ms(cell, suffix, span):
    """The cube-tiled kernel's ms per launch for a bounded cell's launch."""
    return CUBE_MS.get((cell, suffix, span),
                       CUBE_MS.get((suffix, span), "not measured"))


def multi_kernel_k1_equal(x, got, span, args, masks, spec):
    """max |K2 - span launches of K1| (the single-step kernel, same masks)
    from ``x``."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    y = x
    for _ in range(span):
        y = sc.stream_collide(y, *args, **masks, collision_spec=spec)
    torch.cuda.synchronize()
    return (got - y).abs().max().item()


def phase29_masked_multi_instances_vs_plain():
    """Every masked K2 instance (the masked march; BGK and every K1c
    fragment, in float32, float64, bfloat16 and float16 state and bfloat16
    deviations) against
    its plain version at the grids of phase 2, at n_sub 2, 3 and 4, with
    phase 9's codes (bounce back, a constant and a per-node equilibrium,
    identity): two launches each, the first with phase 9's frozen
    populations (a frozen plane, the odd populations on another), the
    second without (the launch the bounded cells run), from the plain
    state of the first; float32 and float64 to ATOL and against n_sub
    masked single-step launches (K1), bitwise counted; 16 bits within one
    storage ulp (deviations plus n_sub times the floor); launches
    counted. Then, in every storage at span 2, the masked launch with
    every code "collide" and nothing frozen bitwise equal to the periodic
    launch: the mask pipeline adds no arithmetic to a colliding cell; and
    in float32 and float64 the single-step masked kernel (K1b) with every
    code "collide" against the periodic one (K1a), whose rounding can
    differ where nvcc contracts a policy's products differently in the
    two kernels. Each stencil's masked plans (float32, n_sub 2-4, frozen
    and not) are printed."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 2900
    count = bitwise = compared = identical = 0
    differing, k1_rounding = [], {}
    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        context = lt.Context(device="cuda", dtype=torch.float64,
                             use_native=False)
        flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                    stencil=stencil, initialize_fneq=False)
        collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                      **fragment_collisions(flow, FRAGMENT_TAU)}
        for fragment, collision in collisions.items():
            spec = fragment_spec(flow, collision)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    spec[1] if fragment == "bgk" else None)
            line = []
            for suffix, (dtype, dev) in MULTI_STORAGES.items():
                if dev and fragment in sc.DEV_REFUSED:
                    continue
                wide = torch.float64 if suffix == "f64" else torch.float32
                readings = []
                for span in (2, 3, 4):
                    seed += 1
                    f, _ = tgv_state(stencil, shape, wide, seed,
                                     1e-5 if fragment == "kbc" else 1e-3)
                    masks = bounded_case(stencil, shape, wide, seed)[1]
                    if suffix in HALF_STORAGES:
                        masks["feq_field"] = storage_state(
                            masks["feq_field"], stencil.w, suffix)
                        x = storage_state(f, stencil.w, suffix)
                    else:
                        x = f
                    key = f"masked_{fragment}_{suffix}_x{span}"
                    before = multi_launches().get(key, 0)
                    floor = span * (KBC_DEV_FLOOR if fragment == "kbc"
                                    else DEV_FLOOR)
                    for launch in (1, 2):
                        run_masks = dict(masks, nsm=None) if launch == 2 \
                            else masks
                        got = sc.stream_collide(x, *args, **run_masks,
                                                collision_spec=spec,
                                                dev_storage=dev, n_sub=span)
                        ref = sc.stream_collide_plain(
                            x, *args, **run_masks, collision_spec=spec,
                            dev_storage=dev, n_sub=span)
                        torch.cuda.synchronize()
                        what = f"{key} {name} launch {launch}"
                        check(got.dtype == x.dtype, f"{what}: {got.dtype}")
                        if suffix in ("f32", "f64"):
                            err = (got - ref).abs().max().item()
                            check(bool(torch.isfinite(got).all()),
                                  f"{what}: not finite")
                            check(err <= ATOL[dtype], f"{what}: max |kernel"
                                                      f" - plain| {err}")
                            err_k1 = multi_kernel_k1_equal(
                                x, got, span, args, run_masks, spec)
                            check(err_k1 <= ATOL[dtype],
                                  f"{what}: max |K2 - {span} K1| {err_k1}")
                            compared += 1
                            bitwise += err_k1 == 0.0
                            if err_k1 != 0.0:
                                differing.append(f"{fragment} {name} "
                                                 f"{suffix}")
                            reading = f"{err:.1e}/K1 {err_k1:.0e}"
                        else:
                            ulps, _, err = check_storage(got, ref, suffix,
                                                         what, floor)
                            reading = f"{ulps:.1f}"
                        readings.append(reading)
                        was = worst.get(f"{fragment}_{suffix}", 0.0)
                        worst[f"{fragment}_{suffix}"] = max(was, err)
                        x = ref
                    launched = multi_launches().get(key, 0) - before
                    check(launched == 2, f"{key} {name}: {launched} launches "
                                         f"for 2")
                    count += 1
                line.append(f"{suffix} {' '.join(readings[::2])}")
                collide_only = dict(ncm=torch.zeros_like(masks["ncm"]),
                                    table=(("collide", None),))
                periodic = sc.stream_collide(x, *args, collision_spec=spec,
                                             dev_storage=dev, n_sub=2)
                masked0 = sc.stream_collide(x, *args, **collide_only,
                                            collision_spec=spec,
                                            dev_storage=dev, n_sub=2)
                check(torch.equal(periodic, masked0),
                      f"masked_{fragment}_{suffix}_x2 {name}: an all-collide "
                      f"masked launch differs from the periodic one")
                identical += 1
                if suffix in ("f32", "f64"):
                    k1a = sc.stream_collide(x, *args, collision_spec=spec)
                    k1b = sc.stream_collide(x, *args, **collide_only,
                                            collision_spec=spec)
                    if not torch.equal(k1a, k1b):
                        k1_rounding[f"{fragment} {name} {suffix}"] = \
                            (k1a - k1b).abs().max().item()
            print(f"phase 29: masked {fragment} {name} "
                  f"{'x'.join(map(str, shape))} (frozen launch at n_sub "
                  f"2/3/4; f32/f64 max |err| and against n_sub K1, 16-bit "
                  f"ulps): " + "; ".join(line))
        f, _ = tgv_state(stencil, shape, torch.float32, seed)
        for span in (2, 3, 4):
            for frozen in (True, False):
                print(f"phase 29: masked {name} float32 x{span} "
                      f"{'frozen' if frozen else 'codes only'} plan: "
                      + plan_text(sc.march_plan(f, stencil.e, span,
                                                masked=True, frozen=frozen)))
    print(f"phase 29: {count} masked instance-spans of 2 launches each, "
          f"every one within its bound; {bitwise} of {compared} float32 and "
          f"float64 launches bitwise equal to n_sub masked K1 launches (not: "
          f"{', '.join(sorted(set(differing))) or 'none'}); {identical} "
          f"instances' all-collide masked launch bitwise equal to their "
          f"periodic one; all-collide K1b vs K1a not bitwise: "
          + (", ".join(f"{k} {v:.1e}" for k, v in sorted(k1_rounding.items()))
             or "none"))
    return worst


def bounded_cells():
    """The 2D bounded cells of benchmarks/run_benchmarks.py:127-142, uncut,
    float32: (name, fragment, flow factory, collision factory)."""
    import lettuce_tpu_torch as lt

    def tau(flow):
        return flow.units.relaxation_parameter_lu

    def bgk(flow):
        return lt.BGKCollision(tau(flow))

    def guo(flow):
        acc = flow.units.convert_acceleration_to_lu(flow.acceleration)
        return lt.BGKCollision(tau(flow), force=lt.Guo(flow, tau(flow), acc))

    return [
        ("obstacle2d_2048", "bgk", obstacle_flow, bgk),
        ("poiseuille2d_2048_guo", "bgk_force",
         lambda context: lt.PoiseuilleFlow2D(context, 2048, 100, 0.05), guo),
        ("couette2d_2048", "bgk",
         lambda context: lt.CouetteFlow2D(context, 2048, 10, 0.05), bgk),
        ("cavity2d_2048", "bgk",
         lambda context: lt.Cavity2D(context, 2048, 1000, 0.05), bgk),
    ]


def bounded_simulation(make_flow, make_collision, span, half=False):
    """A bounded cell's Simulation on the card at ``span`` (1: the
    single-step path)."""
    import lettuce_tpu_torch as lt
    with_span(span if span > 1 else None)
    flow = make_flow(lt.Context(device="cuda", dtype=torch.float32,
                                use_native=True))
    simulation = lt.Simulation(flow, make_collision(flow), [],
                               half_storage=half)
    with_span(None)
    return simulation


def masked_multi_timing(simulation, span, half):
    """The blocked launch at the simulation's own state against its plain
    version, and by CUDA events in turns: plain, K1, K2, K2, K1, plain (K1
    the single-step masked kernel); the replay per blocked launch. Returns
    a dict of per-launch ms and the error."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    step = (simulation._half_multi if half else simulation._step_multi)[0]
    params = step.params
    single = simulation._half_params if half else simulation._kernel_params
    x = (simulation._encode(simulation.flow.f) if half
         else simulation.flow.f.clone())
    out = torch.empty_like(x)
    ref = sc.stream_collide_plain(x, **params, n_sub=span)
    got = sc.stream_collide(x, **params, out=out, n_sub=span)
    torch.cuda.synchronize()
    if half:
        _, _, err = check_storage(got, ref, "bf16_dev", f"masked K2 x{span}",
                                  span * DEV_FLOOR)
    else:
        err = (got - ref).abs().max().item()
        check(err <= ATOL[torch.float32], f"masked K2 x{span} vs plain: "
                                          f"{err}")
    del ref
    buffers = [x, out]

    def launch(n_sub):
        sc.stream_collide(buffers[0], **(params if n_sub > 1 else single),
                          out=buffers[1], n_sub=n_sub)
        buffers.reverse()

    def plain():
        sc.stream_collide_plain(x, **params, n_sub=span)

    launch(span)
    launch(1)
    plain()
    plain_a = cuda_ms(plain, 2)
    k1_a = cuda_ms(lambda: launch(1), 200)
    k2_a = cuda_ms(lambda: launch(span), 200 // span)
    k2_b = cuda_ms(lambda: launch(span), 200 // span)
    k1_b = cuda_ms(lambda: launch(1), 200)
    plain_b = cuda_ms(plain, 2)
    replay_ms = None
    if step.fixup is not None:
        f, g = simulation.flow.f, torch.empty_like(simulation.flow.f)
        step.fixup(f, g)
        replay_ms = cuda_ms(lambda: step.fixup(f, g), 20)
    return dict(ms=(k2_a + k2_b) / 2, k1_ms=(k1_a + k1_b) / 2,
                plain_ms=(plain_a + plain_b) / 2, err=err, replay_ms=replay_ms,
                turns=(plain_a, k1_a, k2_a, k2_b, k1_b, plain_b))


def masked_bytes(simulation, params):
    """Bytes per cell a masked launch must move once: q populations in and
    out, the 1-byte code, q bytes of the no-streaming mask and q values of
    the per-node field when present."""
    q = simulation.flow.stencil.q
    s = 2 if params.get("dev_storage") else simulation.flow.f.element_size()
    return (2 * q * s + 1 + (q if params["nsm"] is not None else 0)
            + (q * s if params["feq_field"] is not None else 0))


def phase30_blocked_bounded_cells(card, saxpy_gbps):
    """The four 2D bounded cells at full size under LETTUCE_NSUB=2 and 4
    against the same run's single-step path: step_path, the state after 8
    steps against the x1 path's (5e-6; the replay recomputes the planes
    owned +- n_sub in torch), 20 + 100 steps with 100 / span masked K2
    launches and no single-step one, finite, mass drift, MLUPS; the masked
    K2 per launch and per step by CUDA events in turns with the
    single-step masked kernel and the plain version, beside its bound; the
    replay per blocked launch (the obstacle). Then Couette and the cavity
    under half storage at span 2. Each blocked launch's march plan, GB/s
    and share of the saxpy are printed beside its bound and the replaced
    cube-tiled kernel's time (CUBE_MS)."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    runs = {}
    for cell, fragment, make_flow, make_collision in bounded_cells():
        ref8 = bounded_simulation(make_flow, make_collision, 1)
        ref8(8)
        x1_mlups = None
        for span in (1, 2, 4):
            simulation = bounded_simulation(make_flow, make_collision, span)
            flow = simulation.flow
            hybrid = "+hybrid" if simulation._fixup is not None else ""
            check(simulation.step_path == f"cuda{hybrid} x{span}",
                  f"{cell} at span {span}: {simulation.step_path}")
            simulation(8)
            err8 = (flow.f - ref8.flow.f).abs().max().item()
            check(err8 <= ATOL[torch.float32],
                  f"{cell} x{span}: 8 steps vs x1 {err8}")
            mass0 = torch.sum(flow.f, dtype=torch.float64).item()
            reset_launch_counts()
            simulation(20)
            mlups = simulation(100)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(flow.f).all()), f"{cell} x{span}: "
                                                      f"not finite")
            drift = abs(torch.sum(flow.f, dtype=torch.float64).item()
                        - mass0) / mass0
            single = dict(fragment_launches())
            if fragment == "bgk" and masked_launch_counts()[0]:
                single["masked_bgk"] = masked_launch_counts()[0]
            blocked = multi_launches()
            if span == 1:
                x1_mlups = mlups
                check(single == {f"masked_{fragment}": 120} and not blocked,
                      f"{cell} x1: launches {single}, {blocked}")
                print(f"phase 30: {cell} {simulation.step_path}: "
                      f"{mlups:.1f} MLUPS, 120 masked K1 launches for 120 "
                      f"steps, mass drift {drift:.2e} ({card})")
                del simulation, flow
                torch.cuda.empty_cache()
                continue
            key = f"masked_{fragment}_f32_x{span}"
            check(blocked == {key: 120 // span} and not single
                  and launch_counts() == (0, 0, 0),
                  f"{cell} x{span}: launches {blocked}, single-step "
                  f"{single}")
            timing = masked_multi_timing(simulation, span, False)
            params = simulation._step_multi[0].params
            nbytes = masked_bytes(simulation, params)
            cells = flow.f[0].numel()
            bound_ms = bound(cells, nbytes, span * flow.stencil.q
                             * OPS_PER_POPULATION[fragment])[0]
            t = timing["turns"]
            replay = ("" if timing["replay_ms"] is None else
                      f"; replay {timing['replay_ms']:.4f} ms per blocked "
                      f"launch")
            plan = sc.march_plan(flow.f, flow.stencil.e, span, masked=True,
                                 frozen=params["nsm"] is not None)
            gbps = nbytes * cells / (timing["ms"] * 1e-3) / 1e9
            print(f"phase 30: {cell} {simulation.step_path}: {mlups:.1f} "
                  f"MLUPS ({mlups / x1_mlups:.2f}x the x1 run's "
                  f"{x1_mlups:.1f}), {blocked[key]} masked K2 launches for "
                  f"120 steps ({1 / span:.2f} per step), mass drift "
                  f"{drift:.2e}, 8 steps vs x1 {err8:.3e}; CUDA events in "
                  f"turns: masked K2 {t[2]:.4f} / {t[3]:.4f} ms per launch "
                  f"({timing['ms'] / span:.4f} ms per step, bound "
                  f"{bound_ms:.4f} ms per launch at {nbytes} B per cell, "
                  f"{gbps:.1f} GB/s, {gbps / saxpy_gbps:.1%} of the saxpy; "
                  f"the cube: {cube_ms(cell, 'f32', span)} ms), "
                  f"masked K1 {t[1]:.4f} / {t[4]:.4f} ms per step, plain "
                  f"x{span} {t[0]:.2f} / {t[5]:.2f} ms; max |K2 - plain| "
                  f"{timing['err']:.3e}{replay}; plan: {plan_text(plan)} "
                  f"({card})")
            runs[f"{key}[{cell}]"] = dict(
                timing, mlups=mlups, x1_mlups=x1_mlups, launches=blocked[key],
                span=span, suffix="f32", cells=cells, bytes=nbytes,
                fragment=fragment, q=flow.stencil.q, cell=cell, drift=drift,
                err8=err8)
            del simulation, flow
            torch.cuda.empty_cache()
        del ref8
        torch.cuda.empty_cache()

    # Couette and the cavity under half storage at span 2
    for cell, fragment, make_flow, make_collision in bounded_cells()[2:]:
        simulation = bounded_simulation(make_flow, make_collision, 2,
                                        half=True)
        flow = simulation.flow
        check(simulation.step_path == "cuda x2"
              and simulation.half_storage_engaged,
              f"{cell} half at span 2: {simulation.step_path}")
        mass0 = torch.sum(flow.f, dtype=torch.float64).item()
        reset_launch_counts()
        simulation(20)
        mlups = simulation(100)
        torch.cuda.synchronize()
        key = f"masked_{fragment}_bf16_dev_x2"
        blocked = multi_launches()
        check(blocked == {key: 60} and not half_launches(),
              f"{cell} half x2: launches {blocked}, {half_launches()}")
        check(bool(torch.isfinite(flow.f).all()), f"{cell} half: not finite")
        drift = abs(torch.sum(flow.f, dtype=torch.float64).item()
                    - mass0) / mass0
        check(drift < 1e-4, f"{cell} half x2: mass drift {drift}")
        timing = masked_multi_timing(simulation, 2, True)
        params = simulation._half_multi[0].params
        nbytes = masked_bytes(simulation, params)
        cells = flow.f[0].numel()
        t = timing["turns"]
        bound_ms = bound(cells, nbytes, 2 * flow.stencil.q
                         * OPS_PER_POPULATION[fragment])[0]
        plan = sc.march_plan(simulation._encode(flow.f), flow.stencil.e, 2,
                             masked=True, frozen=params["nsm"] is not None)
        gbps = nbytes * cells / (timing["ms"] * 1e-3) / 1e9
        print(f"phase 30: {cell} half storage {simulation.step_path}: "
              f"{mlups:.1f} MLUPS, {blocked[key]} masked bf16-dev K2 "
              f"launches for 120 steps, mass drift {drift:.2e}; CUDA events "
              f"in turns: masked K2 {t[2]:.4f} / {t[3]:.4f} ms per launch "
              f"({timing['ms'] / 2:.4f} ms per step, bound {bound_ms:.4f} ms "
              f"per launch at {nbytes} B per cell, {gbps:.1f} GB/s, "
              f"{gbps / saxpy_gbps:.1%} of the saxpy; the cube: "
              f"{cube_ms(cell, 'bf16_dev', 2)} ms), masked K1e "
              f"{t[1]:.4f} / {t[4]:.4f} ms per step, plain x2 "
              f"{t[0]:.2f} / {t[5]:.2f} ms; max |K2 - plain| "
              f"{timing['err']:.3e}; plan: {plan_text(plan)} ({card})")
        runs[f"{key}[{cell}]"] = dict(
            timing, mlups=mlups, launches=blocked[key], span=2,
            suffix="bf16_dev", cells=cells, bytes=nbytes, fragment=fragment,
            q=flow.stencil.q, cell=cell, drift=drift)
        del simulation, flow
        torch.cuda.empty_cache()
    return runs


def phase31_cavity_gate_blocked(card, x1_deviation):
    """Phase 11's Ghia cavity gate (256^2, Re 100, Ma 0.05, float32) at
    LETTUCE_NSUB=2: the masked blocked kernel steps it to the same gate,
    its deviation printed beside the single-step run's."""
    with_span(2)
    simulation = cavity_simulation(True)
    with_span(None)
    check(simulation.step_path == "cuda x2",
          f"blocked cavity runs {simulation.step_path!r}")
    reset_launch_counts()
    gate = cavity_gate(simulation)
    launched = multi_launches()
    check(launched == {"masked_bgk_f32_x2": gate["steps"] // 2}
          and masked_launch_counts() == (0, 0, 0),
          f"blocked cavity launches {launched} for {gate['steps']} steps")
    print(f"phase 31: cavity 256^2 Re 100 Ma 0.05 float32, "
          f"{simulation.step_path}: {gate['steps']} steps in "
          f"{launched['masked_bgk_f32_x2']} masked K2 launches "
          f"({'converged' if gate['change'] < 1e-4 else 'not converged'}, "
          f"last change {gate['change']:.2e}) in {gate['seconds']:.2f} s, "
          f"{gate['mlups']:.1f} MLUPS; max deviation from Ghia "
          f"{gate['dev']:.5f} (x1: {x1_deviation:.5f}), rms "
          f"{gate['rms']:.5f} (gate {GHIA_GATE}) ({card})")
    check(gate["dev"] < GHIA_GATE, f"blocked cavity deviation {gate['dev']}")
    del simulation
    torch.cuda.empty_cache()
    return gate


# ----------------------------------------------------------------------
# the gradient of a 16-bit state: K1d, K3 and K4 at 16 bits
# ----------------------------------------------------------------------
# the adjoints of a 16-bit state: csrc/adjoint_half.cu (K3 at 16 bits) and
# csrc/adjoint_multi_half.cu (K4 at 16 bits); the emit-u forward of a
# 16-bit state lives in csrc/half_*.cu
ADJOINT_HALF_SOURCE = "lettuce_tpu_torch/csrc/adjoint_half.cu"
ADJOINT_MULTI_HALF_SOURCE = "lettuce_tpu_torch/csrc/adjoint_multi_half.cu"
# the TPU kernels' 16-bit storage with float32 compute: the adjoint's
# compute_dtype (:167-174) and emit-u's float32 u (:1778-1779)
ADJOINT_HALF_REPLACES = "lettuce_tpu/ops/pallas/adjoint.py:167"
EMIT_U_HALF_REPLACES = "lettuce_tpu/ops/pallas/stream_collide.py:1778"
# D3Q19 at 16 bits: q populations in and out, 2 bytes each, plus 3 float32
# u components (the emit-u forward writes them, the adjoint reads them)
HALF_GRAD_BYTES_PER_UPDATE = 19 * 2 * 2 + 3 * 4
# K4 at 16 bits reads f and g and writes the cotangent once per launch
ADJOINT_MULTI_HALF_BYTES_PER_UPDATE = 19 * 2 * 3
# the float32 floor K4's bar adds per sub-step at the largest magnitude
F32_FLOOR = 2.0 ** -23
# a 16-bit gradient against the float32 one, at its largest magnitude:
# the bar half storage's u is held to (phase 23). It holds for float16
# (8 single steps) and the span-2 bfloat16 gradient (4 roundings each
# way), not for 8 single bfloat16 steps: 2.2 % on the card at 256^3, as
# the plain versions on the CPU (1.5-2.0 % at 16^3-128^3) and
# lettuce_tpu's own bfloat16 gradient (1.5 % at 32^2, where the port's
# reads 1.2 %), so that one is reported and its kernels are held to the
# plain chain at 16 bits instead
HALF_GRAD_RTOL = 0.02


def half_adjoint_launches():
    """Adjoint launches at 16 bits, BGK included ("bgk_bf16",
    "masked_matvec_f16", "frozen_none_bf16", ...)."""
    return launched("K3", HALF_STORAGE)


def ulps_at_max(got, ref):
    """(|got - ref| in storage ulps at ref's largest magnitude, that
    magnitude, max |got - ref|, that ulp)."""
    a, b = got.double(), ref.double()
    scale = b.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - MANTISSA_BITS[got.dtype])
    err = (a - b).abs().max().item()
    return err / ulp, scale, err, ulp


def phase32_half_gradient_instances_vs_plain():
    """Every instance of a 16-bit state's gradient against its plain
    version on the grids of phase 2, bfloat16 and float16, one launch
    each: K1d at 16 bits (bgk, trt, reg, mrt_from_feq; periodic and
    masked: the state within one storage ulp entrywise, u within 5e-6);
    K3 at 16 bits for every full-mode spec (bgk, trt, matvec for reg and
    mrt_from_feq, smag, none; periodic, codes, codes+frozen and the
    nsm-only entry split mode runs: within one storage ulp at the largest
    magnitude); K4 at 16 bits per blocked spec at n_sub 2, 3 and 4 (one
    storage ulp plus n_sub float32 floors at the largest magnitude)."""
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    worst = {}
    seed = 3200
    count = 0

    def note(key, err, ulps):
        w_err, w_ulps = worst.get(key, (0.0, 0.0))
        worst[key] = (max(w_err, err), max(w_ulps, ulps))

    for stencil, shape in phase2_cases():
        name = type(stencil).__name__
        d = stencil.d
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=False)
        flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                    stencil=stencil, initialize_fneq=False)
        collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                      **fragment_collisions(flow, FRAGMENT_TAU)}
        for fragment, collision in collisions.items():
            spec = fragment_spec(flow, collision)
            if spec.mode == "split":
                continue  # K1f forward (phase 22), the none adjoint here
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    spec[1] if fragment == "bgk" else None)
            line = []
            for dtype, suffix in HALF_KEYS.items():
                seed += 1
                f32, _ = tgv_state(stencil, shape, torch.float32, seed)
                x = f32.to(dtype)
                masks = bounded_case(stencil, shape, torch.float32, seed)[1]
                masks["feq_field"] = masks["feq_field"].to(dtype)
                g = torch.as_tensor(np.random.default_rng(seed)
                                    .standard_normal(tuple(x.shape)),
                                    dtype=torch.float32,
                                    device="cuda").to(dtype)
                readings = []
                if fragment in sc.EMIT_U_FRAGMENTS:
                    for variant, mk in (("emit_u_", {}),
                                        ("masked_emit_u_", masks)):
                        key = f"{variant}{fragment}_{suffix}"
                        before = half_launches().get(key, 0)
                        u = torch.empty((d, *shape), dtype=torch.float32,
                                        device="cuda")
                        out, _ = sc.stream_collide(x, *args, **mk, u_out=u,
                                                   collision_spec=spec)
                        torch.cuda.synchronize()
                        launched = half_launches().get(key, 0) - before
                        ref, u_ref = sc.stream_collide_plain(
                            x, *args, **mk, collision_spec=spec,
                            emit_u=True)
                        ulps, _, err = check_storage(out, ref, suffix,
                                                     f"{key} {name}")
                        err_u = (u - u_ref).abs().max().item()
                        check(launched == 1, f"{key} {name}: {launched} "
                                             f"launches")
                        check(u_ref.dtype == torch.float32
                              and bool(torch.isfinite(u).all())
                              and err_u <= ATOL[torch.float32],
                              f"{key} {name}: u error {err_u}")
                        note(key, max(err, err_u), ulps)
                        readings.append(f"{variant}fwd {ulps:.2f}")
                        count += 1
                res = None
                if spec.residual == "u":
                    _, res = sc.stream_collide_plain(x, *args,
                                                     collision_spec=spec,
                                                     emit_u=True)
                elif spec.residual == "f":
                    res = x
                kind = spec.adjoint[0]
                codes = dict(masks, nsm=None)
                for label, variant, mk in (
                        ("periodic", "", {}), ("codes", "masked_", codes),
                        ("codes+frozen", "masked_", masks),
                        ("nsm-only", "frozen_", {"nsm": masks["nsm"]})):
                    key = f"{variant}{kind}_{suffix}"
                    before = half_adjoint_launches().get(key, 0)
                    ct = adjoint.stream_collide_adjoint(
                        g, res, *args, **mk, collision_spec=spec)
                    torch.cuda.synchronize()
                    launched = half_adjoint_launches().get(key, 0) - before
                    ref = adjoint.stream_collide_adjoint_plain(
                        g, res, *args, **mk, collision_spec=spec)
                    ulps, scale, err, _ = ulps_at_max(ct, ref)
                    check(launched == 1, f"adjoint {key} {name}: "
                                         f"{launched} launches")
                    check(ct.dtype == dtype
                          and bool(torch.isfinite(ct.float()).all())
                          and ulps <= 1.0,
                          f"adjoint {key} ({fragment}, {label}) {name}: "
                          f"{ulps:.2f} ulps at {scale:.3e}")
                    note("adjoint_" + key, err, ulps)
                    readings.append(f"adjoint {label} {ulps:.2f}")
                    count += 1
                if fragment in adjoint.ADJOINT_MULTI_FRAGMENTS:
                    for span in (2, 3, 4):
                        key = f"{fragment}_{suffix}_x{span}"
                        before = adjoint_multi_launches().get(key, 0)
                        ct = adjoint.stream_collide_adjoint_multi(
                            x, g, span, *args, collision_spec=spec)
                        torch.cuda.synchronize()
                        launched = (adjoint_multi_launches().get(key, 0)
                                    - before)
                        ref = adjoint.stream_collide_adjoint_multi_plain(
                            x, g, span, *args, collision_spec=spec)
                        ulps, scale, err, ulp = ulps_at_max(ct, ref)
                        bar = 1.0 + span * F32_FLOOR * scale / ulp
                        check(launched == 1, f"K4 {key} {name}: {launched} "
                                             f"launches")
                        check(ct.dtype == dtype
                              and bool(torch.isfinite(ct.float()).all())
                              and ulps <= bar,
                              f"K4 {key} {name}: {ulps:.2f} ulps at "
                              f"{scale:.3e} (bar {bar:.3f})")
                        note("multi_" + key, err, ulps)
                        readings.append(f"K4 x{span} {ulps:.2f}")
                        count += 1
                line.append(f"{suffix} " + ", ".join(readings))
            print(f"phase 32: {fragment} {name} {'x'.join(map(str, shape))} "
                  f"(ulps; adjoints at the largest magnitude): "
                  + "; ".join(line))
    print(f"phase 32: {count} launches of 16-bit gradient instances, each "
          f"within its bar of plain")
    return worst


def half_plain_chain(params, f0, blocked=False):
    """The gradient of sum(f_8^2) through the plain versions at 16 bits:
    8 plain emit-u steps saving u, then 8 plain adjoint steps (with
    ``blocked``, 4 plain K2 launches of 2 steps saving each input, then 4
    plain K4 launches), from the cotangent the loss hands the segment's
    16-bit output."""
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    with torch.no_grad():
        x, saved = f0.detach(), []
        if blocked:
            for _ in range(SEGMENT_STEPS // 2):
                saved.append(x)
                x = sc.stream_collide_plain(x, **params, n_sub=2)
        else:
            for _ in range(SEGMENT_STEPS):
                x, u = sc.stream_collide_plain(x, **params, emit_u=True)
                saved.append(u)
        ct = (2 * x.float()).to(x.dtype)
        del x
        while saved:
            if blocked:
                ct = adjoint.stream_collide_adjoint_multi_plain(
                    saved.pop(), ct, 2, **params)
            else:
                ct = adjoint.stream_collide_adjoint_plain(ct, saved.pop(),
                                                          **params)
    return ct


def half_gradient_cell(card, saxpy_gbps, cell, simulation, reference,
                       seed, rtol=None, repeats=50, chain=False):
    """One 16-bit gradient cell on the kernel path: the 8-step gradient of
    sum(f_8^2) through make_segment_fn with its launch counts (every one a
    16-bit instance) and peak memory above the state, the count of inf and
    subnormal entries, with ``chain`` the gradient against the plain
    versions' chain at 16 bits (half_plain_chain; one storage ulp per
    step at its largest magnitude), the gradient against the float32
    ``reference`` simulation's from the upcast state (at most ``rtol`` of
    its largest magnitude when given, else reported), fwd+bwd MLUPS (3
    repeats after a warm-up), and per launch the forward and adjoint
    kernels against their plain versions by CUDA events, in turns."""
    flow = simulation.flow
    dtype = flow.f.dtype
    suffix = HALF_KEYS[dtype]
    params = simulation._kernel_params
    spec = params["collision_spec"]
    masked = params.get("ncm") is not None
    fwd_key = (("masked_" if masked else "")
               + ("emit_u_" if spec.residual == "u" else "")
               + f"{spec.fragment}_{suffix}")
    if spec.mode == "full":
        adj_variant = "masked_" if masked else ""
    else:
        adj_variant = "frozen_" if params.get("nsm") is not None else ""
    adj_key = f"{adj_variant}{adjoint_key(spec)}_{suffix}"
    f0 = flow.f.detach().clone().requires_grad_(True)
    cells = f0[0].numel()

    def grad_of(seg, x):
        (grad,) = torch.autograd.grad((seg(x).float() ** 2).sum(), x)
        return grad

    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grad = grad_of(segment, f0)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launches = (half_launches(), half_adjoint_launches())
    check(launches == ({fwd_key: SEGMENT_STEPS}, {adj_key: SEGMENT_STEPS})
          and launch_counts() == (0, 0, 0)
          and masked_launch_counts() == (0, 0, 0)
          and not fragment_launches() and not adjoint_fragment_launches()
          and not multi_launches() and not adjoint_multi_launches(),
          f"{cell}: launches {launches}, float32 {launch_counts()}, "
          f"{fragment_launches()}, {adjoint_fragment_launches()}")
    wide = grad.float()
    n_inf = int((~torch.isfinite(wide)).sum())
    n_sub = int(((wide != 0) & (wide.abs() < torch.finfo(dtype).tiny))
                .sum())
    check(n_inf == 0 and wide.abs().max().item() > 0,
          f"{cell}: {n_inf} non-finite entries, or a zero gradient")
    chain_ulps = None
    if chain:
        chain_ulps = ulps_at_max(grad, half_plain_chain(params, f0))[0]
        check(chain_ulps <= SEGMENT_STEPS,
              f"{cell}: {str(dtype)[6:]} gradient vs the plain chain "
              f"{chain_ulps:.2f} ulps at the largest magnitude")
    x32 = f0.detach().float().requires_grad_(True)
    grad32 = grad_of(reference.make_segment_fn(SEGMENT_STEPS), x32)
    err_g, scale_g = scaled_err(wide, grad32)
    del wide, x32, grad32
    if rtol is not None:
        check(err_g <= rtol * scale_g,
              f"{cell}: {str(dtype)[6:]} gradient vs float32 {err_g} of "
              f"{scale_g}")
    grad_of(segment, f0)
    torch.cuda.synchronize()
    beg = time.perf_counter()
    for _ in range(3):
        grad_of(segment, f0)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / 3
    mlups = cells * SEGMENT_STEPS / seconds / 1e6
    del grad
    torch.cuda.empty_cache()

    f = f0.detach()
    g = torch.randn(f.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda").to(dtype)
    (forward, forward_plain, backward, backward_plain, vjp, out, ct,
     res) = kernel_pair(params, f, g)
    forward()
    ref = forward_plain()
    torch.cuda.synchronize()
    if spec.residual == "u":
        ref, ref_u = ref
        err_u = (res - ref_u).abs().max().item()
        check(res.dtype == torch.float32 and err_u <= ATOL[torch.float32],
              f"{cell}: emitted u {res.dtype}, error {err_u}")
        del ref_u
    else:
        err_u = 0.0
    fwd_ulps, _, err_f = check_storage(out, ref, suffix, f"{cell} forward")
    del ref
    backward()
    ref = backward_plain()
    torch.cuda.synchronize()
    adj_ulps, scale_a, err_a, _ = ulps_at_max(ct, ref)
    del ref
    torch.cuda.empty_cache()
    check(adj_ulps <= 1.0, f"{cell} adjoint vs plain: {adj_ulps:.2f} ulps "
                           f"at {scale_a:.3e}")
    fwd_ms, fwd_plain_ms, fwd_turns = time_in_turns(
        forward, forward_plain, kernel_repeats=repeats, plain_repeats=2)
    adj_ms, adj_plain_ms, adj_turns = time_in_turns(
        backward, backward_plain, kernel_repeats=repeats, plain_repeats=2)
    vjp_ms = None if vjp is None else cuda_ms(vjp, 3)
    q, d = np.asarray(params["e"]).shape
    code = 1 if masked else 0
    fwd_bytes = 2 * q * 2 + (4 * d if spec.residual == "u" else 0) + code
    adj_bytes = (2 * q * 2 + {"u": 4 * d, "f": 2 * q, None: 0}[spec.residual]
                 + code if spec.mode == "full" else 2 * q * 2)
    fwd_bound = fwd_bytes * cells / HBM_BYTES_PER_S * 1e3
    adj_bound = adj_bytes * cells / HBM_BYTES_PER_S * 1e3
    saxpy_b = 1e9 * saxpy_gbps
    print(f"phase 33: {cell} {str(dtype)[6:]} ({spec.mode} mode, {fwd_key} "
          f"+ {adj_key}), {simulation.step_path}: {SEGMENT_STEPS}-step "
          f"gradient launches {launches}; {n_inf} inf, {n_sub} subnormal "
          f"entries; "
          + ("" if chain_ulps is None else
             f"vs the plain chain {chain_ulps:.2f} ulps at the largest "
             f"magnitude (bar {SEGMENT_STEPS}); ")
          + f"vs the float32 gradient {err_g:.3e} of {scale_g:.3e} "
          f"({err_g / scale_g:.2e}"
          + (f", bar {rtol:.0%}" if rtol is not None else ", reported")
          + f"); peak memory above the state {peak:.2f} GiB; fwd+bwd "
          f"{mlups:.1f} MLUPS ({seconds * 1e3:.2f} ms per gradient); per "
          f"launch, CUDA events: forward {fwd_turns[1]:.4f} / "
          f"{fwd_turns[2]:.4f} ms (plain {fwd_turns[0]:.4f} / "
          f"{fwd_turns[3]:.4f}; {fwd_bytes} B/update, bound "
          f"{fwd_bound:.4f} ms at 3.35 TB/s, "
          f"{fwd_bytes * cells / saxpy_b * 1e3:.4f} at the saxpy), adjoint "
          f"{adj_turns[1]:.4f} / {adj_turns[2]:.4f} ms (plain "
          f"{adj_turns[0]:.4f} / {adj_turns[3]:.4f}; {adj_bytes} B/update, "
          f"bound {adj_bound:.4f} ms at 3.35 TB/s, "
          f"{adj_bytes * cells / saxpy_b * 1e3:.4f} at the saxpy)"
          + ("" if vjp_ms is None else
             f", split mode's pointwise VJP in torch {vjp_ms:.4f} ms")
          + f"; kernel vs plain: forward {fwd_ulps:.2f} ulps (u "
          f"{err_u:.1e}), adjoint {adj_ulps:.2f} ulps at the largest "
          f"magnitude ({card})")
    del f0, f, g, out, ct, res, segment
    torch.cuda.empty_cache()
    fragment = spec.fragment
    return dict(
        cell=cell, mode=spec.mode, dtype=dtype, mlups=mlups, err=err_g,
        scale=scale_g, peak=peak, n_inf=n_inf, n_sub=n_sub,
        chain_ulps=chain_ulps,
        forward=dict(key=fwd_key, launches=SEGMENT_STEPS,
                     err=max(err_f, err_u), ms=fwd_ms, plain_ms=fwd_plain_ms,
                     cells=cells, bytes=fwd_bytes,
                     ops=q * OPS_PER_POPULATION[
                         "emit_u" if spec.residual == "u"
                         and fragment == "bgk" else fragment],
                     fragment=fragment, emit_u=spec.residual == "u"),
        adjoint=dict(key=adj_key, launches=SEGMENT_STEPS, err=err_a,
                     ms=adj_ms, plain_ms=adj_plain_ms, cells=cells,
                     bytes=adj_bytes,
                     ops=q * OPS_PER_POPULATION[
                         "adjoint_" + adjoint_key(spec)],
                     spec=adjoint_key(spec)),
        vjp_ms=vjp_ms)


def half_gradient_cells():
    """The 16-bit gradient cells beside the main path, in bfloat16: the
    full-mode fragment cells of phase 20 (TRT, MRT from_feq, Smagorinsky
    D3Q19 and regularized D3Q27, 256^3), split mode's Guo BGK D2Q9 2048^2,
    and obstacle2d_2048 through the masked kernels and the replay: (cell,
    flow factory, collision factory). The MRT transform is built in
    float32: a bfloat16 transform would round M^-1."""
    import lettuce_tpu_torch as lt
    cells = {cell: (make_flow, make_collision)
             for cell, make_flow, make_collision, _ in gradient_cells()}

    def mrt(flow):
        wide = lt.Context(device="cuda", dtype=torch.float32)
        return lt.MRTCollision(lt.D3Q19DHumieres(flow.stencil, wide),
                               [flow.units.relaxation_parameter_lu] * 19,
                               wide)

    def obstacle(context):
        flow = obstacle_flow(context)
        if context.dtype != torch.float32:
            wide = lt.Context(device="cuda", dtype=torch.float32)
            flow.mask = obstacle_flow(wide).mask
            flow.initialize()
        return flow

    return [
        ("trt3d_256_d3q19", *cells["trt3d_256_d3q19"]),
        ("mrt3d_256_d3q19", cells["mrt3d_256_d3q19"][0], mrt),
        ("smagorinsky_d3q19", *cells["smagorinsky_d3q19"]),
        ("reg3d_256_d3q27", *cells["reg3d_256_d3q27"]),
        ("bgk_guo_d2q9", *cells["bgk_guo_d2q9"]),
        ("obstacle2d_2048", obstacle,
         lambda flow: lt.BGKCollision(flow.units.relaxation_parameter_lu)),
    ]


def phase33_half_gradient_path(card, saxpy_gbps, single_mlups):
    """The gradient of a 16-bit state at full width: the main path (D3Q19
    BGK TGV 256^3) in bfloat16 and float16 through make_segment_fn(8),
    each within one storage ulp per step of the plain chain at 16 bits,
    against the float32 gradient of the same loss from the upcast state
    (float16 within 2 %, bfloat16 reported: HALF_GRAD_RTOL); then the
    cells of half_gradient_cells in bfloat16, each
    against its float32 gradient (reported). Launch counts, inf and
    subnormal counts, peak memory, fwd+bwd MLUPS, and K1d and K3 at 16
    bits per launch against plain and their bounds (half_gradient_cell)."""
    import lettuce_tpu_torch as lt
    runs = []
    for seed, dtype in enumerate((torch.bfloat16, torch.float16),
                                 start=3300):
        simulation = tgv256(lt.Context(device="cuda", dtype=dtype,
                                       use_native=True))
        check(simulation.step_path == "cuda x1"
              and simulation.adjoint_mode == "full",
              f"{dtype} main path: {simulation.step_path}, "
              f"{simulation.adjoint_mode}")
        # float16 keeps the 2 % bar; bfloat16 reads 2.2 % at 8
        # steps (HALF_GRAD_RTOL's note), so its distance is reported and
        # its kernels are held to the plain chain at full width
        runs.append(half_gradient_cell(
            card, saxpy_gbps, "tgv3d_256_d3q19", simulation,
            tgv256_simulation(), seed, repeats=100, chain=True,
            rtol=HALF_GRAD_RTOL if dtype == torch.float16 else None))
        del simulation
        torch.cuda.empty_cache()
    print(f"phase 33: main path fwd+bwd bfloat16 {runs[0]['mlups']:.1f}, "
          f"float16 {runs[1]['mlups']:.1f} MLUPS against float32's "
          f"{single_mlups:.1f} (phase 7) ({card})")
    for seed, (cell, make_flow, make_collision) in enumerate(
            half_gradient_cells(), start=3310):
        flows = [make_flow(lt.Context(device="cuda", dtype=dtype,
                                      use_native=True))
                 for dtype in (torch.bfloat16, torch.float32)]
        simulation, reference = (lt.Simulation(flow, make_collision(flow),
                                               []) for flow in flows)
        check(simulation.step_path == reference.step_path
              and simulation._step_kind == "cuda"
              and simulation.adjoint_mode == reference.adjoint_mode,
              f"{cell}: {simulation.step_path}, {simulation.adjoint_mode}")
        runs.append(half_gradient_cell(card, saxpy_gbps, cell, simulation,
                                       reference, seed, repeats=50))
        del simulation, reference, flows
        torch.cuda.empty_cache()
    return runs


def phase34_half_blocked_gradient(card, saxpy_gbps, half_runs):
    """The blocked gradient of a bfloat16 state: the main path at
    LETTUCE_NSUB=2 through make_segment_fn(8) (4 K2 and 4 K4 launches at
    16 bits, no single-step one), within one storage ulp per launch of the
    plain chain and within 2 % of the float32 gradient;
    fwd+bwd MLUPS against phase 33's single-step bfloat16 run in this
    process; K2 + K4 at 16 bits per two steps in turns with K1d + K3 at
    16 bits, and K4 at 16 bits per launch against its plain version."""
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    with_span(2)
    simulation = tgv256(lt.Context(device="cuda", dtype=torch.bfloat16,
                                   use_native=True))
    with_span(None)
    check(simulation.step_path == "cuda x2"
          and simulation._step_multi[0].adjoint_kernel,
          f"bfloat16 blocked gradient path: {simulation.step_path}")
    f0 = simulation.flow.f.detach().clone().requires_grad_(True)
    cells = f0[0].numel()

    def grad_of(seg, x):
        (grad,) = torch.autograd.grad((seg(x).float() ** 2).sum(), x)
        return grad

    segment = simulation.make_segment_fn(SEGMENT_STEPS)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grad = grad_of(segment, f0)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    k2, k4 = multi_launches(), adjoint_multi_launches()
    check(k2 == {"bgk_bf16_x2": 4} and k4 == {"bgk_bf16_x2": 4}
          and not half_launches() and not half_adjoint_launches()
          and launch_counts() == (0, 0, 0),
          f"bfloat16 blocked gradient: K2 {k2}, K4 {k4}, single-step "
          f"{half_launches()}, {half_adjoint_launches()}")
    wide = grad.float()
    check(bool(torch.isfinite(wide).all()) and wide.abs().max().item() > 0,
          "bfloat16 blocked gradient not finite or zero")
    chain_ulps = ulps_at_max(grad, half_plain_chain(
        simulation._kernel_params, f0, blocked=True))[0]
    check(chain_ulps <= SEGMENT_STEPS // 2,
          f"bfloat16 blocked gradient vs the plain chain {chain_ulps:.2f} "
          f"ulps at the largest magnitude")
    x32 = f0.detach().float().requires_grad_(True)
    grad32 = grad_of(tgv256_simulation().make_segment_fn(SEGMENT_STEPS), x32)
    err, scale = scaled_err(wide, grad32)
    del wide, x32, grad32
    check(err <= HALF_GRAD_RTOL * scale,
          f"bfloat16 blocked gradient vs float32: {err} of {scale}")
    grad_of(segment, f0)
    torch.cuda.synchronize()
    beg = time.perf_counter()
    for _ in range(3):
        grad_of(segment, f0)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - beg) / 3
    mlups = cells * SEGMENT_STEPS / seconds / 1e6
    del grad
    torch.cuda.empty_cache()

    params = simulation._kernel_params
    f = f0.detach()
    g1 = torch.randn(f.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(34), device="cuda").to(torch.bfloat16)
    out, ct = torch.empty_like(f), torch.empty_like(f)
    u = torch.empty((3, *f.shape[1:]), dtype=torch.float32, device="cuda")
    got = adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)
    ref = adjoint.stream_collide_adjoint_multi_plain(f, g1, 2, **params)
    torch.cuda.synchronize()
    ulps4, scale4, err4, ulp4 = ulps_at_max(got, ref)
    bar = 1.0 + 2 * F32_FLOOR * scale4 / ulp4
    check(ulps4 <= bar, f"256^3 K4 bf16 vs plain: {ulps4:.2f} ulps")
    del ref, got

    def single_pair():
        for _ in range(2):
            sc.stream_collide(f, **params, out=out, u_out=u)
            adjoint.stream_collide_adjoint(g1, u, **params, out=ct)

    def blocked_pair():
        sc.stream_collide(f, **params, out=out, n_sub=2)
        adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)

    def k2_launch():
        sc.stream_collide(f, **params, out=out, n_sub=2)

    def k4_launch():
        adjoint.stream_collide_adjoint_multi(f, g1, 2, **params, out=ct)

    def k4_plain():
        adjoint.stream_collide_adjoint_multi_plain(f, g1, 2, **params)

    single_pair()
    blocked_pair()
    s_a = cuda_ms(single_pair, 20)
    b_a = cuda_ms(blocked_pair, 20)
    b_b = cuda_ms(blocked_pair, 20)
    s_b = cuda_ms(single_pair, 20)
    k2_ms = cuda_ms(k2_launch, 20)
    k4_ms, k4_plain_ms, turns = time_in_turns(k4_launch, k4_plain,
                                              kernel_repeats=20,
                                              plain_repeats=2)
    single_mlups = half_runs[0]["mlups"]
    bytes4 = ADJOINT_MULTI_HALF_BYTES_PER_UPDATE
    print(f"phase 34: {SEGMENT_STEPS}-step gradient at 256^3 bfloat16, span "
          f"2: K2 {k2}, K4 {k4}, no single-step launch; vs the plain chain "
          f"{chain_ulps:.2f} ulps at the largest magnitude (bar "
          f"{SEGMENT_STEPS // 2}); vs the float32 "
          f"gradient {err:.3e} of {scale:.3e} ({err / scale:.2e}, bar "
          f"{HALF_GRAD_RTOL:.0%}); fwd+bwd {mlups:.1f} MLUPS ({seconds * 1e3:.2f}"
          f" ms per gradient) against the single-step bfloat16 kernels' "
          f"{single_mlups:.1f} (phase 33); peak memory above the state "
          f"{peak:.2f} GiB; per step, CUDA events in turns: K1d + K3 at 16 "
          f"bits {s_a / 2:.4f} / {s_b / 2:.4f} ms, K2 + K4 at span 2 "
          f"{b_a / 2:.4f} / {b_b / 2:.4f} ms; K2 per launch {k2_ms:.4f} ms; "
          f"K4 per launch {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
          f"{turns[0]:.2f} / {turns[3]:.2f} ms, {ulps4:.2f} ulps from plain "
          f"at {scale4:.3e}; {bytes4} B per update per launch, bound "
          f"{bytes4 * cells / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s, "
          f"{bytes4 * cells / (1e9 * saxpy_gbps) * 1e3:.4f} at the saxpy "
          f"({card})")
    e = simulation.flow.stencil.e
    k4_plan = sc.march_plan(f, e, 2, adjoint=True,
                            halo=adjoint.adjoint_multi_halo(2))
    print(f"phase 34: K2 bf16 x2 plan: {plan_text(sc.march_plan(f, e, 2))}"
          f"; K4@16 x2 plan: {plan_text(k4_plan)}")
    del simulation, f0, f, out, ct, u, g1, segment
    torch.cuda.empty_cache()
    return dict(k2_launches=k2["bgk_bf16_x2"], k4_launches=k4["bgk_bf16_x2"],
                err=err4, ms=k4_ms, plain_ms=k4_plain_ms, cells=cells,
                mlups=mlups, peak=peak, k2_ms=k2_ms,
                pair_ms=(b_a + b_b) / 4, single_pair_ms=(s_a + s_b) / 4)


# ----------------------------------------------------------------------
# the march's plans at full width
# ----------------------------------------------------------------------
def phase35_march_candidates(card, saxpy_gbps):
    """The planner's candidates (build.march_candidates: per budget, two
    blocks or one per SM, its best cross-section, its best with rows
    narrower and wider than 32 values, and its best cut into twice the
    units) for the main path's launches: K2 on D3Q19 BGK 256^3 in float32
    and bfloat16 deviations at x2 and x4, K4 in float32 and bfloat16 at x2;
    then the masked K2's candidates (per row budget, 3-8 blocks per SM) on
    the 2048^2 Couette and the obstacle at x2 and x4, and the periodic 2D
    march on tgv2d_2048_d2q9 (D2Q9 BGK 2048^2 float32) at x2, its default
    and the row budgets' plans, as the masks-free ceiling (a record: the
    periodic default stays). Each candidate's output against its default
    plan's (bitwise, else the difference is printed); each timed by CUDA
    events in turns with the single-step kernel of its launch (K1a, or
    K1b for a masked one: K1, every candidate, every candidate in reverse,
    K1); ms per launch and per step, the share of the saxpy, the default
    and the fastest."""
    from lettuce_tpu_torch.ops.cuda import adjoint
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    simulation = tgv256_simulation()
    params = simulation._kernel_params
    spec, e, cs = params["collision_spec"], params["e"], params["cs"]
    f32 = simulation.flow.f
    cells = f32[0].numel()
    k1_out = torch.empty_like(f32)
    g = torch.randn(f32.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(35), device="cuda")

    def k1a():
        sc.stream_collide(f32, **params, out=k1_out)

    groups = []
    for suffix, span in (("f32", 2), ("f32", 4), ("bf16_dev", 2),
                         ("bf16_dev", 4)):
        dev = suffix == "bf16_dev"
        x = sc.encode_deviations(f32, params["w"]) if dev else f32
        out = torch.empty_like(x)

        def k2(plan, x=x, out=out, span=span, dev=dev):
            return sc._launch_multi(x, out, spec, span, e, cs, dev,
                                    plan=plan)
        groups.append((f"K2 {suffix} x{span}", span, 19 * 2 * (
            2 if dev else 4), cells, sc.march_plan(x, e, span,
                                                   candidates=True),
            k2, k1a, "K1a"))
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, gx = f32.to(dtype), g.to(dtype)
        out = torch.empty_like(gx)

        def k4(plan, x=x, gx=gx, out=out):
            return adjoint._launch_adjoint_multi(x, gx, out, spec, 2, e, cs,
                                                 plan)
        groups.append((f"K4 {suffix} x2", 2, 19 * 3 * (4 if suffix == "f32"
                                                       else 2), cells,
                       sc.march_plan(gx, e, 2, adjoint=True,
                                     halo=adjoint.adjoint_multi_halo(2),
                                     candidates=True), k4, k1a, "K1a"))
    time_candidates(groups, card, saxpy_gbps)
    del simulation, f32, g, k1_out, groups
    torch.cuda.empty_cache()

    # the masked K2 on the 2D bounded cells, and the periodic 2D ceiling
    cells2d = bounded_cells()
    for cell, _, make_flow, make_collision in (cells2d[2], cells2d[0]):
        for span in (2, 4):
            bounded = bounded_simulation(make_flow, make_collision, span)
            masked = bounded._step_multi[0].params
            single = bounded._kernel_params
            x = bounded.flow.f
            out, k1_out = torch.empty_like(x), torch.empty_like(x)

            def k2(plan, x=x, out=out, span=span, masked=masked):
                return sc._launch_multi(
                    x, out, masked["collision_spec"], span, masked["e"],
                    masked["cs"], False, ncm=masked["ncm"],
                    nsm=masked["nsm"], table=masked["table"],
                    feq_field=masked["feq_field"], plan=plan)

            def k1b(x=x, k1_out=k1_out, single=single):
                sc.stream_collide(x, **single, out=k1_out)
            plans = sc.march_plan(x, masked["e"], span, candidates=True,
                                  masked=True,
                                  frozen=masked["nsm"] is not None)
            time_candidates([(f"K2 masked {cell} f32 x{span}", span,
                              masked_bytes(bounded, masked), x[0].numel(),
                              plans, k2, k1b, "K1b")], card, saxpy_gbps)
            del bounded, masked, single, x, out, k1_out
            torch.cuda.empty_cache()
    import lettuce_tpu_torch as lt
    stencil = lt.D2Q9()
    f, tau_inv = tgv_state(stencil, (2048, 2048), torch.float32, 3500)
    spec2d = sc.pack_spec(("bgk", tau_inv), stencil.e, stencil.w,
                          stencil.opposite)
    out, k1_out = torch.empty_like(f), torch.empty_like(f)

    def k2_periodic(plan):
        return sc._launch_multi(f, out, spec2d, 2, stencil.e, stencil.cs,
                                False, plan=plan)

    def k1a_2d():
        sc.stream_collide(f, stencil.e, stencil.w, stencil.opposite,
                          stencil.cs, tau_inv, out=k1_out)
    plans = (sc.march_plan(f, stencil.e, 2),
             *sc.march_plan(f, stencil.e, 2, candidates=True, rows=True))
    time_candidates([("K2 periodic tgv2d_2048_d2q9 f32 x2 (default, then "
                      "the row budgets)", 2, 9 * 2 * 4, f[0].numel(), plans,
                      k2_periodic, k1a_2d, "K1a")], card, saxpy_gbps)
    del f, out, k1_out
    torch.cuda.empty_cache()


def time_candidates(groups, card, saxpy_gbps):
    """Phase 35's timing of each group (name, span, bytes per cell, cells,
    plans, launch(plan), its single-step kernel, that kernel's name): every
    plan's output against the first's (bitwise, else the difference), then
    CUDA events in turns (the single-step kernel, every plan, every plan in
    reverse, the single-step kernel)."""
    for name, span, nbytes, cells, plans, launch, k1, k1_name in groups:
        want = launch(plans[0]).clone()
        diffs = []
        for plan in plans[1:]:
            got = launch(plan)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            diffs.append("bitwise" if torch.equal(got, want) else
                         f"max |diff| {diff:.2e}")
        del want
        repeats = max(4, 40 // span) if cells > 1 << 22 else 100 // span
        k1()
        for plan in plans:
            launch(plan)
        k1_a = cuda_ms(k1, 50)
        first = [cuda_ms(lambda p=plan: launch(p), repeats) for plan in plans]
        second = [cuda_ms(lambda p=plan: launch(p), repeats)
                  for plan in reversed(plans)][::-1]
        k1_b = cuda_ms(k1, 50)
        ms = [(a + b) / 2 for a, b in zip(first, second)]
        fastest = min(range(len(plans)), key=ms.__getitem__)
        for i, plan in enumerate(plans):
            gbps = nbytes * cells / (ms[i] * 1e-3) / 1e9
            print(f"phase 35: {name} candidate {i}"
                  f"{' (default)' if i == 0 else ''}"
                  f"{' (fastest)' if i == fastest else ''}: "
                  f"{first[i]:.4f} / {second[i]:.4f} ms per launch "
                  f"({ms[i] / span:.4f} per step), {gbps:.1f} GB/s, "
                  f"{gbps / saxpy_gbps:.1%} of the saxpy; "
                  f"{'default' if i == 0 else diffs[i - 1]}; "
                  f"{plan_text(plan)}")
        print(f"phase 35: {name}: {k1_name} {k1_a:.4f} / {k1_b:.4f} ms per "
              f"step in the same turns; default {ms[0] / span:.4f} ms per "
              f"step, fastest candidate {fastest} {ms[fastest] / span:.4f} "
              f"({card})")
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the single-step kernels' launch: cell-flat, several cells a thread in
# the masked 16-bit instances
# ----------------------------------------------------------------------
HERMITE_REPLACES = ("lettuce_tpu/ops/pallas/stream_collide.py:"
                    f"{FRAGMENT_REPLACES['mrt_hermite27']}")
# the kernels of one single-step or adjoint launch, by template name
K1_KERNELS = ("stream_collide_kernel", "masked_stream_collide_kernel",
              "masked_cells_kernel")
K3_KERNELS = ("adjoint_kernel", "masked_adjoint_kernel")


def k1_launcher(params, f, out, plan=None, u_out=None):
    """A single-step launch of the gate's ``params`` on ``f`` into
    ``out`` over ``plan`` (the default plan when None)."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    spec = params.get("collision_spec") or ("bgk", params["tau_inv"])

    def launch():
        sc._launch(f, out, u_out, spec, params["e"], params["w"],
                   params["opposite"], params["cs"],
                   params.get("dev_storage", False), ncm=params.get("ncm"),
                   nsm=params.get("nsm"), table=params.get("table"),
                   feq_field=params.get("feq_field"), plan=plan)
    return launch


def k1_plans(params, f, out, fragment, u_out=None, cells=(None,),
             divisions=(None,), min_blocks=(None,)):
    """{label: plan} of the launch's candidates, the default first."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    plans = {}
    for c in cells:
        for division in divisions:
            for m in min_blocks:
                plan = sc.cell_plan(
                    f, params["e"], fragment, params.get("ncm") is not None,
                    params.get("dev_storage", False),
                    frozen=params.get("nsm") is not None,
                    tensors=(out, params.get("ncm"), u_out), cells=c,
                    division=division, min_blocks=m)
                label = (f"c{plan.cells}{' vec' if plan.vectors else ''} "
                         f"{plan.division} m{plan.min_blocks}")
                plans.setdefault(label, plan)
    return plans


def device_ms_per_launch(fn, names, launches=50):
    """The device ms per launch of ``fn`` under torch.profiler: the mean
    over the launches it recorded of the kernels named in ``names`` (it
    can drop records when several profiles run in one process), or None
    when it recorded none."""
    profiled = profiled_device_ms(lambda: [fn() for _ in range(launches)])
    if profiled is None:
        return None
    _, _, by_name, counts = profiled
    seen = sum(counts.get(k, 0) for k in names)
    return sum(by_name.get(k, 0.0) for k in names) / seen if seen else None


def time_in_turns_many(kernels, plain, kernel_repeats=200, plain_repeats=3):
    """{label: (first, second)} CUDA-event ms of each kernel and the plain
    version's, in turns: plain, each kernel, each kernel again in reverse,
    plain."""
    for fn in kernels.values():
        fn()
    if plain is not None:
        plain()
    first = {} if plain is None else {"plain": cuda_ms(plain, plain_repeats)}
    for label, fn in kernels.items():
        first[label] = cuda_ms(fn, kernel_repeats)
    second = {}
    for label, fn in reversed(kernels.items()):
        second[label] = cuda_ms(fn, kernel_repeats)
    if plain is not None:
        second["plain"] = cuda_ms(plain, plain_repeats)
    return {k: (first[k], second[k]) for k in first}


def k1_row(what, card, saxpy_gbps, cells, bytes_per_update, kernels, plain,
           names=K1_KERNELS, plain_repeats=3):
    """Time a row's candidates in turns with the plain version, read each
    one's device ms, print them beside the bound; returns {label: (event
    ms, device ms)} and the plain ms."""
    times = time_in_turns_many(kernels, plain, plain_repeats=plain_repeats)
    bound_ms = cells * bytes_per_update / HBM_BYTES_PER_S * 1e3
    saxpy_ms = cells * bytes_per_update / (saxpy_gbps * 1e9) * 1e3
    result = {}
    parts = []
    for label, fn in kernels.items():
        event = sum(times[label]) / 2
        device = device_ms_per_launch(fn, names)
        result[label] = (event, device)
        dev = "not measured" if device is None else f"{device:.4f}"
        share = "" if device is None else f", {saxpy_ms / device:.1%} " \
                                          f"of the saxpy"
        parts.append(f"{label}: event {times[label][0]:.4f} / "
                     f"{times[label][1]:.4f} ms, device {dev} ms{share}")
    plain_ms = None
    if plain is not None:
        plain_ms = sum(times["plain"]) / 2
    print(f"phase 36: {what}: " + "; ".join(parts)
          + (f"; plain {times['plain'][0]:.4f} / {times['plain'][1]:.4f} ms"
             if plain is not None else "")
          + f"; bound {bound_ms:.4f} ms at 3.35 TB/s, {saxpy_ms:.4f} at the "
            f"saxpy, {bytes_per_update} B/update ({card})")
    return result, plain_ms


def check_candidates_equal(kernels, outs, what):
    """Run each candidate once; every output bitwise equal to the
    first's; the outputs' clones."""
    got = []
    for fn in kernels.values():
        for out in outs:
            out.fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        got.append([out.clone() for out in outs])
    for label, outs_k in zip(kernels, got):
        for a, b in zip(got[0], outs_k):
            check(torch.equal(a.view(torch.int8), b.view(torch.int8)),
                  f"{what}: candidate {label} differs from the default")
    return got[0]


def obstacle3d_simulation(stencil, shape, make_collision, dtype=None):
    """The 3D obstacle of phase 17 (a sphere of radius 0.05 ny at 0.25 nx
    in a channel, Re 100, Ma 0.1) at ``shape`` on the card, float32."""
    import lettuce_tpu_torch as lt
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=True)
    flow = lt.Obstacle(context, list(shape), reynolds_number=100,
                       mach_number=0.1, domain_length_x=float(shape[0]),
                       stencil=stencil)
    centre = [0.25 * shape[0]] + [0.5 * n for n in shape[1:]]
    r = 0.05 * shape[1]
    flow.mask = (sum((x - c) ** 2 for x, c in zip(flow.grid, centre))
                 < r ** 2).cpu().numpy()
    flow.initialize()
    return lt.Simulation(flow, make_collision(flow), [])


def phase36_cell_launch(card, saxpy_gbps):
    """K1's cell-flat launch and its masked 16-bit instances' several
    cells a thread, row by row: event ms (200 launches, in turns with the
    plain version), torch.profiler's device ms per launch, the bound and
    the share of the saxpy. Returns the rows for the kernels line."""
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch.ops.cuda import build
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    rows = {}

    def hermite(flow):
        return lt.MRTCollision(
            lt.D3Q27Hermite(flow.stencil, flow.context),
            [1.0] * 4 + [flow.units.relaxation_parameter_lu] * 6
            + [1.2] * 17, flow.context)

    # (a) hermite27 masked on the 3D obstacle, and periodic at 256^3:
    # __launch_bounds__ minimum blocks per SM, and the division
    blocks = build.MIN_BLOCKS["mrt_hermite27", "d3q27", "f32"][-1]
    for shape in ((96, 48, 48), (320, 160, 160), (256, 256, 256)):
        label = "x".join(map(str, shape))
        if shape[0] == 256:
            flow = lt.TaylorGreenVortex(
                lt.Context(device="cuda", dtype=torch.float32,
                           use_native=True), 256, 1600, 0.05,
                stencil=lt.D3Q27(), initialize_fneq=False)
            simulation = lt.Simulation(flow, hermite(flow), [])
            kind, bytes_per_update = "periodic", 27 * 4 * 2
        else:
            simulation = obstacle3d_simulation(lt.D3Q27(), shape, hermite)
            kind, bytes_per_update = "masked obstacle", 27 * 4 * 2 + 1
        reset_launch_counts()
        simulation(4)
        torch.cuda.synchronize()
        launched = fragment_launches()
        key = ("masked_" if kind != "periodic" else "") + "mrt_hermite27"
        check(launched == {key: 4}, f"hermite27 {label}: launches "
                                    f"{launched}")
        params = simulation._kernel_params
        f = simulation.flow.f.clone()
        out = torch.empty_like(f)
        plans = k1_plans(params, f, out, "mrt_hermite27",
                         divisions=(None, "div32"),
                         min_blocks=(None, *blocks))
        kernels = {k: k1_launcher(params, f, out, p)
                   for k, p in plans.items()}
        got = check_candidates_equal(kernels, [out], f"hermite27 {label}")
        ref = sc.stream_collide_plain(f, **params)
        err = (got[0] - ref).abs().max().item()
        check(err <= ATOL[torch.float32], f"hermite27 {label}: {err}")
        del ref, got
        timed, plain_ms = k1_row(
            f"K1c hermite27 {kind} D3Q27 {label} f32, |kernel - plain| "
            f"{err:.3e}", card, saxpy_gbps, f[0].numel(), bytes_per_update,
            kernels, lambda: sc.stream_collide_plain(f, **params),
            plain_repeats=1 if shape[0] > 96 else 3)
        rows[f"hermite27 {kind} {label}"] = dict(
            key=key, launches=launched.get(key, 0), err=err, timed=timed,
            plain_ms=plain_ms, cells=f[0].numel(), bytes=bytes_per_update,
            q=27, default=next(iter(plans)))
        del simulation, f, out, kernels
        torch.cuda.empty_cache()

    # (b) K1a, the main path: the division
    f, tau_inv = tgv_state(lt.D3Q19(), (256,) * 3, torch.float32, 36)
    out = torch.empty_like(f)
    params = dict(e=lt.D3Q19().e, w=lt.D3Q19().w,
                  opposite=lt.D3Q19().opposite, cs=float(lt.D3Q19().cs),
                  tau_inv=tau_inv)
    plans = k1_plans(params, f, out, "bgk", divisions=(None, "div32"))
    kernels = {k: k1_launcher(params, f, out, p) for k, p in plans.items()}
    check_candidates_equal(kernels, [out], "K1a 256^3")
    timed, _ = k1_row("K1a BGK D3Q19 256^3 f32", card, saxpy_gbps,
                      f[0].numel(), BYTES_PER_UPDATE, kernels,
                      lambda: sc.stream_collide_plain(f, **params),
                      plain_repeats=1)
    rows["k1a 256^3"] = dict(timed=timed)
    del f, out, kernels
    torch.cuda.empty_cache()

    # (c) K1e bgk_force masked on the Poiseuille 2048^2 cell, bf16-dev
    cell, key, make_flow, make_collision = fragment_cells()[-1]
    context = lt.Context(device="cuda", dtype=torch.float32,
                         use_native=True)
    flow = make_flow(context)
    simulation = lt.Simulation(flow, make_collision(flow), [],
                               half_storage=True)
    reset_launch_counts()
    simulation(4)
    torch.cuda.synchronize()
    check(half_launches() == {"masked_bgk_force_bf16_dev": 4},
          f"{cell}: half launches {half_launches()}")
    params = simulation._half_params
    g = simulation._encode(flow.f)
    out = torch.empty_like(g)
    plans = k1_plans(params, g, out, "bgk_force", cells=(None, 1, 2, 4))
    kernels = {k: k1_launcher(params, g, out, p) for k, p in plans.items()}
    got = check_candidates_equal(kernels, [out], cell)
    _, _, err = check_storage(got[0], sc.stream_collide_plain(g, **params),
                              "bf16_dev", f"{cell} bf16-dev")
    timed, plain_ms = k1_row(
        f"K1e bgk_force masked {cell} bf16-dev, max |kernel - plain| "
        f"{err:.3e}", card,
        saxpy_gbps, g[0].numel(), 2 * 9 * 2 + 1, kernels,
        lambda: sc.stream_collide_plain(g, **params))
    rows["bgk_force bf16_dev poiseuille"] = dict(timed=timed)
    del simulation, flow, g, out, kernels
    torch.cuda.empty_cache()

    # (d) the obstacle: K1d@16 and K1f masked (c candidates), K3@16 and
    # K3c masked, K1c none/lallemand/dellar masked
    from lettuce_tpu_torch.ops.cuda import adjoint
    f32 = obstacle_simulation(True)
    params = f32._kernel_params
    f = f32.flow.f.clone()
    cells = f[0].numel()
    gct = torch.as_tensor(np.random.default_rng(36).standard_normal(
        tuple(f.shape)), dtype=torch.float32, device="cuda")
    forward, _, backward, backward_plain, _, _, _, _ = kernel_pair(
        params, f, gct)
    timed, _ = k1_row("K3c BGK masked adjoint obstacle2d_2048 f32", card,
                      saxpy_gbps, cells, MASKED_BYTES_PER_UPDATE + 2 * 4,
                      {"default": backward}, backward_plain,
                      names=K3_KERNELS)
    rows["k3c obstacle"] = dict(timed=timed)
    xb = f.to(torch.bfloat16)
    gb = gct.to(torch.bfloat16)
    outb = torch.empty_like(xb)
    ub = torch.empty((2, *f.shape[1:]), dtype=torch.float32, device="cuda")
    bparams = dict(params)
    if bparams.get("feq_field") is not None:
        bparams["feq_field"] = bparams["feq_field"].to(torch.bfloat16)
    for emit, what in ((True, "K1d@16 BGK masked emit-u"),
                       (False, "K1f BGK masked")):
        u_out = ub if emit else None
        plans = k1_plans(bparams, xb, outb, "bgk", u_out=u_out,
                         cells=(None, 1, 2, 4))
        kernels = {k: k1_launcher(bparams, xb, outb, p, u_out)
                   for k, p in plans.items()}
        got = check_candidates_equal(
            kernels, [outb] + ([ub] if emit else []), what)
        ref = sc.stream_collide_plain(xb, **bparams, emit_u=emit)
        ulps, _, _ = check_storage(got[0], ref[0] if emit else ref, "bf16",
                                   f"{what} obstacle")
        if emit:
            u_err = (got[1] - ref[1]).abs().max().item()
            check(u_err <= ATOL[torch.float32], f"{what}: u {u_err}")
        timed, _ = k1_row(
            f"{what} obstacle2d_2048 bf16, {ulps:.2f} ulps", card,
            saxpy_gbps, cells, 2 * 9 * 2 + 1 + (2 * 4 if emit else 0),
            kernels, lambda: sc.stream_collide_plain(xb, **bparams,
                                                     emit_u=emit))
        rows[f"{what} obstacle"] = dict(timed=timed)
    # K3@16: the adjoint of a bfloat16 state, u in float32
    sc.stream_collide(xb, **bparams, out=outb, u_out=ub)
    ctb = torch.empty_like(xb)
    timed, _ = k1_row(
        "K3@16 BGK masked adjoint obstacle2d_2048 bf16", card, saxpy_gbps,
        cells, 2 * 9 * 2 + 1 + 2 * 4,
        {"default": lambda: adjoint.stream_collide_adjoint(
            gb, ub, **bparams, out=ctb)},
        lambda: adjoint.stream_collide_adjoint_plain(gb, ub, **bparams),
        names=K3_KERNELS)
    rows["k3@16 obstacle"] = dict(timed=timed)
    del f32, f, gct, xb, gb, outb, ub, ctb
    torch.cuda.empty_cache()
    for fragment in ("none", "mrt_lallemand", "mrt_dellar"):
        simulation = obstacle_simulation(
            True, make_collision=lambda flow: fragment_collisions(
                flow, flow.units.relaxation_parameter_lu)[fragment])
        params = simulation._kernel_params
        f = simulation.flow.f.clone()
        out = torch.empty_like(f)
        timed, _ = k1_row(
            f"K1c {fragment} masked obstacle2d_2048 f32", card, saxpy_gbps,
            cells, MASKED_BYTES_PER_UPDATE,
            {"default": k1_launcher(params, f, out)},
            lambda: sc.stream_collide_plain(f, **params))
        rows[f"{fragment} obstacle"] = dict(timed=timed)
        del simulation, f, out
    torch.cuda.empty_cache()

    # (e) cells a thread per stencil and storage: BGK masked on the
    # obstacles (2048x1024 D2Q9, 320x160x160 D3Q15/D3Q19/D3Q27), each
    # candidate bitwise equal to the one-cell kernel, that one within one
    # storage ulp of the plain version
    best = {}
    for stencil in (lt.D2Q9(), lt.D3Q15(), lt.D3Q19(), lt.D3Q27()):
        name = type(stencil).__name__
        if stencil.d == 2:
            simulation = obstacle_simulation(True)
        else:
            simulation = obstacle3d_simulation(
                stencil, (320, 160, 160),
                lambda flow: lt.BGKCollision(
                    flow.units.relaxation_parameter_lu))
        params = dict(simulation._kernel_params)
        f32 = simulation.flow.f
        for storage, (dtype, dev) in HALF_STORAGES.items():
            x = storage_state(f32, stencil.w, storage)
            p = dict(params, dev_storage=dev)
            if p.get("feq_field") is not None:
                p["feq_field"] = storage_state(p["feq_field"], stencil.w,
                                               storage)
            out = torch.empty_like(x)
            plans = k1_plans(p, x, out, "bgk", cells=(1, 2, 4))
            kernels = {k: k1_launcher(p, x, out, pl)
                       for k, pl in plans.items()}
            got = check_candidates_equal(kernels, [out],
                                         f"{name} {storage}")
            ulps, _, _ = check_storage(
                got[0], sc.stream_collide_plain(x, **p), storage,
                f"{name} {storage} masked")
            times = time_in_turns_many(kernels, None)
            device = {k: device_ms_per_launch(fn, K1_KERNELS)
                      for k, fn in kernels.items()}
            line = []
            for label, (a, b) in times.items():
                dev_ms = device[label]
                line.append(f"{label} event {a:.4f} / {b:.4f}, device "
                            + ("not measured" if dev_ms is None
                               else f"{dev_ms:.4f}"))
            # the device time decides where the profiler read one: the
            # 2D launches are short enough for host time to show in events
            fastest = min(times, key=lambda k: (
                device[k] if None not in device.values()
                else sum(times[k])))
            best[name.lower(), storage] = plans[fastest].cells
            print(f"phase 36: BGK masked obstacle {name} "
                  f"{'x'.join(map(str, x.shape[1:]))} {storage}, "
                  f"{ulps:.2f} ulps: ms " + "; ".join(line)
                  + f"; fastest {fastest}, shipped "
                    f"{build.SHIPPED_CELLS[name.lower(), storage]} "
                    f"({card})")
            del x, out, kernels
        del simulation, f32
        torch.cuda.empty_cache()
    print(f"phase 36: fastest cells a thread per (stencil, storage): "
          f"{best}; shipped {build.SHIPPED_CELLS}")
    return rows


def phase36_vectors_vs_plain():
    """Every masked 16-bit instance (each fragment, stencil and storage)
    through the vector path, no population frozen, on the grids of phase 2,
    against its plain version: one storage ulp (deviations plus the
    floor), one launch each, at the cells it ships."""
    import lettuce_tpu_torch as lt
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    count = 0
    worst = 0.0
    seed = 3600
    for stencil, shape in phase2_cases():
        context = lt.Context(device="cuda", dtype=torch.float32,
                             use_native=False)
        flow = lt.TaylorGreenVortex(context, list(shape), 1600, 0.05,
                                    stencil=stencil, initialize_fneq=False)
        collisions = {"bgk": lt.BGKCollision(FRAGMENT_TAU),
                      **fragment_collisions(flow, FRAGMENT_TAU)}
        for fragment, collision in collisions.items():
            spec = fragment_spec(flow, collision)
            args = (stencil.e, stencil.w, stencil.opposite, stencil.cs,
                    spec[1] if fragment == "bgk" else None)
            for storage, (dtype, dev) in HALF_STORAGES.items():
                if dev and fragment in sc.DEV_REFUSED:
                    continue
                seed += 1
                f32, _ = tgv_state(stencil, shape, torch.float32, seed)
                masks = bounded_case(stencil, shape, torch.float32, seed)[1]
                masks["nsm"] = None
                masks["feq_field"] = storage_state(masks["feq_field"],
                                                   stencil.w, storage)
                x = storage_state(f32, stencil.w, storage)
                out = torch.empty_like(x)
                plan = sc.cell_plan(x, stencil.e, fragment, True, dev,
                                    tensors=(out, masks["ncm"]))
                check(plan.vectors or plan.cells == 1,
                      f"{fragment} {storage}: no vectors in {plan}")
                got = sc.stream_collide(x, *args, **masks, out=out,
                                        collision_spec=spec,
                                        dev_storage=dev)
                ref = sc.stream_collide_plain(x, *args, **masks,
                                              collision_spec=spec,
                                              dev_storage=dev)
                floor = KBC_DEV_FLOOR if fragment == "kbc" else DEV_FLOOR
                check_storage(got, ref, storage,
                              f"{fragment} {type(stencil).__name__} "
                              f"{storage} vectors", floor)
                ulps, floored, _ = storage_ulps(got, ref, floor)
                worst = max(worst, floored if dev else ulps)
                count += 1
    print(f"phase 36: {count} masked 16-bit instances through their "
          f"shipped cells a thread, nothing frozen, against plain: worst "
          f"{worst:.2f} storage ulps (deviations with the floor)")


# one tree's single-step kernels, timed in a process of their own: K1a,
# K1e BGK and K1c reg D3Q27 at 256^3, K1c hermite27 masked on the 3D
# obstacle at 96x48x48; only their libraries are built
_SINGLE_STEP_TIMER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from lettuce_tpu_torch.ops.cuda import build
sources = ("stream_collide", "half_stream_collide", "collide_moments",
           "collide_mrt")
build.SOURCES = sources
build.build_libraries.__defaults__ = (sources,)
import lettuce_tpu_torch as lt
import lettuce_tpu_torch.simulation as simulation_module
import lettuce_tpu_torch.ops.cuda.adjoint as adjoint
import lettuce_tpu_torch.ops.cuda.stream_collide as sc
simulation_module.load_libraries = lambda: None
adjoint.load_libraries = lambda: None
import chip_smoke as c
ms = {}
ctx = lt.Context(device="cuda", dtype=torch.float32, use_native=True)
cells = {cell: (make_flow, make_collision)
         for cell, _, make_flow, make_collision in c.fragment_cells()}


def hermite(flow):
    return lt.MRTCollision(lt.D3Q27Hermite(flow.stencil, flow.context),
                           [1.0] * 4 + [flow.units.relaxation_parameter_lu]
                           * 6 + [1.2] * 17, flow.context)


def reg(context):
    make_flow, make_collision = cells["reg3d_256_d3q27"]
    flow = make_flow(context)
    return lt.Simulation(flow, make_collision(flow), [])


for name, make, half in (
        ("K1a D3Q19 256^3", lambda: c.tgv256(ctx), False),
        ("K1e BGK D3Q19 256^3 bf16-dev", lambda: c.tgv256(ctx), True),
        ("K1c reg D3Q27 256^3", lambda: reg(ctx), False),
        ("K1c hermite27 masked 96x48x48", lambda: c.obstacle3d_simulation(
            lt.D3Q27(), (96, 48, 48), hermite), False)):
    sim = make()
    params = dict(sim._kernel_params)
    f = sim.flow.f.clone()
    if half:
        params["dev_storage"] = True
        f = sc.encode_deviations(f, params["w"])
    out = torch.empty_like(f)
    c.cuda_ms(lambda: sc.stream_collide(f, **params, out=out), 20)
    ms[name] = c.cuda_ms(lambda: sc.stream_collide(f, **params, out=out),
                         200)
    del sim, f, out
    torch.cuda.empty_cache()
print(json.dumps(ms))
"""


MOMENTS_SOURCE = "lettuce_tpu_torch/csrc/moments.cu"
MOMENTS_REPLACES = "none (lettuce_tpu's Flow.u is jnp)"
K5_KERNELS = ("velocity_kernel",)
K5_ADJOINT_KERNELS = ("velocity_adjoint_kernel",)


def k5_bytes(q, d, itemsize):
    """(forward, adjoint) bytes a cell: K5 reads q stored values and
    writes d of u and rho in float32; its adjoint reads g and u (d stored
    values each) and rho and writes q."""
    return (q * itemsize + d * itemsize + 4,
            2 * d * itemsize + 4 + q * itemsize)


def k5_ops(q, d):
    """(forward, adjoint) operations a cell, counted from csrc/moments.cu
    (approximate; far below the bytes' time)."""
    return 2 * q + d, 3 * q + 2 * d + 1


def moment_state(stencil, shape, dtype, seed, offset=0):
    """A state near rest on the card, w_q (1 + 0.05 N(0, 1)) seeded, in
    ``dtype``; ``offset`` elements into its buffer (a misaligned state)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(stencil.w, dtype=torch.float32, device="cuda")
    n = stencil.q * int(np.prod(shape))
    noise = torch.randn(n, generator=g, device="cuda")
    f = (w.repeat_interleave(n // stencil.q) * (1 + 0.05 * noise))
    buf = torch.empty(n + offset, dtype=dtype, device="cuda")
    state = buf[offset:].view(stencil.q, *shape)
    state.copy_(f.view(stencil.q, *shape))
    return state


def k5_plan(f, e):
    """K5's launch plan for the CUDA state ``f`` of the velocities ``e``."""
    from lettuce_tpu_torch.ops.cuda import moments
    return moments.plan_of(f, moments.takes(f, e))


def k5_against_plain(stencil, f, seed, what):
    """K5 and its adjoint on the state ``f`` against the plain versions
    (the adjoint from the kernel's u and rho, a seeded g): u to ATOL in
    float32, to one storage ulp plus 2^-23 at 16 bits; rho to 1e-6 of its
    size; the cotangent to GRAD_RTOL of its largest magnitude in float32,
    one storage ulp there at 16 bits. Returns the absolute max errors of
    u, rho and the cotangent, and the readings held to those limits: u's
    (absolute in float32, ulps at 16 bits) and the cotangent's (relative
    to its largest magnitude in float32, ulps there at 16 bits)."""
    from lettuce_tpu_torch.ops.cuda import moments
    e = stencil.e
    plan = k5_plan(f, e)
    u, rho = moments._launch(f, plan, keep_rho=True)
    u_ref, rho_ref = moments.velocity_plain(f, e)
    g = torch.randn(u.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed)).to(f.dtype)
    out = moments._launch_adjoint(g, u, rho, plan)
    ref = moments.velocity_adjoint_plain(g, u, rho, e)
    torch.cuda.synchronize()
    for x in (u, rho, out):
        check(bool(torch.isfinite(x.float()).all()), f"{what}: not finite")
    rho_err = (rho - rho_ref).abs().max().item()
    check(rho_err <= 1e-6 * rho_ref.abs().max().item(),
          f"{what}: rho {rho_err:.3g} from plain")
    u_abs = (u.float() - u_ref.float()).abs().max().item()
    adj_abs, scale = scaled_err(out.float(), ref.float())
    if f.dtype == torch.float32:
        u_read, adj_read = u_abs, adj_abs / scale
        check(u_read <= ATOL[torch.float32], f"{what}: u {u_read:.3g} from "
                                             f"plain")
        check(adj_read <= GRAD_RTOL[torch.float32],
              f"{what}: adjoint {adj_abs:.3g} of {scale:.3g} from plain")
    else:
        _, u_read, _ = storage_ulps(u, u_ref)
        check(u_read <= 1.0, f"{what}: u {u_read:.2f} ulps (with 2^-23) "
                             f"from plain")
        adj_read = ulps_at_max(out, ref)[0]
        check(adj_read <= 1.0, f"{what}: adjoint {adj_read:.2f} ulps at its "
                               f"largest magnitude from plain")
    return (u_abs, rho_err, adj_abs), (u_read, adj_read)


def flow_u_launches(flow, f):
    """K5's launch counts in one loss step through Flow.u on the CUDA
    state ``f`` (of ``flow``'s stencil): mean(u^2) and its backward, the
    counts reset just before; ``moments_torch`` among them."""
    from lettuce_tpu_torch import tracing
    fg = f.detach().requires_grad_(True)
    reset_launch_counts()
    torch.mean(flow.view(fg).u().float() ** 2).backward()
    torch.cuda.synchronize()
    return {k: n for k, n in tracing.counts.items()
            if k.startswith("K5:") or k == "moments_torch"}


def phase37_velocity_moments(card, saxpy_gbps):
    """K5 and its adjoint (csrc/moments.cu) against their plain versions,
    instance by instance, then timed at full size; returns the rows for
    the kernels line."""
    import ctypes
    import lettuce_tpu_torch as lt
    from lettuce_tpu_torch import tracing
    from lettuce_tpu_torch.ops.cuda import moments
    # (a) every instance at small sizes: the 16-byte path, a cell count
    # it does not divide, a misaligned state (one cell a thread)
    small = {1: ((4096,), (1001,)), 2: ((64, 96), (31, 33)),
             3: ((16, 18, 24), (7, 9, 11))}
    worst = {}
    seed = 3700
    for name, make in moments.STENCILS.items():
        stencil = make()
        for dtype, suffix in moments.STORAGE.items():
            before = (tracing.counts[f"K5:u_{suffix}"],
                      tracing.counts[f"K5:adjoint_u_{suffix}"])
            runs = 0
            for shape, offset in ((small[stencil.d][0], 0),
                                  (small[stencil.d][1], 0),
                                  (small[stencil.d][0], 1)):
                seed += 1
                f = moment_state(stencil, shape, dtype, seed, offset)
                errs, reads = k5_against_plain(stencil, f, seed,
                                               f"K5 {name} {suffix} {shape} "
                                               f"offset {offset}")
                runs += 1
                worst[suffix] = tuple(max(a, b) for a, b in zip(
                    worst.get(suffix, (0.0,) * 5), errs + reads))
            after = (tracing.counts[f"K5:u_{suffix}"],
                     tracing.counts[f"K5:adjoint_u_{suffix}"])
            check(after == (before[0] + runs, before[1] + runs),
                  f"K5 {name} {suffix}: launches {before} -> {after}")
    # the C entry refuses 16-byte accesses on a misaligned pointer
    stencil = lt.D2Q9()
    f = moment_state(stencil, (64, 96), torch.float32, 1, offset=1)
    u = torch.empty((2, 64, 96), device="cuda")
    entry = getattr(moments.load_library(), "lt_velocity_d2q9_f32")
    rc = entry(f.data_ptr(), u.data_ptr(), None, 64 * 96, 1, 0,
               torch.cuda.current_stream().cuda_stream)
    check(rc == 1, f"K5 on a misaligned state with 16-byte accesses "
                   f"returned {rc}, not cudaErrorInvalidValue")
    print(f"phase 37: K5 and its adjoint, {5 * 3 * 3} instance runs "
          f"against plain: worst absolute (u, rho, adjoint) and readings "
          f"(u, adjoint) "
          + "; ".join(f"{s} {u:.3g}, {r:.3g}, {a:.3g} ({ur:.3g}, {ar:.3g})"
                      for s, (u, r, a, ur, ar) in worst.items())
          + " (readings: float32 u absolute and the adjoint relative to its "
            "largest magnitude, 16 bits in ulps); a misaligned 16-byte "
            "launch refused")
    # (b) full size, each dtype
    rows = {}
    for label, stencil, shape in (("d3q19 256^3", lt.D3Q19(), (256,) * 3),
                                  ("d2q9 2048x1024", lt.D2Q9(),
                                   (2048, 1024))):
        cells = int(np.prod(shape))
        e = stencil.e
        et = torch.as_tensor(e, dtype=torch.float32, device="cuda")
        # Flow.u reads only the stencil: a small flow views the big state
        small_flow = lt.TaylorGreenVortex(
            lt.Context(device="cuda", dtype=torch.float32, use_native=False),
            [16] * stencil.d, 100, 0.05, stencil=stencil,
            initialize_fneq=False)
        for dtype, suffix in moments.STORAGE.items():
            seed += 1
            f = moment_state(stencil, shape, dtype, seed)
            what = f"K5 {label} {suffix}"
            errs, reads = k5_against_plain(stencil, f, seed, what)
            plan = k5_plan(f, e)
            u, rho = moments._launch(f, plan, keep_rho=True)
            g = torch.randn_like(u, dtype=torch.float32).to(dtype)
            fg = f.detach().requires_grad_(True)

            def expression():
                # Flow.u's torch expression and its autograd backward
                x = torch.tensordot(et.to(dtype).T, fg, dims=1) / torch.sum(
                    fg, dim=0, keepdim=True)
                torch.autograd.grad(x, fg, g)

            kernels = {
                "forward": lambda: moments._launch(f, plan, keep_rho=True),
                "adjoint": lambda: moments._launch_adjoint(g, u, rho, plan)}
            plains = {"forward": lambda: moments.velocity_plain(f, e),
                      "adjoint": lambda: moments.velocity_adjoint_plain(
                          g, u, rho, e)}
            for fn in (*kernels.values(), *plains.values(), expression):
                fn()
            first = {k: cuda_ms(fn, 200) for k, fn in kernels.items()}
            plain = {k: cuda_ms(fn, 5) for k, fn in plains.items()}
            expr_ms = cuda_ms(expression, 5)
            second = {k: cuda_ms(fn, 200)
                      for k, fn in reversed(kernels.items())}
            plain = {k: (plain[k] + cuda_ms(fn, 5)) / 2
                     for k, fn in plains.items()}
            device = {"forward": device_ms_per_launch(kernels["forward"],
                                                      K5_KERNELS),
                      "adjoint": device_ms_per_launch(kernels["adjoint"],
                                                      K5_ADJOINT_KERNELS)}
            itemsize = torch.finfo(dtype).bits // 8
            nbytes = dict(zip(("forward", "adjoint"),
                              k5_bytes(stencil.q, stencil.d, itemsize)))
            ops = dict(zip(("forward", "adjoint"),
                           k5_ops(stencil.q, stencil.d)))
            # the launches of one Flow.u loss step on this state
            launches = flow_u_launches(small_flow, f)
            check(launches == {f"K5:u_{suffix}": 1,
                               f"K5:adjoint_u_{suffix}": 1},
                  f"{what}: a Flow.u loss step counted {launches}")
            parts = []
            for k in kernels:
                bound_ms = cells * nbytes[k] / HBM_BYTES_PER_S * 1e3
                saxpy_ms = cells * nbytes[k] / (saxpy_gbps * 1e9) * 1e3
                dev = device[k]
                ms = dev if dev is not None else (first[k] + second[k]) / 2
                parts.append(
                    f"{k}: event {first[k]:.4f} / {second[k]:.4f} ms, "
                    f"device {'not measured' if dev is None else f'{dev:.4f}'}"
                    f" ms, bound {bound_ms:.4f} at 3.35 TB/s, {saxpy_ms:.4f}"
                    f" at the saxpy ({saxpy_ms / ms:.1%} of it), "
                    f"{nbytes[k]} B a cell; plain {plain[k]:.4f} ms")
                key = tracing.launch_key(
                    "K5", "adjoint_" if k == "adjoint" else "", "u", suffix)
                rows[f"{label} {suffix}", k] = dict(
                    cells=cells, bytes=nbytes[k], ops=ops[k], ms=ms,
                    plain_ms=plain[k],
                    err=errs[0] if k == "forward" else errs[2],
                    launches=launches[key])
            print(f"phase 37: {what}: " + "; ".join(parts)
                  + f"; expression forward + autograd backward "
                    f"{expr_ms:.4f} ms; against plain, absolute u "
                    f"{errs[0]:.3g}, rho {errs[1]:.3g}, adjoint "
                    f"{errs[2]:.3g}, readings u {reads[0]:.3g}, adjoint "
                    f"{reads[1]:.3g}; a Flow.u loss step launches "
                  + ", ".join(f"{k} {n}" for k, n in sorted(launches.items()))
                  + f" ({card})")
            del f, u, rho, g, fg
            torch.cuda.empty_cache()
    # (c) Flow.u under autograd: one K5 and one adjoint launch, nothing
    # counted as the expression
    flow = lt.TaylorGreenVortex(
        lt.Context(device="cuda", dtype=torch.float32, use_native=False),
        [256] * 3, 1600, 0.05, stencil=lt.D3Q19(), initialize_fneq=False)
    f0 = flow.f.clone().requires_grad_(True)
    reset_launch_counts()
    loss = torch.mean(flow.view(f0).u() ** 2)
    loss.backward()
    torch.cuda.synchronize()
    counts = {k: n for k, n in tracing.counts.items()
              if k.startswith("K5:") or k == "moments_torch"}
    check(counts == {"K5:u_f32": 1, "K5:adjoint_u_f32": 1},
          f"Flow.u under autograd at 256^3 counted {counts}")
    ref = (flow.j(f0) / flow.rho(f0)).detach()
    ref_grad = torch.autograd.grad(torch.mean(
        (flow.j(f0) / flow.rho(f0)) ** 2), f0)[0]
    err, scale = scaled_err(f0.grad, ref_grad)
    check(err <= GRAD_RTOL[torch.float32] * scale,
          f"Flow.u's gradient {err:.3g} of {scale:.3g} from the "
          f"expression's")
    u_err = (flow.u(f0.detach()) - ref).abs().max().item()
    print(f"phase 37: Flow.u under autograd at 256^3: launches {counts}; "
          f"u {u_err:.3g} from the expression's, gradient "
          f"{err / scale:.3g} of its largest magnitude")
    return rows


def k5_entries(rows):
    """The kernels line's rows of phase 37."""
    return [kernel_entry(f"velocity_{kind}[{cell}]", MOMENTS_SOURCE,
                         MOMENTS_REPLACES, row["launches"], row["err"],
                         row["ms"], row["plain_ms"], row["cells"],
                         row["bytes"], row["ops"])
            for (cell, kind), row in rows.items()]


def compare_single_step(parent: str):
    """The single-step kernels of the parent commit's tree at ``parent``
    (a directory holding its checkout) and of this one, each timed in a
    process of its own in turns: parent, this, this, parent; ms per
    launch by CUDA events (200 launches). Not run by main(): a checkout
    holds no parent. Run it as
    ``python3 -c "import chip_smoke as c; c.compare_single_step('DIR')"``
    after unpacking the parent commit into DIR."""
    card = phase0_card()
    here = os.path.dirname(os.path.abspath(__file__))
    readings = []
    # the parent's process takes this file's helpers, beside its package
    shutil.copy(os.path.join(here, "chip_smoke.py"),
                os.path.join(parent, "chip_smoke_timer.py"))
    for label, root in (("parent", parent), ("this", here), ("this", here),
                        ("parent", parent)):
        timer = _SINGLE_STEP_TIMER
        if root != here:
            timer = timer.replace("import chip_smoke as c",
                                  "import chip_smoke_timer as c")
        run = subprocess.run([sys.executable, "-c", timer], cwd=root,
                             capture_output=True, text=True)
        check(run.returncode == 0, f"{label} timer: {run.stderr[-2000:]}")
        readings.append((label, json.loads(run.stdout.strip()
                                           .splitlines()[-1])))
    for name in readings[0][1]:
        print(f"compare: {name}: ms per launch, parent / this / this / "
              f"parent: " + " / ".join(f"{r[name]:.4f}"
                                       for _, r in readings)
              + f" ({card})")


def cell_launch_entries(rows):
    """The hermite27 rows of phase 36 (the obstacle at 96x48x48 and
    320x160x160, periodic 256^3): their default plan's event ms."""
    entries = []
    for label, row in rows.items():
        if not label.startswith("hermite27"):
            continue
        ms, device_ms = row["timed"][row["default"]]
        entries.append(kernel_entry(
            f"stream_collide_{row['key']}[{label.split(' ', 1)[1]}]",
            "lettuce_tpu_torch/csrc/collide_mrt.cu", HERMITE_REPLACES,
            row["launches"], row["err"], ms, row["plain_ms"], row["cells"],
            row["bytes"], row["q"] * OPS_PER_POPULATION["mrt_hermite27"],
            device_ms=device_ms))
    return entries


def half_gradient_entries(worst, runs, blocked):
    """The kernels-line entries of a 16-bit state's gradient: per cell of
    phase 33 its K1d at 16 bits (the emit-u forward; the forward of the
    f-residual and split cells is K1f, listed by phase 25) and its K3 at
    16 bits, and K4 at 16 bits from phase 34; max_abs_err also covers
    phase 32's runs of the instance."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    entries = []
    for run in runs:
        fwd, adj = run["forward"], run["adjoint"]
        label = f"[{run['cell']}]"
        if fwd["emit_u"]:
            base = ("stream_collide" if fwd["fragment"] == "bgk"
                    else sc.FRAGMENTS[fwd["fragment"]][0])
            entries.append(kernel_entry(
                f"stream_collide_{fwd['key']}{label}",
                f"lettuce_tpu_torch/csrc/{sc.HALF_SOURCES[base]}.cu",
                EMIT_U_HALF_REPLACES, fwd["launches"],
                max(fwd["err"], worst.get(fwd["key"], (0.0, 0.0))[0]),
                fwd["ms"], fwd["plain_ms"], fwd["cells"], fwd["bytes"],
                fwd["ops"], cell=run["cell"]))
        entries.append(kernel_entry(
            f"stream_collide_adjoint_{adj['key']}{label}",
            ADJOINT_HALF_SOURCE, ADJOINT_HALF_REPLACES, adj["launches"],
            max(adj["err"], worst.get("adjoint_" + adj["key"],
                                      (0.0, 0.0))[0]),
            adj["ms"], adj["plain_ms"], adj["cells"], adj["bytes"],
            adj["ops"], cell=run["cell"], mode=run["mode"]))
    entries.append(kernel_entry(
        "stream_collide_adjoint_multi_bgk_bf16_x2",
        ADJOINT_MULTI_HALF_SOURCE, ADJOINT_MULTI_REPLACES,
        blocked["k4_launches"],
        max(blocked["err"], worst.get("multi_bgk_bf16_x2", (0.0, 0.0))[0]),
        blocked["ms"], blocked["plain_ms"], blocked["cells"],
        ADJOINT_MULTI_HALF_BYTES_PER_UPDATE,
        2 * 19 * (OPS_PER_POPULATION["bgk"]
                  + OPS_PER_POPULATION["adjoint_bgk"]),
        span=2, ms_per_step=blocked["ms"] / 2,
        k2_launches=blocked["k2_launches"]))
    return entries


def masked_multi_entries(worst_masked_multi, bounded):
    """The kernels-line entries of K2 masked: one per bounded cell and
    span (float32 x2 and x4, bf16-dev x2 for Couette and the cavity), with
    the bound of its bytes per cell; max_abs_err also covers phase 29's
    runs of the instance."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    entries = []
    for name, run in sorted(bounded.items()):
        fragment = run["fragment"]
        source = ("stream_collide" if fragment == "bgk"
                  else sc.FRAGMENTS[fragment][0])
        entries.append(kernel_entry(
            f"stream_collide_multi_{name}",
            f"lettuce_tpu_torch/csrc/{sc.MULTI_SOURCES[source]}.cu",
            MULTI_MASKED_REPLACES, run["launches"],
            max(run["err"],
                worst_masked_multi.get(f"{fragment}_{run['suffix']}", 0.0)),
            run["ms"], run["plain_ms"], run["cells"], run["bytes"],
            run["span"] * run["q"] * OPS_PER_POPULATION[fragment],
            kernel="K2 masked", span=run["span"], cell=run["cell"],
            ms_per_step=run["ms"] / run["span"],
            single_step_ms=run["k1_ms"], storage=run["suffix"],
            replay_ms=run["replay_ms"]))
    return entries


def multi_entries(worst_multi, blocked, gradient):
    """The kernels-line entries of the blocked kernels the main path runs:
    K2 (BGK, float32 and bfloat16 deviations, at span 2 and 4) with its
    per-launch bound, and K4 (BGK float32, span 2) from the gradient;
    max_abs_err also covers phase 26's runs of the instance."""
    entries = []
    for key, run in sorted(blocked.items()):
        span, suffix = run["span"], run["suffix"]
        entries.append(kernel_entry(
            f"stream_collide_multi_{key}", MULTI_SOURCE, MULTI_REPLACES,
            run["launches"],
            max(run["err"], worst_multi.get(f"bgk_{suffix}", 0.0)),
            run["ms"], run["plain_ms"], run["cells"], run["bytes"],
            span * 19 * OPS_PER_POPULATION["bgk"], span=span,
            ms_per_step=run["ms"] / span, single_step_ms=run["k1_ms"],
            storage=suffix))
    entries.append(kernel_entry(
        "stream_collide_adjoint_multi_bgk_f32_x2", ADJOINT_MULTI_SOURCE,
        ADJOINT_MULTI_REPLACES, gradient["k4_launches"], gradient["err"],
        gradient["ms"], gradient["plain_ms"], gradient["cells"],
        ADJOINT_MULTI_BYTES_PER_UPDATE,
        2 * 19 * (OPS_PER_POPULATION["bgk"]
                  + OPS_PER_POPULATION["adjoint_bgk"]),
        span=2, ms_per_step=gradient["ms"] / 2,
        k2_launches=gradient["k2_launches"]))
    return entries



def half_entries(worst_half, half_main, half_cells, half_state):
    """The kernels-line entries of the 16-bit instances that a path runs:
    the main path's bf16-dev BGK, the six bf16-dev fragment cells, and
    the bf16 and f16 states' BGK at 256^3; max_abs_err also covers the
    instance's phase 22 runs (all 174 instances are checked there)."""
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc

    def source(fragment):
        base = "stream_collide" if fragment == "bgk" else \
            sc.FRAGMENTS[fragment][0]
        return f"lettuce_tpu_torch/csrc/{sc.HALF_SOURCES[base]}.cu"

    def err(name, value):
        return max(value, worst_half.get(name, (0.0, 0.0))[1])

    entries = [kernel_entry(
        "stream_collide_bgk_bf16_dev", source("bgk"), DEV_REPLACES,
        half_main["launches"], err("bgk_bf16_dev", half_main["err"]),
        half_main["kernel_ms"], half_main["plain_ms"], half_main["cells"],
        HALF_BYTES_PER_UPDATE, 19 * OPS_PER_POPULATION["bgk"],
        storage="bf16_dev")]
    for name, run in sorted(half_cells.items()):
        entries.append(kernel_entry(
            f"stream_collide_{name}", source(run["fragment"]), DEV_REPLACES,
            run["launches"], err(name, run["err"]), run["kernel_ms"],
            run["plain_ms"], run["cells"], run["bytes"],
            run["q"] * OPS_PER_POPULATION[run["fragment"]],
            storage="bf16_dev", cell=run["cell"]))
    for storage in ("bf16", "f16"):
        run = half_state[storage]
        entries.append(kernel_entry(
            f"stream_collide_bgk_{storage}", source("bgk"), HALF_REPLACES,
            run["launches"], err(f"bgk_{storage}", run["err"]),
            run["kernel_ms"], run["plain_ms"], run["cells"],
            HALF_BYTES_PER_UPDATE, 19 * OPS_PER_POPULATION["bgk"],
            storage=storage))
    return entries


def ptxas_summary():
    """Registers and spills per kernel instance from the build's ptxas
    report: one line per source, the full table in
    build/lettuce_tpu_torch/ptxas_summary.txt."""
    from lettuce_tpu_torch.ops.cuda import build
    rows = []
    half_spills = []
    for source in build.SOURCES:
        log = build.ptxas_log(source)
        if not log.exists():
            print(f"phase 1: {source}: no ptxas report (library cached "
                  f"without one)")
            continue
        kernel = None
        per_source = []
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
                spill = [0, 0]
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kernel:
                spill = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                per_source.append((kernel, int(m.group(1)), *spill))
                kernel = None
        rows += [(source, *r) for r in per_source]
        if source.startswith("half_") and (
                not per_source or any(r[2] or r[3] for r in per_source)):
            half_spills.append(source)
        # the blocked sources hold a periodic and a masked march per entry
        kinds = ([("periodic", lambda k: "masked" not in k),
                  ("masked", lambda k: "masked_march_kernel" in k)]
                 if source.startswith("multi_") else [("", lambda k: True)])
        for kind, selected in kinds:
            chosen = [r for r in per_source if selected(r[0])]
            if not chosen:
                continue
            regs = [r[1] for r in chosen]
            spills = [r for r in chosen if r[2] or r[3]]
            print(f"phase 1: {source}: {len(chosen)} {kind + ' ' if kind else ''}"
                  f"kernels, {min(regs)}-{max(regs)} registers, "
                  f"{len(spills)} with spills"
                  + (f" (worst {max(r[2] for r in spills)} B stored)"
                     if spills else ""))
        if source == "multi_stream_collide":
            # the 2D bounded cells' kernel: its registers bound how many
            # row blocks share an SM
            for kernel, regs, stored, _ in per_source:
                if ("masked_march_kernel" in kernel and "D2Q9" in kernel
                        and "SameIf" in kernel):
                    print(f"phase 1: masked march BGK D2Q9 float32: {regs} "
                          f"registers, {stored} B spilled; "
                          f"{65536 // (regs * 128)} blocks of 128 threads "
                          f"fit an SM's registers")
    # K1's launch candidates: hermite27's minimum blocks per SM, and the
    # masked 16-bit kernels by cells a thread
    for kernel, regs, stored, _ in (r[1:] for r in rows
                                    if r[0] == "collide_mrt"):
        m = re.search(r"(stream_collide_kernel)INS_3MrtINS_5D3Q27EfLi3EEENS_"
                      r"4SameIfEELb[01]ELi(\d)E", kernel)
        if m:
            print(f"phase 1: hermite27 D3Q27 float32 "
                  f"{'masked' if 'masked' in kernel else 'periodic'}, "
                  f"__launch_bounds__(128, {m.group(2)}): {regs} registers, "
                  f"{stored} B spilled")
    for cells in (2, 4):
        chosen = [r for r in rows if "masked_cells_kernel" in r[1]
                  and re.search(rf"Lb[01]ELi{cells}EEEv", r[1])]
        if chosen:
            print(f"phase 1: {len(chosen)} masked 16-bit kernels of "
                  f"{cells} cells a thread: "
                  f"{min(r[2] for r in chosen)}-{max(r[2] for r in chosen)}"
                  f" registers, {sum(1 for r in chosen if r[3] or r[4])} "
                  f"with spills")
    path = build.library_path("stream_collide").parent / "ptxas_summary.txt"
    path.write_text("\n".join(f"{s}\t{k}\t{r}\t{st}\t{ld}"
                              for s, k, r, st, ld in rows) + "\n")
    for source in half_spills:
        check(False, f"{source}: an instance spills (or no ptxas report)")
    return rows


def sass_loops():
    """The loops over the cells of the D2Q9 float32 BGK march kernels,
    periodic and masked, in the built library's SASS (cuobjdump beside
    nvcc): per loop that holds no barrier, its instructions and its
    shared-memory and device-memory accesses, in code order (level 0,
    a level above it and the store in the shared-memory body, then the
    scratch body)."""
    from lettuce_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("phase 1: no cuobjdump beside nvcc: the SASS loops are not "
              "measured")
        return
    text = subprocess.run(
        [tool, "-sass", str(build.library_path("multi_stream_collide"))],
        capture_output=True, text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0]
        if "D2Q9EfEENS_4SameIfE" not in name:
            continue
        code = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(.*?);", part)]
        at = {a: i for i, (a, _) in enumerate(code)}
        loops = []
        for i, (a, op) in enumerate(code):
            m = re.search(r"BRA\b.*?0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= a:
                continue
            body = [o.split()[1] if o.startswith("@") else o.split()[0]
                    for _, o in code[at[int(m.group(1), 16)]:i + 1]]
            if any(o.startswith("BAR") for o in body):
                continue

            def count(prefix):
                return sum(o.startswith(prefix) for o in body)
            loops.append(f"{len(body)} ({count('LDS') + count('STS')} "
                         f"shared, {count('LDG') + count('STG')} device, "
                         f"{count('LDL') + count('STL')} local)")
        kind = "masked" if "masked_march_kernel" in name else "periodic"
        print(f"phase 1: SASS of the {kind} march BGK D2Q9 float32: "
              f"{len(code)} instructions; loops over cells: "
              + ", ".join(loops))


def bound(cells, bytes_per_update, ops_per_update):
    """(bound_ms, bound_by): the larger of the launch's bytes over the
    card's memory rate and its operations over its float32 rate."""
    by_bytes = cells * bytes_per_update / HBM_BYTES_PER_S * 1e3
    by_ops = cells * ops_per_update / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, cells,
                 bytes_per_update, ops_per_update, **extra):
    """One kernel of the kernels line; no single PyTorch call computes a
    fused LBM step or its adjoint, so library_ms is null."""
    bound_ms, bound_by = bound(cells, bytes_per_update, ops_per_update)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra}


def main():
    import lettuce_tpu_torch.ops.cuda.stream_collide as sc
    beg = time.perf_counter()
    card = phase0_card()
    build_s = phase1_build()
    worst = phase2_kernel_vs_plain()
    main_path = phase3_main_path(card)
    phase4_convergence()
    saxpy_gbps = phase5_saxpy(main_path["mlups"], card)
    worst_emit, worst_adjoint = phase6_gradient_kernels_vs_plain()
    grad_path = phase7_gradient_path(card, saxpy_gbps)
    phase8_adam(card)
    worst_masked = phase9_masked_kernels_vs_plain()
    obstacle = phase10_obstacle(card, saxpy_gbps)
    cavity_err, cavity_dev = phase11_cavity(card)
    phase12_profile(card)
    worst_fragments = phase13_fragments_vs_plain()
    cells = phase14_fragment_cells(card, saxpy_gbps)
    phase15_tgv3d_kbc(card)
    phase16_poiseuille()
    masked = phase17_probe_and_masked(card)
    phase18_decaying_turbulence(card)
    worst_gradients = phase19_gradient_instances_vs_plain()
    gradient_runs = (phase20_gradient_cells(card, saxpy_gbps)
                     + phase21_obstacle_gradients(card, saxpy_gbps))
    worst_half = phase22_half_instances_vs_plain()
    half_main = phase23_half_main_path(card, saxpy_gbps)
    half_cells = phase24_half_fragment_cells(card, saxpy_gbps)
    half_state = phase25_half_state(card, saxpy_gbps)
    worst_multi = phase26_multi_instances_vs_plain()
    blocked = phase27_blocked_main_path(card, saxpy_gbps)
    blocked_gradient = phase28_blocked_gradient(card, saxpy_gbps,
                                                grad_path["mlups"])
    worst_masked_multi = phase29_masked_multi_instances_vs_plain()
    bounded = phase30_blocked_bounded_cells(card, saxpy_gbps)
    phase31_cavity_gate_blocked(card, cavity_dev)
    worst_half_gradient = phase32_half_gradient_instances_vs_plain()
    half_gradient = phase33_half_gradient_path(card, saxpy_gbps,
                                               grad_path["mlups"])
    half_blocked = phase34_half_blocked_gradient(card, saxpy_gbps,
                                                 half_gradient)
    phase35_march_candidates(card, saxpy_gbps)
    phase36_vectors_vs_plain()
    cell_launch = phase36_cell_launch(card, saxpy_gbps)
    moments_rows = phase37_velocity_moments(card, saxpy_gbps)
    print(f"build {build_s:.2f} s; whole run {time.perf_counter() - beg:.1f} "
          f"s")
    print(card)
    emit_ms, emit_plain_ms = grad_path["timings"]["emit_u"]
    adj_ms, adj_plain_ms = grad_path["timings"]["adjoint"]
    main_cells, obstacle_cells = 256 ** 3, 2048 * 1024
    kernels = [
        kernel_entry("stream_collide", KERNEL_SOURCE, REPLACES,
                     main_path["launches"], max(worst, main_path["err"]),
                     main_path["kernel_ms"], main_path["plain_ms"],
                     main_cells, BYTES_PER_UPDATE,
                     19 * OPS_PER_POPULATION["bgk"]),
        kernel_entry("stream_collide_emit_u", KERNEL_SOURCE, REPLACES,
                     grad_path["launches"][1],
                     max(worst_emit, grad_path["err_emit"]), emit_ms,
                     emit_plain_ms, main_cells, GRAD_BYTES_PER_UPDATE,
                     19 * OPS_PER_POPULATION["emit_u"]),
        kernel_entry("stream_collide_adjoint", ADJOINT_SOURCE,
                     ADJOINT_REPLACES, grad_path["launches"][2],
                     max(worst_adjoint, grad_path["err_adjoint"]), adj_ms,
                     adj_plain_ms, main_cells, GRAD_BYTES_PER_UPDATE,
                     19 * OPS_PER_POPULATION["adjoint_bgk"]),
        kernel_entry("stream_collide_masked", KERNEL_SOURCE, MASKED_REPLACES,
                     obstacle["launches"],
                     max(worst_masked[0], obstacle["err"], cavity_err),
                     obstacle["kernel_ms"], obstacle["plain_ms"],
                     obstacle_cells, MASKED_BYTES_PER_UPDATE,
                     9 * OPS_PER_POPULATION["bgk"]),
        kernel_entry("stream_collide_masked_emit_u", KERNEL_SOURCE,
                     MASKED_REPLACES, obstacle["grad_launches"][1],
                     max(worst_masked[1], obstacle["err_emit"]),
                     obstacle["emit_ms"], obstacle["emit_plain_ms"],
                     obstacle_cells, MASKED_BYTES_PER_UPDATE + 2 * 4,
                     9 * OPS_PER_POPULATION["emit_u"]),
        kernel_entry("stream_collide_adjoint_masked", ADJOINT_SOURCE,
                     ADJOINT_MASKED_REPLACES, obstacle["grad_launches"][2],
                     max(worst_masked[2], obstacle["err_adjoint"],
                         worst_gradients.get("adjoint_frozen_bgk", 0.0)),
                     obstacle["adjoint_ms"], obstacle["adjoint_plain_ms"],
                     obstacle_cells, MASKED_BYTES_PER_UPDATE + 2 * 4,
                     9 * OPS_PER_POPULATION["adjoint_bgk"]),
    ] + [
        kernel_entry(
            f"stream_collide_{key}",
            "lettuce_tpu_torch/csrc/"
            f"{sc.FRAGMENTS[key.removeprefix('masked_')][0]}.cu",
            "lettuce_tpu/ops/pallas/stream_collide.py:"
            f"{FRAGMENT_REPLACES[key.removeprefix('masked_')]}",
            run["launches"], max(run["err"], worst_fragments[key]),
            run["kernel_ms"], run["plain_ms"], run["cells"], run["bytes"],
            run["q"] * OPS_PER_POPULATION[key.removeprefix("masked_")])
        for key, run in sorted({**masked, **cells}.items())]
    for run in gradient_runs:
        fwd, adj = run["forward"], run["adjoint"]
        if fwd["emit_u"]:  # the K1d fragment instances of this PR
            kernels.append(kernel_entry(
                f"stream_collide_{fwd['key']}[{run['cell']}]",
                f"lettuce_tpu_torch/csrc/{sc.FRAGMENTS[fwd['fragment']][0]}"
                ".cu", EMIT_U_REPLACES, fwd["launches"],
                max(fwd["err"], worst_gradients.get(fwd["key"], 0.0)),
                fwd["ms"], fwd["plain_ms"], fwd["cells"], fwd["bytes"],
                fwd["ops"], cell=run["cell"]))
        kernels.append(kernel_entry(
            f"stream_collide_adjoint_{adj['key']}[{run['cell']}]",
            ADJOINT_FRAGMENTS_SOURCE,
            f"lettuce_tpu/ops/pallas/adjoint.py:"
            f"{ADJOINT_SPEC_REPLACES[adj['spec']]}", adj["launches"],
            max(adj["err"], worst_gradients.get("adjoint_" + adj["key"],
                                                0.0)),
            adj["ms"], adj["plain_ms"], adj["cells"], adj["bytes"],
            adj["ops"], cell=run["cell"], mode=run["mode"]))
    kernels += half_entries(worst_half, half_main, half_cells, half_state)
    kernels += multi_entries(worst_multi, blocked, blocked_gradient)
    kernels += masked_multi_entries(worst_masked_multi, bounded)
    kernels += half_gradient_entries(worst_half_gradient, half_gradient,
                                     half_blocked)
    kernels += cell_launch_entries(cell_launch)
    kernels += k5_entries(moments_rows)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
