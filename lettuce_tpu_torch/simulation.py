"""Simulation driver: mask construction, step-path selection, step loop.

Boundary masks are uint8 index-coded (``no_collision_mask``) plus a
per-(q, node) ``no_streaming_mask``; collision and each boundary compose
pointwise with ``where``; calling the simulation runs ``num_steps`` eager
steps and returns MLUPS; :meth:`Simulation.rollout` runs steps and gathers
observables into a device tensor.

Two step paths:
  * ``"torch"``: the plain tensor step (collision, boundaries, per-q roll),
    differentiable by ordinary autograd;
  * ``"cuda"``: the fused CUDA stream-collide kernel with the
    collision's fragment (masked when the flow has boundaries), chosen on
    a CUDA context with ``use_native`` when every component supports it,
    for a float32, float64, bfloat16 or float16 state (16-bit states run
    the 16-bit instances, K1f, computing in float32, and differentiate on
    the 16-bit emit-u and adjoint kernels, K1d and K3 at 16 bits, with a
    float32 u residual).
    Outlets ride it through the window replay of
    ``ops/cuda/hybrid_outlets.py`` (``'cuda+hybrid'``). The capability
    probe makes host-side checks only (component types, the collision
    spec, the state's dtype, the outlets' replay windows), the same ones
    the kernel gate raises on, and prints its reason when it keeps the
    torch step; a build or launch error is never caught. Its
    differentiable step (``make_step_fn``, ``make_segment_fn``, and
    ``__call__`` on a state that requires grad) is ``fused_step`` for
    every collision: the fragment's kernel forward, the adjoint kernel
    backward (``adjoint_mode`` ``'full'``), or for a collision without a
    closed-form Jacobian the streaming-transpose kernel and the VJP of the
    pointwise pre-streaming map (``'split'``), then the replay under
    autograd.

Temporal blocking (``LETTUCE_NSUB=n``, 0 disables; off by default, as on
lettuce_tpu off the TPU): the throughput loop runs the bulk of a run as
``n // span`` launches of the blocked kernel (K2, ``span`` steps each,
periodic or masked) and the remainder single-step, as lettuce_tpu's
``_run_mixed``; outlets replay their window at that span after each
blocked launch. ``step_path`` says ``'cuda x<span>'`` or
``'cuda+hybrid x<span>'``. On a periodic grid gradient segments (and a
state that requires grad) scan the span-2 blocked step, whose backward is
the blocked adjoint (K4, at 16 bits for a 16-bit state), when K4 takes
the collision; a bounded flow's gradients, and ``make_step_fn``, stay
single-step.

``half_storage=True`` keeps the state of the throughput loop (``__call__``
and ``rollout``) as bfloat16 deviations g = f - w_q between steps, as
lettuce_tpu's ``half_storage`` does: encoded once per run, stepped by the
deviation instances (K1e, one launch per step), decoded once at the end,
so ``flow.f`` stays in the context's dtype between calls. It halves the
bytes per step; compute stays float32. It needs the kernel path and
refuses what lettuce_tpu refuses (the closed-form MRT bases, outlets);
then it warns and runs at full precision. Gradients (``make_step_fn``,
``make_segment_fn``, a state that requires grad) never run in
deviations: they run in the context's dtype.

No step ever writes into a tensor that a caller holds: the kernel path's
throughput loop ping-pongs between two buffers the simulation allocated
and never exposes (the replay writes into the buffer the kernel just
wrote), and its last step of each run writes a fresh tensor.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from functools import partial
from timeit import default_timer as timer
from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .ops.collision import Collision
from .ops.cuda import adjoint
from .ops.cuda.fused_step import fused_multi_step, fused_step
from .ops.cuda.hybrid_outlets import build_hybrid_fixup, nsm_outside_regions
from .ops.cuda.stream_collide import (build_fused_multi_step,
                                      decode_deviations, encode_deviations,
                                      gate_fused_params, kernel_refusals,
                                      load_libraries, stream_collide,
                                      without_nsm)
from .ops.streaming import compose_step

__all__ = ["Collision", "Reporter", "Simulation"]


class Reporter(ABC):
    """Interval callback protocol."""

    interval: int

    def __init__(self, interval: int):
        self.interval = interval

    @abstractmethod
    def __call__(self, simulation: "Simulation"):
        ...


def _gcd_interval(reporters: List["Reporter"]) -> Optional[int]:
    intervals = [max(1, int(r.interval)) for r in reporters]
    if not intervals:
        return None
    g = intervals[0]
    for i in intervals[1:]:
        g = np.gcd(g, i)
    return int(g)


class Simulation:
    """Orchestrates masks, step-path selection and the step loop."""

    def __init__(self, flow: "Flow", collision: "Collision",
                 reporter: List["Reporter"], half_storage: bool = False):
        self.flow = flow
        self.half_storage = half_storage
        self.flow.collision = collision
        self.context = flow.context
        self.collision = collision
        self.reporter = reporter
        # deterministic mask precedence: class name, then declaration order
        self.boundaries = ([None]
                           + sorted(flow.boundaries,
                                    key=lambda b: type(b).__name__))

        # ---------------- masks ----------------
        self.no_collision_mask = None
        self.no_streaming_mask = None
        if len(self.boundaries) > 1:
            ncm = np.zeros(tuple(flow.resolution), dtype=np.uint8)
            nsm = np.zeros((flow.stencil.q, *flow.resolution), dtype=bool)
            for i, boundary in enumerate(self.boundaries[1:], start=1):
                m = boundary.make_no_collision_mask(
                    list(flow.resolution), context=self.context)
                if m is not None:
                    ncm[self.context.convert_to_ndarray(m).astype(bool)] = i
                s = boundary.make_no_streaming_mask(
                    [flow.stencil.q, *flow.resolution], context=self.context)
                if s is not None:
                    nsm |= self.context.convert_to_ndarray(s).astype(bool)
            self.no_collision_mask = self.context.convert_to_tensor(ncm)
            self.no_streaming_mask = self.context.convert_to_tensor(nsm)

        # ---------------- step-path selection ----------------
        self._step = self._torch_step
        self._step_kind = "torch"
        self._fixup = None
        self._half_params = None
        self._step_multi = None  # (step, span): the blocked kernel (K2)
        self._half_multi = None  # the same in bfloat16 deviations
        if self.context.use_native and self._native_supported():
            # a build error surfaces here, never later
            load_libraries()
            adjoint.load_libraries()
            self._use_kernel()
        if half_storage:
            self._use_half_storage()

    # ------------------------------------------------------------------
    # step construction
    # ------------------------------------------------------------------
    def _native_supported(self) -> bool:
        """Capability probe: a CUDA device, and no reason of
        ``kernel_refusals`` (the checks the kernel gate raises on: a
        float32, float64 or 16-bit state, a compiled stencil, the
        quadratic equilibrium, a
        collision with a compiled fragment, boundaries with a kind in the
        kernel's table or an outlet the window replay can rewrite). Prints
        each reason that keeps the torch step."""
        if self.context.device.type != "cuda":
            return False  # a CPU context runs the torch step
        reasons = kernel_refusals(self)
        for reason in reasons:
            print(f"native was requested, but {reason}.")
        return not reasons

    def _use_kernel(self):
        """Select the kernel path: the gate's parameters, and the window
        replay of the outlets the kernel leaves frozen. The kernel runs
        without the no-streaming mask when every frozen population lies
        in planes the replay rewrites. ``_buffers`` are the two state
        buffers the throughput loop steps between (out of place); they
        are never handed out. The differentiable step is ``fused_step``
        with the gate's parameters and the replay. ``_step_multi`` is the
        blocked step when a span is asked for and nothing refuses it
        (:func:`build_fused_multi_step`), with its own parameters and its
        replay at that span: the two replays, and whether each kernel
        reads the no-streaming mask, are kept apart."""
        params, hybrid = gate_fused_params(self)
        self._fixup = None
        if hybrid:
            self._fixup, regions = build_hybrid_fixup(self, hybrid)
            if (params["nsm"] is not None
                    and not nsm_outside_regions(params["nsm"], regions)):
                params = without_nsm(params)
        self._kernel_params = params
        self._buffers = [None, None]
        if self._fixup is None:
            self._step = partial(fused_step, **params)
        else:
            self._step = partial(fused_step, fixup=self._fixup, **params)
        self._step_kind = "cuda"
        self._step_multi = build_fused_multi_step(self)

    def _use_half_storage(self):
        """Select bfloat16 deviation storage for the throughput loop: the
        gate's parameters for the deviation instances, when the kernel path
        is selected and ``kernel_refusals(..., dev_storage=True)`` is
        empty. Otherwise warn with the reasons, as lettuce_tpu does, and
        keep full precision. The blocked step in deviations runs when the
        full-precision one does (``_half_multi``)."""
        self._half_params = None
        self._half_multi = None
        if self._step_kind != "cuda":
            reasons = [f"the {self._step_kind} step runs, not the CUDA "
                       f"kernel"]
        else:
            reasons = kernel_refusals(self, dev_storage=True)
        if reasons:
            warnings.warn(f"half_storage requires the CUDA kernel path with "
                          f"deviation storage ({'; '.join(reasons)}); "
                          f"running at full precision.")
            return
        self._half_params = gate_fused_params(self, dev_storage=True)[0]
        if self._step_multi is not None:
            self._half_multi = build_fused_multi_step(self, dev_storage=True)

    def _encode(self, f: torch.Tensor) -> torch.Tensor:
        return encode_deviations(f, self.flow.stencil.w)

    def _decode(self, g: torch.Tensor) -> torch.Tensor:
        return decode_deviations(g, self.flow.stencil.w, self.context.dtype)

    @staticmethod
    def _spans(n: int, multi) -> list:
        """The steps of each launch of an ``n``-step run: ``n // span``
        blocked launches of ``multi`` (``(step, span)`` or None), then
        the remainder one step each (lettuce_tpu's ``_run_mixed``)."""
        span = 1 if multi is None else multi[1]
        return [span] * (n // span) + [1] * (n % span)

    @staticmethod
    def _blocked(multi, f: torch.Tensor, out: torch.Tensor = None
                 ) -> torch.Tensor:
        """One launch of the blocked step ``multi`` (``(step, span)``) from
        ``f`` into ``out`` (a fresh tensor when None), then its replay over
        it."""
        step, span = multi
        out = stream_collide(f, out=out, n_sub=span, **step.params)
        return out if step.fixup is None else step.fixup(f, out)

    def _run_half(self, g: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` steps of the deviations ``g`` between the simulation's two
        buffers: the blocked bulk and the single-step remainder."""
        for n_sub in self._spans(n, self._half_multi):
            out = self._buffer(0, g)
            if out.data_ptr() == g.data_ptr():
                out = self._buffer(1, g)
            if n_sub == 1:
                g = stream_collide(g, out=out, **self._half_params)
            else:
                g = self._blocked(self._half_multi, g, out)
        return g

    def _half_run_of(self, f: torch.Tensor) -> bool:
        """Whether a run from ``f`` steps in deviations: half storage is
        engaged and ``f`` is outside autograd."""
        return self._half_params is not None and not (
            f.requires_grad and torch.is_grad_enabled())

    def _torch_step(self, f: torch.Tensor) -> torch.Tensor:
        """One collide-and-stream step in plain torch."""
        return compose_step(f, self.flow, self.collision,
                            self.boundaries[1:], self.no_collision_mask,
                            self.no_streaming_mask)

    def _cuda_step(self, f: torch.Tensor, out: torch.Tensor = None
                   ) -> torch.Tensor:
        """One step through the CUDA kernel, into ``out`` (a fresh tensor
        when None), then the outlets' window replay over it."""
        out = stream_collide(f, out=out, **self._kernel_params)
        return out if self._fixup is None else self._fixup(f, out)

    def _buffer(self, i: int, like: torch.Tensor) -> torch.Tensor:
        """The simulation's own state buffer ``i`` (0 or 1), allocated like
        ``like`` when it is missing or does not fit."""
        b = self._buffers[i]
        if (b is None or b.shape != like.shape or b.dtype != like.dtype
                or b.device != like.device):
            b = self._buffers[i] = torch.empty_like(
                like, memory_format=torch.contiguous_format)
        return b

    def _advance(self, f: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` steps from ``f``. The kernel path outside autograd steps
        between the simulation's two buffers, and its last step writes a
        fresh tensor, so neither ``f`` nor any tensor returned earlier is
        written. The bulk runs blocked when ``_step_multi`` is set, each
        launch followed by its replay. Under
        half storage ``f`` is encoded once, stepped in deviations and
        decoded once into a fresh tensor. A state that requires grad runs
        the gradient segment's route (:meth:`make_segment_fn`)."""
        if self._half_run_of(f):
            return self._decode(self._run_half(self._encode(f), n))
        if self._step_kind != "cuda":
            for _ in range(n):
                f = self._step(f)
            return f
        if f.requires_grad and torch.is_grad_enabled():
            return self.make_segment_fn(n)(f)
        spans = self._spans(n, self._step_multi)
        for i, n_sub in enumerate(spans):
            out = None if i == len(spans) - 1 else self._buffer(i % 2, f)
            if n_sub == 1:
                f = self._cuda_step(f, out)
            else:
                f = self._blocked(self._step_multi, f, out)
        return f

    def make_step_fn(self):
        """One collide-and-stream step as a function ``f -> f'`` for custom
        loops (learned collisions, differentiable rollouts): on the kernel
        path the differentiable ``fused_step`` bound to the kernel
        parameters (and the replay), else the torch step. It returns a
        fresh tensor and never writes into its input."""
        return self._step

    def make_segment_fn(self, num_steps: int,
                        checkpoint_every: Optional[int] = None):
        """``num_steps`` collide-and-stream steps as one reverse-
        differentiable function ``f -> f'``, the rollout analog of
        :meth:`make_step_fn` for training loops.

        ``checkpoint_every=k`` runs the rollout in chunks of ``k`` steps
        under ``torch.utils.checkpoint`` (non-reentrant): the backward
        stores one state per chunk instead of one residual per step and
        recomputes each chunk's forward, so residual memory drops from
        O(num_steps) to O(num_steps / k + k) at about twice the forward
        cost. The remainder steps run plainly. Pick k ~ sqrt(num_steps).

        With temporal blocking engaged (``LETTUCE_NSUB``) and a collision
        the blocked adjoint (K4) takes, the bulk runs as span-2 launches of
        the blocked step (K2 forward, K4 backward; lettuce_tpu's segments
        peak at span 2, its simulation.py:341-347) in chunks of
        ``k // 2`` launches, and the remainder single-step.
        """
        single = self._step
        step, span = single, 1
        multi = self._step_multi
        if multi is not None and multi[0].adjoint_kernel:
            step, span = partial(fused_multi_step, n_sub=2,
                                 **self._kernel_params), 2
        num_steps = int(num_steps)
        n_launches, rem = divmod(num_steps, span)

        def run(f, n, fn=step):
            for _ in range(n):
                f = fn(f)
            return f

        if checkpoint_every is None:
            return lambda f: run(run(f, n_launches), rem, single)
        k = max(1, int(checkpoint_every) // span)
        n_chunks, n_rest = divmod(n_launches, k)

        def segment(f):
            for _ in range(n_chunks):
                f = checkpoint(run, f, k, use_reentrant=False)
            return run(run(f, n_rest), rem, single)

        return segment

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @property
    def units(self):
        return self.flow.units

    @property
    def adjoint_mode(self) -> Optional[str]:
        """How the kernel path's gradient runs: ``'full'`` (one adjoint
        kernel per step), ``'split'`` (the streaming-transpose kernel, then
        the VJP of the pointwise pre-streaming map), or None on the torch
        step, whose gradient is autograd's."""
        if self._step_kind != "cuda":
            return None
        return self._kernel_params["collision_spec"].mode

    @property
    def half_storage_engaged(self) -> bool:
        """Whether the throughput loop steps in bfloat16 deviations:
        ``half_storage`` was asked for and nothing refused it."""
        return self._half_params is not None

    @property
    def step_path(self) -> str:
        """The selected step path: ``'cuda x1'`` (fused kernel, one step
        per launch), ``'cuda x<span>'`` (the blocked kernel, ``span`` steps
        per launch, under half storage the deviations' span),
        ``'cuda+hybrid x<span>'`` (the kernel, then the outlets' window
        replay) or ``'torch x1'`` (plain tensor step)."""
        hybrid = "+hybrid" if self._fixup is not None else ""
        multi = (self._half_multi if self._half_params is not None
                 else self._step_multi)
        span = 1 if multi is None else multi[1]
        return f"{self._step_kind}{hybrid} x{span}"

    def _report(self):
        for reporter in self.reporter:
            reporter(self)

    def _synchronize(self):
        if self.context.device.type == "cuda":
            torch.cuda.synchronize(self.context.device)

    def rollout(self, num_steps: int, observables=None,
                interval: int = 1) -> torch.Tensor:
        """Run ``num_steps`` steps, evaluating the scalar ``observables``
        every ``interval`` steps into one device tensor of shape
        ``[num_steps // interval, len(observables)]`` in the state's dtype,
        with no host round trip (lettuce_tpu's ``rollout``). ``flow.f`` and
        ``flow.i`` advance as with a call; the reporters are not called.
        Under half storage the run steps in deviations throughout and
        decodes a state only for the observables, so its final state equals
        that of ``simulation(num_steps)``."""
        observables = list(observables or [])
        interval = max(1, int(interval))
        n_chunks, rem = divmod(int(num_steps), interval)
        f = self.flow.f
        records = torch.empty((n_chunks, len(observables)), dtype=f.dtype,
                              device=f.device)
        half = self._half_run_of(f)
        state = self._encode(f) if half else f
        run = self._run_half if half else self._advance
        for k in range(n_chunks):
            state = run(state, interval)
            if observables:
                view = self._decode(state) if half else state
                records[k] = torch.stack([torch.as_tensor(obs(view))
                                          .to(records) for obs in
                                          observables])
        state = run(state, rem)
        self.flow.f = self._decode(state) if half else state
        self.flow.i += int(num_steps)
        return records

    def __call__(self, num_steps: int) -> float:
        """Run ``num_steps`` steps, calling the reporters at the gcd of
        their intervals; returns MLUPS (timed between two device
        synchronisations on a CUDA device)."""
        self._synchronize()
        beg = timer()

        if self.flow.i == 0:
            self._report()

        g = _gcd_interval(self.reporter)
        remaining = int(num_steps)
        while remaining > 0:
            if g is None:
                n = remaining
            else:
                n = min(g - (self.flow.i % g) or g, remaining)
            self.flow.f = self._advance(self.flow.f, n)
            self.flow.i += n
            remaining -= n
            if g is not None:
                self._report()

        self._synchronize()
        end = timer()
        return (num_steps * float(np.prod(self.flow.resolution))
                / 1e6 / (end - beg))
