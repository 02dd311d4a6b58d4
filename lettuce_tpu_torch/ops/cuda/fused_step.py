"""The differentiable fused step: a ``torch.autograd.Function`` whose
forward is the collision fragment's stream-collide kernel and whose
backward is its adjoint kernel, periodic or masked, for every collision
spec the kernels take.

It is the counterpart of the ``custom_vjp`` of
``lettuce_tpu/ops/pallas/stream_collide.py::build_fused_step`` and its
backward rules (:2103-2192). The packed spec (:class:`.stream_collide.
PackedSpec`) says what the forward saves and how the backward runs:

* full mode, u residual (BGK, TRT, the folded MRT, the regularized): the
  forward runs the fragment's emit-u kernel and saves only the
  pre-collision velocity u (d fields instead of the q of the state); the
  backward runs the spec's adjoint kernel on it;
* full mode, f residual (Smagorinsky, whose Jacobian needs rho and the
  deviations): the forward runs the primal kernel and saves its input;
* full mode, no residual (the identity);
* split mode (KBC, the closed-form MRT bases, forced BGK): the forward
  runs the primal kernel and saves its input; the backward runs the
  ``none`` adjoint kernel with the no-streaming re-route and no boundary
  routing (the streaming transpose), then the VJP of the pointwise
  pre-streaming map (:func:`.adjoint.prestream_vjp`, recomputed from the
  saved input).

Without a gradient the forward runs the primal kernel and saves nothing.
On CPU tensors every wrapper runs its plain version, so the same wiring
runs without a card.

A flow with outlets composes the window replay after the Function under
ordinary autograd (``fixup``): the replay's in-place write gives the
planes it rewrites a zero cotangent on the kernel's side, which is the
split of ``build_fused_step``'s hybrid backward, and its own graph saves
its window. Full mode keeps the u residual there: the port's replay is
plain torch and needs no state from the kernel's side.

Every call returns a freshly allocated output: it never writes into its
input or into an earlier output, which autograd could not notice.

The blocked step (:func:`fused_multi_step`, ``_FusedMultiStep``) is the
counterpart of the ``custom_vjp`` of lettuce_tpu's
``build_fused_multi_step`` (:2355-2404): its forward is one launch of the
blocked kernel (K2, ``n_sub`` steps) and saves only the launch input f;
its backward is one launch of the blocked adjoint (K4), which replays the
forward from f. Periodic grids, and the specs of
:func:`.adjoint.adjoint_multi_refusal`; a bounded flow's blocked step
(masks, the outlets' replay) runs forward only, as lettuce_tpu's does
(:2360-2362): its gradients step one step at a time.

A bfloat16 or float16 state runs the same routes on the 16-bit
instances, computing in float32 as lettuce_tpu's custom_vjp does at 16
bits: the emit-u forward at 16 bits (K1d) saves u in float32, the adjoint
kernels at 16-bit storage (K3) pull a 16-bit cotangent back, split mode's
pointwise VJP runs on float32 copies and rounds once, and the blocked step
runs K2 and K4 at 16 bits. Deviation storage (bfloat16 deviations) is a
throughput mode with no gradient, as in lettuce_tpu
(stream_collide.py:2073-2077).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ... import tracing
from .adjoint import (NONE_SPEC, adjoint_multi_refusal, prestream_vjp,
                      stream_collide_adjoint, stream_collide_adjoint_multi)
from .build import compute_dtype
from .stream_collide import pack_spec, stream_collide

__all__ = ["fused_step", "fused_multi_step"]


class _FusedStep(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, params):
        f = f.contiguous()
        ctx.params = params
        spec = params["collision_spec"]
        if not ctx.needs_input_grad[0] or spec.residual is None:
            return stream_collide(f, **params)
        if spec.residual == "f":
            ctx.save_for_backward(f)
            return stream_collide(f, **params)
        d = np.asarray(params["e"]).shape[1]
        # float32 for a 16-bit state: what the emit-u kernel writes
        u = torch.empty((d, *f.shape[1:]), dtype=compute_dtype(f.dtype),
                        device=f.device)
        out, u = stream_collide(f, u_out=u, **params)
        ctx.save_for_backward(u)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        with tracing.span("adjoint"):
            params = ctx.params
            spec = params["collision_spec"]
            g = grad_out.contiguous()
            # unpacked once: checkpoint allows no more
            saved = ctx.saved_tensors
            res = saved[0] if saved else None
            if spec.mode == "full":
                return stream_collide_adjoint(g, res, **params), None
            h = stream_collide_adjoint(
                g, None, e=params["e"], w=params["w"],
                opposite=params["opposite"], cs=params["cs"], tau_inv=None,
                nsm=params["nsm"], collision_spec=NONE_SPEC)
            return prestream_vjp(res, h, e=params["e"], w=params["w"],
                                 opposite=params["opposite"], cs=params["cs"],
                                 collision_spec=spec, ncm=params["ncm"],
                                 table=params["table"],
                                 feq_field=params["feq_field"]), None


def fused_step(f: torch.Tensor, *, e, w, opposite, cs: float,
               tau_inv: float = None, collision_spec=None, ncm=None,
               nsm=None, table=None, feq_field=None,
               fixup=None) -> torch.Tensor:
    """One differentiable collide-and-stream step ``f -> f'`` through the
    kernels (or their plain versions on CPU tensors), with the static
    kernel parameters of :func:`.stream_collide.gate_fused_params` (the
    collision ``collision_spec``, BGK with ``tau_inv`` when None), and the
    window replay ``fixup`` of :mod:`.hybrid_outlets` after the kernel
    when the flow has outlets. The spec's ``mode`` (``'full'`` or
    ``'split'``) says how its backward runs. A bfloat16 or float16 state
    runs the 16-bit instances both ways, with a float32 u residual."""
    with tracing.span("step"):
        if not torch.is_grad_enabled():
            f = f.detach()  # no graph: the forward saves nothing
        spec = pack_spec(("bgk", tau_inv) if collision_spec is None
                         else collision_spec, e, w, opposite)
        out = _FusedStep.apply(f, dict(
            e=e, w=w, opposite=opposite, cs=cs, tau_inv=tau_inv,
            collision_spec=spec, ncm=ncm, nsm=nsm, table=table,
            feq_field=feq_field))
        return out if fixup is None else fixup(f, out)


class _FusedMultiStep(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, params, n_sub):
        f = f.contiguous()
        ctx.params = params
        ctx.n_sub = n_sub
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(f)
        return stream_collide(f, n_sub=n_sub, **params)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        with tracing.span("adjoint"):
            (f,) = ctx.saved_tensors
            ct = stream_collide_adjoint_multi(f, grad_out.contiguous(),
                                              ctx.n_sub, **ctx.params)
            return ct, None, None


def fused_multi_step(f: torch.Tensor, *, n_sub: int, e, w, opposite,
                     cs: float, tau_inv: float = None, collision_spec=None,
                     ncm=None, nsm=None, table=None, feq_field=None,
                     dev_storage: bool = False, fixup=None) -> torch.Tensor:
    """``n_sub`` collide-and-stream steps ``f -> f'`` in one launch of the
    blocked kernel (K2, or its plain version on CPU tensors), with the
    static kernel parameters of :func:`.stream_collide.gate_fused_params`
    (masks included; ``dev_storage`` for a bfloat16 deviation state) and
    the outlets' window replay ``fixup`` at span ``n_sub`` after it. A
    state that requires grad, with grad mode on, goes through
    ``_FusedMultiStep``, whose backward is one launch of the blocked
    adjoint (K4, at 16 bits for a bfloat16 or float16 state) on a periodic
    grid; deviation storage, masks, a replay, or a spec that K4 does not
    take raise NotImplementedError then. Returns a fresh tensor."""
    with tracing.span("step"):
        spec = pack_spec(("bgk", tau_inv) if collision_spec is None
                         else collision_spec, e, w, opposite)
        params = dict(e=e, w=w, opposite=opposite, cs=cs, tau_inv=tau_inv,
                      collision_spec=spec)
        if not (f.requires_grad and torch.is_grad_enabled()):
            f = f.detach()
            out = stream_collide(f, n_sub=n_sub, dev_storage=dev_storage,
                                 ncm=ncm, nsm=nsm, table=table,
                                 feq_field=feq_field, **params)
            return out if fixup is None else fixup(f, out)
        if dev_storage:
            reason = "deviation storage is a throughput mode"
        elif ncm is not None or fixup is not None:
            reason = "the blocked adjoint runs periodic grids"
        else:
            reason = adjoint_multi_refusal(spec, f.dtype)
        if reason is not None:
            raise NotImplementedError(f"no blocked gradient: {reason}")
        return _FusedMultiStep.apply(f, params, n_sub)
