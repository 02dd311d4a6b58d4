"""The differentiable fused step: a ``torch.autograd.Function`` whose
forward is the emit-u stream-collide kernel and whose backward is the
adjoint kernel, periodic or masked.

It is the counterpart of the ``custom_vjp`` of
``lettuce_tpu/ops/pallas/stream_collide.py::build_fused_step``. When the
input needs a gradient, the forward also emits the pre-collision velocity
u and saves only that (d fields instead of the q of the state); otherwise
it runs the primal kernel and saves nothing. The backward hands the
contiguous cotangent, u and the forward's masks and table to the adjoint
kernel. On CPU tensors both wrappers run their plain versions, so the same
wiring runs without a card.

A flow with outlets composes the window replay after the Function under
ordinary autograd (``fixup``): the replay's in-place write gives the
planes it rewrites a zero cotangent on the kernel's side, which is the
split of ``build_fused_step``'s hybrid backward, and its own graph saves
its window.

Every call returns a freshly allocated output: it never writes into its
input or into an earlier output, which autograd could not notice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .adjoint import check_bgk, stream_collide_adjoint
from .stream_collide import stream_collide

__all__ = ["fused_step"]


class _FusedStep(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, params):
        f = f.contiguous()
        ctx.params = params
        if not ctx.needs_input_grad[0]:
            return stream_collide(f, **params)
        d = np.asarray(params["e"]).shape[1]
        u = torch.empty((d, *f.shape[1:]), dtype=f.dtype, device=f.device)
        out, u = stream_collide(f, u_out=u, **params)
        ctx.save_for_backward(u)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (u,) = ctx.saved_tensors
        return (stream_collide_adjoint(grad_out.contiguous(), u,
                                       **ctx.params), None)


def fused_step(f: torch.Tensor, *, e, w, opposite, cs: float,
               tau_inv: float, collision_spec=None, ncm=None, nsm=None,
               table=None, feq_field=None, fixup=None) -> torch.Tensor:
    """One differentiable BGK collide-and-stream step ``f -> f'`` through
    the kernels (or their plain versions on CPU tensors), with the static
    kernel parameters of :func:`.stream_collide.gate_fused_params`, and
    the window replay ``fixup`` of :mod:`.hybrid_outlets` after the kernel
    when the flow has outlets. A ``collision_spec`` other than BGK raises
    NotImplementedError: its adjoint kernel is not there yet."""
    check_bgk(collision_spec)
    out = _FusedStep.apply(f, dict(
        e=e, w=w, opposite=opposite, cs=cs, tau_inv=tau_inv,
        collision_spec=collision_spec, ncm=ncm, nsm=nsm, table=table,
        feq_field=feq_field))
    return out if fixup is None else fixup(f, out)
