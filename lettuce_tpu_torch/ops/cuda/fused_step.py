"""The differentiable fused step: a ``torch.autograd.Function`` whose
forward is the emit-u stream-collide kernel and whose backward is the
adjoint kernel.

It is the counterpart of the ``custom_vjp`` of
``lettuce_tpu/ops/pallas/stream_collide.py::build_fused_step`` for the
periodic BGK configuration. When the input needs a gradient, the forward
also emits the pre-collision velocity u and saves only that (d fields
instead of the q of the state); otherwise it runs the primal kernel and
saves nothing. The backward hands the contiguous cotangent and u to the
adjoint kernel. On CPU tensors both wrappers run their plain versions, so
the same wiring runs without a card.

Every call returns a freshly allocated output: it never writes into its
input or into an earlier output, which autograd could not notice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .adjoint import stream_collide_adjoint
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
               tau_inv: float) -> torch.Tensor:
    """One differentiable BGK collide-and-stream step ``f -> f'`` through
    the kernels (or their plain versions on CPU tensors), with the static
    kernel parameters of
    :func:`.stream_collide.gate_fused_params`."""
    return _FusedStep.apply(f, dict(e=e, w=w, opposite=opposite, cs=cs,
                                    tau_inv=tau_inv))
