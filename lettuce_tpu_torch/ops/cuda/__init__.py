"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``stream_collide`` (the fused BGK collide-and-stream step, with
an emit-u variant) and ``adjoint`` (its vector-Jacobian product), joined
into one differentiable step by ``fused_step``; ``build`` compiles and
loads them."""
