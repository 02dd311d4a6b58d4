"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``stream_collide`` (the fused BGK collide-and-stream step, with
emit-u and masked variants, and the gate that selects them) and
``adjoint`` (its vector-Jacobian product), joined into one differentiable
step by ``fused_step``; ``hybrid_outlets`` replays the outlets' planes
after the kernel; ``build`` compiles and loads them."""
