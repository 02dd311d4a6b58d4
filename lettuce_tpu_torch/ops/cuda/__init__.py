"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``stream_collide`` (the fused collide-and-stream step of every
collision fragment, with emit-u, masked and 16-bit variants, and the gate
that selects them) and
``adjoint`` (its vector-Jacobian product), joined into one differentiable
step by ``fused_step``; ``hybrid_outlets`` replays the outlets' planes
after the kernel; ``moments`` is the velocity moment of ``Flow.u`` and
its adjoint; ``build`` compiles and loads them."""
