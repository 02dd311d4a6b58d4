"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``stream_collide`` (the fused BGK collide-and-stream step)."""
