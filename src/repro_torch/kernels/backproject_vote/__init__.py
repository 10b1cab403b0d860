"""Fused back-projection + vote + store: CUDA kernel, wrappers, plain version."""
