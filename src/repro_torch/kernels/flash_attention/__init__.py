"""Flash attention forward: CUDA kernel, wrapper, plain version."""
