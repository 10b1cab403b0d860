"""Depth max/argmax + parabola refinement: CUDA kernel, wrapper, plain version."""
