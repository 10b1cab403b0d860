"""The detection tail (adaptive threshold, depth, 3x3 median): CUDA kernel, wrapper."""
