"""Pose interpolation for aggregated frames (the A stage's poses): CUDA kernel, wrapper."""
