"""The sweep's front end (geometry, Table 1, the homography): CUDA kernel, wrapper."""
