"""Row gather: CUDA kernel, wrapper and plain version."""
