"""Row scatter-update: CUDA kernel, wrapper and plain version."""
