"""Sequence tile (concat pooling): CUDA kernels, wrapper and plain version."""
