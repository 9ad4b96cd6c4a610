"""Fused multi-column bucketize: CUDA kernel, wrapper and plain version."""
