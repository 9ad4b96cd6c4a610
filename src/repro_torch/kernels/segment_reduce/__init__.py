"""Segment reduce: CUDA kernel, wrapper and plain version."""
