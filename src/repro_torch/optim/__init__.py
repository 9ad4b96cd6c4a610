"""Optimizers: SparseAdam(W) for embedding rows, AdamW for the dense side."""
