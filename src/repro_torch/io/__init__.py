"""Ragged CSR batches."""
