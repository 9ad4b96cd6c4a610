"""Ragged CSR batches, ColumnIO tables and their loader, the synthetic data generator."""
