"""Twins of the repo's benchmarks (``benchmarks/``) on the port. Each takes
``--out`` and prints its numbers; none writes the repo's ``BENCH_*.json``."""
