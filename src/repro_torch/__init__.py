"""repro_torch — the RecIS reproduction in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

It mirrors the layout of the JAX package ``repro`` module for module and is
held against it by parity tests, but imports nothing of it (and never
``jax``). Feature ids are signed int64 tensors; every 64-bit hash is computed
bit-exactly in two's-complement int64 arithmetic (``core/feature_engine.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. A CUDA
tensor always goes through the repository's kernels (built from ``csrc/`` at
first use); a CPU tensor goes through each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
