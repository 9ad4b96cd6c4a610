"""qwen2.5-3b — Qwen2.5 3B, GQA + QKV bias (port of
``repro/configs/qwen2_5_3b.py``, fields as the reference has them).

[hf:Qwen/Qwen2.5-0.5B; hf] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936.
"""
import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    arch_id="qwen2.5-3b",
    family="lm",
    model=TransformerConfig(
        name="qwen2.5-3b",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab_size=151_936, qkv_bias=True,
    ),
    shapes=LM_SHAPES,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=TransformerConfig(
            name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=160, vocab_size=512, qkv_bias=True,
        ),
    )
