"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B (port of
``repro/configs/qwen2_moe_a2_7b.py``, fields as the reference has them).

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE: 4 shared + 60 routed top-4. QKV bias (Qwen1.5 family).
"""
import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    arch_id="qwen2-moe-a2.7b",
    family="lm",
    model=TransformerConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151_936, qkv_bias=True,
        moe=MoEConfig(d_model=2048, d_ff=1408, n_experts=60, top_k=4, n_shared=4),
    ),
    shapes=LM_SHAPES,
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
    notes="60 routed experts. On one device they run as they are; expert parallelism "
          "over a 'model' axis needs E % tp == 0, so the reference pads the expert count "
          "to 64 with 4 never-routed experts (router logits only span the real 60); "
          "that dispatch waits for the LM cells over a group (ROADMAP A7g).",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=TransformerConfig(
            name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=96, vocab_size=512, qkv_bias=True,
            moe=MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2, n_shared=1),
        ),
    )
