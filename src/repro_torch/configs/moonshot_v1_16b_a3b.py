"""moonshot-v1-16b-a3b — Moonlight-16B-A3B MoE LM (port of
``repro/configs/moonshot_v1_16b_a3b.py``, fields as the reference has them).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 vocab=163840, MoE 64e top-6.
"""
import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="lm",
    model=TransformerConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163_840,
        moe=MoEConfig(d_model=2048, d_ff=1408, n_experts=64, top_k=6),
    ),
    shapes=LM_SHAPES,
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=TransformerConfig(
            name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=96, vocab_size=512,
            moe=MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2),
        ),
    )
