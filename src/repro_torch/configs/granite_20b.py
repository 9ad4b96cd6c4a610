"""granite-20b — IBM Granite 20B (code), llama-arch, MQA (port of
``repro/configs/granite_20b.py``, fields as the reference has them: RMSNorm,
RoPE at θ 10,000, SwiGLU, no QKV bias).

[arXiv:2405.04324; hf] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    arch_id="granite-20b",
    family="lm",
    model=TransformerConfig(
        name="granite-20b",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49_152,
    ),
    shapes=LM_SHAPES,
    source="[arXiv:2405.04324; hf]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=TransformerConfig(
            name="granite-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=1, d_ff=256, vocab_size=512,
        ),
    )
