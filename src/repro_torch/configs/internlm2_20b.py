"""internlm2-20b — InternLM2 20B, GQA (port of
``repro/configs/internlm2_20b.py``, fields as the reference has them:
llama-arch, RMSNorm, RoPE at θ 10,000, SwiGLU, no QKV bias).

[arXiv:2403.17297; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
import dataclasses

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchConfig(
    arch_id="internlm2-20b",
    family="lm",
    model=TransformerConfig(
        name="internlm2-20b",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92_544,
    ),
    shapes=LM_SHAPES,
    source="[arXiv:2403.17297; hf]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=TransformerConfig(
            name="internlm2-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=192, vocab_size=512,
        ),
    )
