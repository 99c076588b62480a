"""Mamba2-130M (SSD, attention-free). [arXiv:2405.21060; unverified]

24L d_model=768, ssm_state=128, expand=2 (d_inner=1536), head_dim=64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        attn_kind="none",
        rope_kind="none",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        source="arXiv:2405.21060; unverified",
    )
)
