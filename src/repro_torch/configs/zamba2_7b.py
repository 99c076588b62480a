"""Zamba2-7B (hybrid Mamba2 + shared attention). [arXiv:2411.15242; unverified]

81 Mamba2 layers d_model=3584 ssm_state=64, with a tied shared attention+MLP
block (32H kv=32, d_ff=14336) applied every 6 SSM layers (13 applications).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14_336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        shared_attn_period=6,
        rope_theta=10_000.0,
        source="arXiv:2411.15242; unverified",
    )
)
