"""Phi-4-mini 3.8B. [arXiv:2412.08905; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        rope_theta=10_000.0,
        source="arXiv:2412.08905; hf",
    )
)
