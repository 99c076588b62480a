"""Gemma-3 4B. [hf:google/gemma-3-1b-pt; unverified]

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 — 5:1 local:global
sliding-window pattern (window 1024), 128k context.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10_240,
        vocab_size=262_144,
        sliding_window=1024,
        local_global_period=6,  # [5 local : 1 global]
        rope_theta=1_000_000.0,
        source="hf:google/gemma-3-1b-pt; unverified",
    )
)
