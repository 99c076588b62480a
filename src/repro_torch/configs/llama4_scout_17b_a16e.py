"""Llama-4 Scout 17B-active/16-expert. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1,
one shared expert per layer (early-fusion multimodal; text backbone here).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=16,
        n_shared_experts=1,
        moe_top_k=1,
        moe_d_ff=8192,
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
)
