"""Qwen2-VL 72B (vision frontend stubbed). [arXiv:2409.12191; hf]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE over
(temporal, height, width); dynamic-resolution ViT is a stub: input_specs()
provides precomputed patch embeddings for the leading positions.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29_568,
        vocab_size=152_064,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),  # sums to head_dim//2 = 64
        rope_theta=1_000_000.0,
        modality="vision",
        frontend_tokens=256,
        source="arXiv:2409.12191; hf",
    )
)
