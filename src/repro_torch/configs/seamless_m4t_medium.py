"""SeamlessM4T-medium (enc-dec, audio frontend stubbed). [arXiv:2308.11596; hf]

12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a stub per the assignment: input_specs() provides
precomputed frame embeddings [B, S_enc, d_model].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        n_dec_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256_206,
        modality="audio",
        rope_kind="none",  # enc-dec uses learned/sinusoidal positions; we use rope-free attn
        source="arXiv:2308.11596; hf",
    )
)
