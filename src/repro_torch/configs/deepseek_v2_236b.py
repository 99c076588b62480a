"""DeepSeek-V2 236B. [arXiv:2405.04434; hf]

60L d_model=5120 128H MLA (kv_lora=512, rope/nope split), first layer dense
(d_ff=12288), 59 MoE layers: 2 shared + 160 routed experts (d_ff=1536) top-6.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12_288,  # dense-layer FFN
        vocab_size=102_400,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        first_k_dense=1,
        rope_theta=10_000.0,
        source="arXiv:2405.04434; hf",
    )
)
