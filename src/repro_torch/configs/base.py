"""Config system: model configs, input shapes, run configs.

The port's own copy of the JAX package's config system (pure data, so the
port never imports ``repro``). Every assigned architecture is a
``ModelConfig`` registered in ``REGISTRY`` (one module per arch under
``repro_torch.configs``). ``ModelConfig.reduced()`` produces a small
same-family config for CPU smoke tests. The port runs the dense family
(GQA, a sliding window only in its local:global layers, or MLA), ``moe``
with GQA or MLA attention, ``ssm`` and ``hybrid`` so far
(``repro_torch.models.model.FAMILIES``,
``repro_torch.models.transformer.ATTN_SCHEMAS``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: family, widths, attention flavour and options."""

    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention flavour ---
    attn_kind: str = "gqa"  # "gqa" | "mla" | "none"
    rope_kind: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl: (16, 24, 24) of head_dim//2
    sliding_window: int = 0  # 0 = full attention
    local_global_period: int = 0  # gemma3: 6 -> [5 local, 1 global] superblocks

    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # routed-expert FFN dim (if != d_ff)
    first_k_dense: int = 0  # leading dense layers (deepseek-v2: 1)
    moe_capacity_factor: float = 2.0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0  # apply tied shared attn block every N ssm layers

    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stub ---
    modality: str = "text"  # "text" | "audio" | "vision"
    frontend_tokens: int = 0  # patch/frame positions prepended for vlm training

    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""  # citation tag from the assignment

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none" and self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (assignment rule)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.local_global_period > 0
        )

    def n_params(self) -> int:
        """Total parameter count (analytic, matches param_schema)."""
        from repro_torch.models.model import count_params

        return count_params(self)

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k routed)."""
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.family == "moe":
            kw.update(n_experts=4, moe_top_k=min(self.moe_top_k, 2), moe_d_ff=128,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1))
        if self.attn_kind == "mla":
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32, head_dim=0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(n_layers=6, shared_attn_period=3)
        if self.family == "encdec":
            kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=2)
        if self.local_global_period:
            kw.update(n_layers=8, local_global_period=4, sliding_window=64)
        if self.sliding_window and not self.local_global_period:
            kw.update(sliding_window=64)
        if self.mrope_sections:
            kw.update(mrope_sections=(8, 4, 4))
        if self.frontend_tokens:
            kw.update(frontend_tokens=16)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is full-attention ({cfg.attn_kind}); long_500k requires "
            "sub-quadratic attention per the assignment — skipped (see DESIGN.md)"
        )
    return True, ""


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    """Add ``cfg`` to ``REGISTRY`` under its name."""
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config called ``name``."""
    _ensure_loaded()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> list[str]:
    """Names of every registered architecture."""
    _ensure_loaded()
    return sorted(REGISTRY)


_ARCH_MODULES = [
    "llama4_scout_17b_a16e",
    "deepseek_v2_236b",
    "mamba2_130m",
    "phi4_mini_3p8b",
    "granite_8b",
    "mistral_large_123b",
    "gemma3_4b",
    "seamless_m4t_medium",
    "qwen2_vl_72b",
    "zamba2_7b",
]


def _ensure_loaded() -> None:
    import importlib

    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
