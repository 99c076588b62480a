"""Shared layers: RMSNorm, rotary embeddings (RoPE and Qwen2-VL's M-RoPE),
the SwiGLU MLP, embedding.

The counterparts of ``repro.models.layers``. Weights keep the JAX layouts
(``w1`` [d, ff], ``embedding`` [V, d]); ``p`` is the layer's parameter
module, read by key as the JAX pytree is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.spec import PSpec


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------
def rmsnorm_schema(d: int) -> dict:
    """The norm's float32 scale, initialised to ones."""
    return {"scale": PSpec((d,), ("embed",), "float32", "ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    """float32 RMSNorm in ``x``'s dtype: the CUDA kernel on a card, its
    plain version on the CPU."""
    return rms_ops.rmsnorm(x, p["scale"], eps)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, [head_dim // 2] (float32)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] rotated in split-half pairs by the float32 angles
    ``pos * rope_freqs`` (pos [..., S, D/2] or [..., S, 1]), the result in
    ``x``'s dtype."""
    d = x.shape[-1]
    ang = pos * rope_freqs(d, theta, x.device)  # [..., S, d/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].to(torch.float32), x[..., d // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int. Split-half pairs, float32
    angles, the result in ``x``'s dtype."""
    return _rotate(x, positions[..., None].to(torch.float32), theta)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections, theta: float
                ) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). x: [..., S, H, D]; positions3: [..., S, 3]
    (t, h, w) int. The D/2 frequency slots are split into ``sections``: slot
    group ``i`` rotates by position component ``i`` (text: t == h == w).
    Split-half pairs, float32 angles, the result in ``x``'s dtype. As
    ``jnp.repeat(..., total_repeat_length=D // 2)``, sections that fall
    short of D/2 repeat their last id and longer ones are cut."""
    counts, left = [], x.shape[-1] // 2
    for n in sections:
        counts.append(min(n, left))
        left -= counts[-1]
    counts[-1] += left
    pos = positions3.to(torch.float32)
    pos = torch.cat([pos[..., i, None].expand(*pos.shape[:-1], n)
                     for i, n in enumerate(counts)], dim=-1)  # [..., S, d/2]
    return _rotate(x, pos, theta)


def positions_for(cfg: ModelConfig, tokens_shape, device=None):
    """Default positions: [B, S] int32, or [B, S, 3] (t == h == w) for
    M-RoPE."""
    B, S = tokens_shape
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :].expand(B, S)
    if cfg.rope_kind == "mrope":
        return pos[..., None].expand(B, S, 3)
    return pos


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------
def mlp_schema(d: int, ff: int) -> dict:
    """SwiGLU weights: ``w1``, ``w3`` [d, ff] and ``w2`` [ff, d]."""
    return {
        "w1": PSpec((d, ff), ("embed", "mlp"), init="scaled:0"),
        "w3": PSpec((d, ff), ("embed", "mlp"), init="scaled:0"),
        "w2": PSpec((ff, d), ("mlp", "embed"), init="scaled:0"),
    }


def mlp(p, x):
    """``(silu(x @ w1) * (x @ w3)) @ w2``."""
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def embed_schema(cfg: ModelConfig) -> dict:
    """The (tied) token embedding [V, d]."""
    return {"embedding": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}


def embed(p, tokens):
    """Rows of the embedding for ``tokens``."""
    return p["embedding"][tokens]


class _UnembedFn(torch.autograd.Function):
    """``torch.mm(x2, E^T, out_dtype=float32)`` with its gradient (autograd
    has none for ``out_dtype``): the float32 output gradient against the
    other operand widened to float32, rounded to the operand's dtype, as the
    transpose of JAX's einsum with ``preferred_element_type`` computes it
    (and as the CPU route's autograd does)."""

    @staticmethod
    def forward(ctx, x2, E):
        ctx.save_for_backward(x2, E)
        return torch.mm(x2, E.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, E = ctx.saved_tensors
        dx = dE = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, E.to(torch.float32)).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dE = torch.matmul(g.t(), x2.to(torch.float32)).to(E.dtype)
        return dx, dE


def unembed(p, x):
    """Tied embeddings: float32 logits ``x @ E^T``, as the JAX package's
    einsum with ``preferred_element_type=float32``. bf16 products are exact
    in float32, so every route sums the same float32 products: on a card,
    bf16 operands go to the tensor cores with a float32 result (``torch.mm``
    with ``out_dtype``, through ``_UnembedFn`` when autograd records it);
    elsewhere the operands are widened to float32."""
    E = p["embedding"]
    if x.is_cuda and x.dtype == E.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x2.requires_grad or E.requires_grad):
            return _UnembedFn.apply(x2, E).reshape(*x.shape[:-1], -1)
        return torch.mm(x2, E.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return torch.matmul(x.to(torch.float32), E.to(torch.float32).t())
