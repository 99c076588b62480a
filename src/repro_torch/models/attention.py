"""Attention for the port's GQA models: prefill through the flash kernel,
decode against a KV cache in plain PyTorch.

Layouts as in ``repro.models.attention``: q [B, S, H, D]; k, v [B, S, KV, D];
GQA group G = H // KV, head ``h`` reading KV head ``h // G``.

The JAX package sends short prompts (``S <= 256``) and sequences that its
TPU tiles do not divide to its plain reference; that is a TPU tiling
choice, not another function. Here prefill attention always goes to
``kernels.flash_attention``: the CUDA kernel on a card (any S, the ragged
edge masked), its plain version on the CPU. Decode attention is outside
any kernel in the JAX package too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def attention(q, k, v, *, causal=True, window=0):
    """Prefill attention through the flash kernel."""
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP Queue 1 item 12)")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention assumes aligned q/k")
    return flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len):
    """q [B, 1, H, D]; caches [B, S, KV, D]; cache_len [B] (valid prefix,
    the current token already written at ``cache_len - 1``). Float32 scores
    and softmax, the output in ``q``'s dtype; the KV heads are read in
    groups, not broadcast."""
    B, _, H, D = q.shape
    S, KV, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf = q[:, 0].to(torch.float32).reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]  # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, Dv).to(q.dtype)
