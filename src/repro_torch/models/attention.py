"""Attention for the port's GQA and MLA models: prefill through the flash
kernel, decode against a KV cache in plain PyTorch.

Layouts as in ``repro.models.attention``: q [B, S, H, D]; k, v [B, S, KV, D];
GQA group G = H // KV, head ``h`` reading KV head ``h // G``.

The JAX package sends short prompts (``S <= 256``) and sequences that its
TPU tiles do not divide to its plain reference; that is a TPU tiling
choice, not another function. Here prefill attention always goes to
``kernels.flash_attention``: the CUDA kernel on a card (any S, the ragged
edge masked), its plain version on the CPU, with the sliding window of a
local layer. Decode attention is outside any kernel in the JAX package
too; a local layer's decode reads its window-sized ring cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def attention(q, k, v, *, causal=True, window=0):
    """Prefill attention through the flash kernel; ``window > 0`` masks keys
    with ``qpos - kpos >= window``."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention assumes aligned q/k")
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     scale=None, ring: bool = False):
    """q [B, 1, H, D]; caches [B, S, KV, D(v)]; cache_len [B] (valid prefix,
    the current token already written at ``cache_len - 1``). Float32 scores
    scaled by ``scale`` (``D ** -0.5`` if None) and softmax, the output in
    ``q``'s dtype; the KV heads are read in groups, not broadcast (MLA's
    absorbed decode: one KV head for every query head). ``ring``: the
    cache is a ring of S slots, every
    slot below ``cache_len`` valid (the softmax does not care about their
    order); otherwise ``window > 0`` also drops the slots before
    ``cache_len - window``."""
    B, _, H, D = q.shape
    S, KV, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q[:, 0].to(torch.float32).reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32)) * scale
    kpos = torch.arange(S, device=q.device)[None, :]
    valid = kpos < cache_len[:, None]  # [B, S]
    if window and not ring:
        valid &= kpos >= cache_len[:, None] - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, Dv).to(q.dtype)
