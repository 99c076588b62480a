"""Plain PyTorch attention: the CPU path and the CUDA kernel's yardstick.

The same function as the JAX package's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py:23``) behind its GQA
wrapper (``ops.flash_attention``): scores in float32, ``-1e30`` masking
with query row ``i`` seeing keys ``j <= i`` (top-left aligned), a float32
softmax, the output in ``q``'s dtype. Heads share their KV head in groups
(head ``h`` reads KV head ``h // (H // KV)``) without a broadcast copy.
With ``window > 0`` row ``i`` also sees only keys with ``i - j < window``,
the sliding-window mask of the JAX package's ``attention_ref`` and
``flash_attention_jax`` (``repro/models/attention.py:43-45, :134``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, H, D]; k [B, Skv, KV, D]; v [B, Skv, KV, Dv] -> [B, Sq, H, Dv]."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5
    qf = q.to(torch.float32).reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    if causal or window:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        visible = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            visible &= qpos >= kpos
        if window:
            visible &= (qpos - kpos) < window
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, Dv).to(q.dtype)
