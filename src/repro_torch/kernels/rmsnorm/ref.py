"""Plain PyTorch RMSNorm: the CPU path and the CUDA kernel's yardstick.

The same functions as the JAX package's Pallas kernels
(``repro/kernels/rmsnorm/rmsnorm.py`` ``_kernel`` / ``_kernel_res``): the
reduction in float32, the result cast to ``x``'s dtype. The residual
variant normalises the unrounded float32 sum ``x + res``, as the Pallas
kernel does (the JAX ``ref.py`` rounds the sum to ``x``'s dtype first).
"""
from __future__ import annotations

import torch


def _normed(xf, w, eps):
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.to(torch.float32)


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis."""
    return _normed(x.to(torch.float32), w, eps).to(x.dtype)


def rmsnorm_residual_ref(x, res, w, eps: float = 1e-5):
    """``s = x + res`` in float32 -> ``(rmsnorm(s), s)``, both in ``x``'s
    dtype."""
    s = x.to(torch.float32) + res.to(torch.float32)
    return _normed(s, w, eps).to(x.dtype), s.to(x.dtype)
