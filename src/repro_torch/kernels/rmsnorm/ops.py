"""Public RMSNorm entry points over any leading dims, dispatched on the
device: a CPU tensor runs the plain version (``ref``), which autograd
differentiates, a CUDA tensor the kernel (``rmsnorm.rmsnorm_cuda``) or
raises. The counterparts of the JAX package's ``repro.kernels.rmsnorm.ops``.

On a card, when autograd records ``rmsnorm`` (grad mode on and ``x`` or
``w`` requiring a gradient), it goes through ``RMSNormFn``, whose backward
is the backward kernel (``rmsnorm.rmsnorm_bwd_cuda``); otherwise it is the
forward-only launch. ``rmsnorm_residual`` has no backward kernel (no path
trains through it) and refuses a gradient on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import wants_grad
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda


def _on_cuda(x) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RMSNorm kernel for device {x.device}")
    return x.device.type == "cuda"


class RMSNormFn(torch.autograd.Function):
    """The RMSNorm kernel with its backward kernel, on [N, d] CUDA rows."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        ctx.save_for_backward(x2, w)
        ctx.eps = eps
        return rmsnorm_cuda(x2, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(x2, w, dy.contiguous(), ctx.eps)
        return dx, dw, None


def rmsnorm(x, w, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` in float32, in ``x``'s dtype."""
    if not _on_cuda(x):
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    if wants_grad(x2, w):
        return RMSNormFn.apply(x2, w.contiguous(), eps).reshape(x.shape)
    return rmsnorm_cuda(x2, w, eps).reshape(x.shape)


def rmsnorm_residual(x, res, w, eps: float = 1e-5):
    """``s = x + res`` in float32 -> ``(rmsnorm(s), s)`` in ``x``'s dtype."""
    if not _on_cuda(x):
        return rmsnorm_residual_ref(x, res, w, eps)
    d = x.shape[-1]
    out, s = rmsnorm_cuda(x.reshape(-1, d).contiguous(), w, eps,
                          res2=res.reshape(-1, d).contiguous())
    return out.reshape(x.shape), s.reshape(x.shape)
