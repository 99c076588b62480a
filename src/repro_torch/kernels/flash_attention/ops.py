"""Public flash-attention entry point in the JAX wrapper's ``[B, S, H, D]``
layout with GQA, dispatched on the device: a CPU tensor runs the plain
version (``ref``), which autograd differentiates, a CUDA tensor the kernel
(``flash_attention.flash_attention_cuda``) or raises. The counterpart of
the JAX package's ``repro.kernels.flash_attention.ops``, with the sliding
window of ``repro.models.attention.flash_attention_jax`` beside it.

On a card, when autograd records the call (grad mode on and an input
requiring a gradient), it goes through ``FlashAttentionFn``: the forward
kernel also writes the log-sum-exp, and the backward is the two backward
kernels, with the call's window. That needs the backward kernels' head dims
(D == Dv in ``HEAD_DIMS``, D = Dv = 256, or D = 192 with Dv = 128); other
head dims are refused as soon as a gradient is asked for. Otherwise the
call is the forward-only launch serving makes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import wants_grad
from repro_torch.kernels.flash_attention.flash_attention import (
    admits_grad,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its backward kernels, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(), lse,
                                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def grad_route(q, k, v) -> bool:
    """Whether a call on the card goes through ``FlashAttentionFn``: autograd
    records it (grad mode on, an input requiring a gradient). Raises
    ``NotImplementedError`` where it would and the backward kernels do not
    take the head dims."""
    if not wants_grad(q, k, v):
        return False
    if not admits_grad(q.shape[3], v.shape[3]):
        raise NotImplementedError(
            f"flash attention's backward kernels take D == Dv in (32, 64, 112, 128, 256) "
            f"or D = 192 with Dv = 128, got D={q.shape[3]}, Dv={v.shape[3]}: training it "
            "on the card is not ported (ROADMAP Queue 1 item 12 step 7b)")
    return True


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, H, D]; k, v [B, Skv, KV, D(v)] with H a multiple of KV ->
    [B, Sq, H, Dv] in ``q``'s dtype, scores scaled by ``D ** -0.5``; with
    ``window > 0`` row ``i`` sees only keys ``j`` with ``i - j < window``
    (aligned q and k only)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and q.shape[1] != k.shape[1]:
        raise ValueError("the sliding window needs aligned q/k (Sq == Skv)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if grad_route(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
