"""Public flash-attention entry point in the JAX wrapper's ``[B, S, H, D]``
layout with GQA, dispatched on the device: a CPU tensor runs the plain
version (``ref``), a CUDA tensor the kernel
(``flash_attention.flash_attention_cuda``) or raises. The counterpart of
the JAX package's ``repro.kernels.flash_attention.ops``, with the sliding
window of ``repro.models.attention.flash_attention_jax`` beside it."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window)
