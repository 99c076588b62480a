"""The bf16 tensor-core flash kernel's arithmetic, emulated in plain PyTorch
on the CPU, against the JAX package's Pallas kernel in interpret mode.

The CUDA kernel (``repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, ``flash_wgmma_kernel``) runs only on the card. Its
numerics differ from the plain version and from the Pallas kernel in one
place: P is rounded to bf16 before ``P V``. This file repeats the kernel's
arithmetic step by step (up to the order of float32 sums), so that the
difference is held to the unchanged bf16 tolerance before any chip time:
bf16 q, k and v; float32 scores; ``-1e30`` masking of the raw scores; an
online softmax over 64-key tiles with a float32 running max of the raw
scores, P = 2^(s c - m c) with c = D^-0.5 log2(e), a sum of the unrounded P
and a float32 accumulator; P rounded to bf16 for ``P V``; the output
``acc / max(l, 1e-30)`` rounded to bf16. The emulation lives here, not in
the package.

Tolerance: ``ATTN_TOL["bfloat16"]`` of ``test_torch_cuda_model_kernels.py``
and ``chip_smoke.py`` (atol = rtol = 3e-2), unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash

torch.set_num_threads(1)

ATTN_TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
LOG2E = 1.4426950408889634
TILE = 64  # keys per K/V tile, as the kernel's BN


def tensor_core_attention(q, k, v, causal=True):
    """bf16 q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv] ->
    bf16 [B, Sq, H, Dv], computed as the tensor-core kernel computes it.
    Tiles wholly above the diagonal, which the kernel skips, are masked
    here and change nothing: they leave the max, and so every alpha, as
    they were and add P = 0."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    heads = torch.arange(H) // (H // KV)
    qf = q.float().permute(0, 2, 1, 3)  # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)[:, heads]  # [B, H, Skv, D]
    vf = v.float().permute(0, 2, 1, 3)[:, heads]  # [B, H, Skv, Dv]
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, Dv)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, TILE):
        s = qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)
        keys = torch.arange(k0, min(k0 + TILE, Skv))[None, :]
        if causal:
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + TILE]
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (1, 128, 2, 2, 64, True),
    (1, 128, 2, 2, 112, True),  # Zamba2's head dim
    (1, 192, 2, 2, 128, True),  # Phi-4-mini's head dim, three key tiles
    (2, 128, 4, 2, 128, True),  # GQA
    (1, 128, 2, 2, 64, False),
])
def test_tensor_core_arithmetic_matches_pallas(B, S, H, KV, D, causal):
    rng = np.random.default_rng(S + H + D)
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in arrs)
    want = jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = tensor_core_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **ATTN_TOL_BF16)


def test_emulation_rounds_p():
    """The emulation is not the plain float32-P computation in disguise: on
    the same inputs its outputs differ from the float32-P result in some
    elements, while staying within the bf16 tolerance of it."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 128, 2, 64), np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = tensor_core_attention(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 64 ** -0.5
    s = torch.where(torch.ones(128, 128).tril().bool(), s, torch.tensor(-1e30))
    exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())
    assert not torch.equal(got, exact.to(torch.bfloat16))
    torch.testing.assert_close(got.float(), exact, **ATTN_TOL_BF16)
