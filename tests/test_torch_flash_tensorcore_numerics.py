"""The bf16 tensor-core flash kernel's arithmetic and schedule, emulated in
plain PyTorch on the CPU, against the JAX package's Pallas kernel in
interpret mode and, with a sliding window, its ``flash_attention_jax``.

The CUDA kernel (``repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, ``flash_wgmma_kernel``) runs only on the card. Its
numerics differ from the plain version and from the Pallas kernel in one
place: P is rounded to bf16 before ``P V``. This file repeats the kernel's
arithmetic step by step (up to the order of float32 sums), so that the
difference is held to the unchanged bf16 tolerance before any chip time:
bf16 q, k and v; float32 scores; ``-1e30`` masking of the raw scores; an
online softmax over 64-key tiles with a float32 running max of the raw
scores, P = 2^(s c - m c) with c = D^-0.5 log2(e) (one rounding, as the
kernel's FFMA), a sum of the unrounded P and a float32 accumulator; P
rounded to bf16 for ``P V``; the output ``acc / max(l, 1e-30)`` rounded to
bf16. It also repeats the kernel's schedule: 128-row CTAs of two 64-row
halves, the key tiles from the first one its first row's window reaches
to the last one below its diagonal, the first half's products skipped on
a tile past its last row when one warpgroup holds both halves (D <= 128),
every other half computing every tile of the range (at a window's left
edge and, at D = 256, past the diagonal a tile that none of its rows
sees), only the tiles on the diagonal, at a window's edge or past Skv
masked, and P taken as 2^(s c - 0) while a row's max is still -1e30 (a
row that has seen no key adds 0). The emulation lives here, not in the
package.

Tolerance: ``ATTN_TOL["bfloat16"]`` of ``test_torch_cuda_model_kernels.py``
and ``chip_smoke.py`` (atol = rtol = 3e-2), unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models.attention import flash_attention_jax

torch.set_num_threads(1)

ATTN_TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
LOG2E = 1.4426950408889634
TILE = 64  # keys per K/V tile, as the kernel's BN; also the rows of a half (BM)
NEG = -1e30


def schedule(Sq, Skv, causal=True, window=0, D=64):
    """The kernel's visits: for each 128-row CTA (first row q0) and each
    64-row half (first row lo), the tiles t of the CTA's range with whether
    the half runs the tile's products (``live``), masks its scores
    (``masked``) and has a row that sees a key of it (``sees``). Yields
    (lo, t, live, masked, sees)."""
    for q0 in range(0, Sq, 2 * TILE):
        kend = min(Skv, q0 + 2 * TILE) if causal else Skv
        t0 = max(0, q0 - window + 1) // TILE if window else 0
        for lo in (q0, q0 + TILE):
            for t in range(t0, -(-kend // TILE)):
                k0 = t * TILE
                below = not causal or k0 <= lo + TILE - 1
                live = below or lo > q0 or D > 128
                masked = ((causal and k0 + TILE - 1 > lo)
                          or (window and lo + TILE - 1 - k0 >= window) or k0 + TILE > Skv)
                sees = below and (not window or lo - (k0 + TILE - 1) < window)
                yield lo, t, live, masked, sees


def fma_f32(a, b, c):
    """fmaf(a, b, c): the exact a * b + c (float64 holds a float32 product
    exactly), rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def tensor_core_attention(q, k, v, causal=True, window=0, max_rule=True):
    """bf16 q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv] ->
    bf16 [B, Sq, H, Dv], computed as the tensor-core kernel computes it, in
    its schedule. ``max_rule=False`` drops the rule for a row whose max is
    still -1e30 (P = 2^(s c - m c) there too), to show what it guards."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    heads = torch.arange(H) // (H // KV)
    qf = q.float().permute(0, 2, 1, 3)  # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)[:, heads]  # [B, H, Skv, D]
    vf = v.float().permute(0, 2, 1, 3)[:, heads]  # [B, H, Skv, Dv]
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros(B, H, Sq, Dv)
    state = {}  # per half: (m, l, acc)
    for lo, t, live, masked, _ in schedule(Sq, Skv, causal, window, D):
        if lo >= Sq or not live:
            continue
        rows = torch.arange(lo, min(lo + TILE, Sq))
        keys = torch.arange(t * TILE, min(t * TILE + TILE, Skv))
        m, l, acc = state.get(lo, (torch.full((B, H, len(rows)), NEG),
                                   torch.zeros(B, H, len(rows)),
                                   torch.zeros(B, H, len(rows), Dv)))
        s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
        if masked:
            hidden = torch.zeros(len(rows), len(keys), dtype=torch.bool)
            if causal:
                hidden |= keys[None, :] > rows[:, None]
            if window:
                hidden |= rows[:, None] - keys[None, :] >= window
            s = torch.where(hidden, torch.tensor(NEG), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        nb = -m_new * c
        if max_rule:
            nb = torch.where(m_new == NEG, torch.tensor(0.0), nb)
        p = torch.exp2(fma_f32(s, c, nb[..., None]))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, keys]
        state[lo] = (m_new, l, acc)
    for lo, (m, l, acc) in state.items():
        out[:, :, lo:lo + acc.shape[2]] = acc / l.clamp_min(1e-30)[..., None]
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


def _bf16_inputs(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.as_tensor(a).to(torch.bfloat16) for a in arrs])


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 256, 2, 2, 32, 64),
    (2, 320, 4, 2, 32, 96),  # window not a multiple of 64, two CTAs past it
    (1, 256, 2, 2, 256, 64),  # Gemma 3's head dim
    (1, 384, 4, 2, 256, 96),
])
def test_window_schedule_matches_flash_attention_jax(B, S, H, KV, D, window):
    """The window mode's tile range, per-half skips, edge masking and the
    -1e30 rule, against the JAX package's blocked ``flash_attention_jax``
    with the same window. Each shape has CTAs whose second half computes,
    and sees nothing of, the CTA's first tile, and edge tiles in which
    some rows of a half see no key."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(S + D + window, B, S, H, KV, D)
    visits = list(schedule(S, S, True, window, D))
    first = {}  # each CTA's first tile
    for lo, t, *_ in visits:
        first.setdefault(lo - lo % (2 * TILE), t)
    assert any(live and not sees and t == first[lo - TILE]
               for lo, t, live, _, sees in visits if lo % (2 * TILE))
    want = flash_attention_jax(jq, jk, jv, causal=True, window=window, block_q=64,
                               block_k=64)
    got = tensor_core_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **ATTN_TOL_BF16)


def test_window_needs_the_max_rule():
    """Without the rule, a row that sees no key of an edge tile takes P =
    2^fma(-1e30, c, 1e30 c): the rounding error of the product, 0 or inf
    by its sign. At Gemma 3's D = 256 it is +4.0e20, so P = inf, which
    turns into NaN when a later tile's alpha = 0 scales it. With the rule
    the same inputs are finite and within tolerance of
    ``flash_attention_jax``."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(9, 1, 256, 2, 2, 256)
    bad = tensor_core_attention(tq, tk, tv, window=64, max_rule=False)
    assert not torch.isfinite(bad.float()).all()
    good = tensor_core_attention(tq, tk, tv, window=64)
    want = flash_attention_jax(jq, jk, jv, causal=True, window=64, block_q=64, block_k=64)
    np.testing.assert_allclose(good.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **ATTN_TOL_BF16)
