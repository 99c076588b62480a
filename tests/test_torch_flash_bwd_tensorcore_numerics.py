"""The bf16 tensor-core flash-attention backward's arithmetic and schedule,
emulated in plain PyTorch on the CPU, against the JAX package's autodiff of
``flash_attention_jax`` / ``attention_ref`` and against the float32
gradient.

The CUDA kernels (``repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cu``, ``flash_bwd_dq_wgmma_kernel`` and
``flash_bwd_dkdv_wgmma_kernel``) run only on the card. Their numerics differ
from the plain autograd in two places: P and dS are rounded to bf16 before
the products that take them (dV += P^T dO, dQ += dS K, dK += dS^T Q). This
file repeats the two kernels' arithmetic step by step (up to the order of
float32 sums), so that the difference is held to the unchanged bf16
tolerance before any chip time: bf16 q, k, v, o and dO; Delta = rowsum(dO
o) in float32; float32 S and dP over 64-row tiles; P = 2^(S c - lse
log2(e)) with c = D^-0.5 log2(e) (one rounding, as the kernels' FFMA) from
the forward's float32 log-sum-exp; P = 0 wherever the causal mask or the
sliding window hides a key, checked only on the tiles on the diagonal or
the window's edge; dS = P (dP - Delta) in
float32; P and dS rounded to bf16; float32 accumulators over the kernels'
tiles, scaled by D^-0.5 (dQ, dK) and rounded to bf16 once. It also repeats
the schedule: the dQ kernel's 64-row query tiles walk the key tiles up to
their diagonal; the dK / dV kernel's 64-key tiles walk the G query heads
of their group and, under ``causal``, the query tiles from the one holding
their first key on (with a window, up to the tile of the last query that
sees one of its keys), summing the group in one accumulator. The
two-warpgroup instances (D = Dv = 256, D = 192 with Dv = 128) round at the
same points over the same tiles: each warpgroup computes the whole score
tile and owns half of the output columns. The emulation lives here, not in
the package.

Tolerances: the bf16 gradient tolerance of ``test_torch_train_kernels.py``
(atol = rtol = 3e-2, unchanged), and ``chip_smoke.GRAD_BF16_REL`` (1e-2 of
each tensor's largest value) against the float32 gradient of the same bf16
inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_ref as jattention_ref
from repro.models.attention import flash_attention_jax

torch.set_num_threads(1)

GRAD_TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
GRAD_BF16_REL = 1e-2
LOG2E = 1.4426950408889634
TILE = 64  # rows of every tile: query tiles, key tiles


def fma_f32(a, b, c):
    """fmaf(a, b, c): the exact a * b + c (float64 holds a float32 product
    exactly), rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def bf16(t):
    return t.to(torch.bfloat16).float()


def probs(s, c, lse, hidden=None):
    """P = 2^fma(s, c, -lse log2(e)) (lse broadcast over s's last dims as
    given), 0 where ``hidden``; +inf lse gives 0."""
    p = torch.exp2(fma_f32(s, c, -lse * torch.tensor(LOG2E, dtype=torch.float32)))
    return p if hidden is None else torch.where(hidden, torch.tensor(0.0), p)


def tensor_core_backward(q, k, v, o, dout, lse, causal=True, window=0):
    """bf16 q [B, Sq, H, D], o, dout [B, Sq, H, Dv], k [B, Skv, KV, D], v
    [B, Skv, KV, Dv] and the float32 log-sum-exp [B, H, Sq] -> bf16 (dq, dk,
    dv), computed as the tensor-core kernels compute them, in their
    schedule (with ``window``, only the tiles that hold a visible pair; the
    two-warpgroup kernels at D = 256 or 192 / 128 round at the same points
    and walk the same tiles)."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    # [B, KV, G, S, D(v)]: query head h = g G + hh reads KV head g
    qf = q.float().permute(0, 2, 1, 3).reshape(B, KV, G, Sq, D)
    of, dof = (t.float().permute(0, 2, 1, 3).reshape(B, KV, G, Sq, Dv) for t in (o, dout))
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # [B, KV, Skv, D(v)]
    ls = lse.reshape(B, KV, G, Sq)
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (dof * of).sum(-1)  # [B, KV, G, Sq]

    # the dQ kernel: a CTA per query tile, walking the key tiles
    dq = torch.zeros(B, KV, G, Sq, D)
    for q0 in range(0, Sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, Sq))
        kend = min(Skv, q0 + TILE) if causal else Skv
        kbeg = max(0, q0 - window + 1) // TILE * TILE if window else 0
        for k0 in range(kbeg, kend, TILE):
            keys = torch.arange(k0, min(k0 + TILE, Skv))
            s = qf[:, :, :, rows] @ kf[:, :, None, keys].transpose(-1, -2)
            dp = dof[:, :, :, rows] @ vf[:, :, None, keys].transpose(-1, -2)
            hidden = None
            # a tile on the diagonal or on the window's edge
            if (causal and k0 + TILE - 1 > q0) or (window and q0 + TILE - 1 - k0 >= window):
                hidden = hide(rows[:, None], keys[None, :], causal, window)
            p = probs(s, c, ls[..., rows, None], hidden)
            ds = p * (dp - delta[..., rows, None])
            dq[:, :, :, rows] += bf16(ds) @ kf[:, :, None, keys]

    # the dK / dV kernel: a CTA per key tile, walking the group's heads and
    # their query tiles
    dk = torch.zeros(B, KV, Skv, D)
    dv = torch.zeros(B, KV, Skv, Dv)
    for k0 in range(0, Skv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, Skv))
        qt0 = k0 // TILE if causal else 0
        qend = min(Sq, k0 + TILE - 1 + window) if window else Sq
        for hh in range(G):
            for q0 in range(qt0 * TILE, qend, TILE):
                rows = torch.arange(q0, min(q0 + TILE, Sq))
                st = kf[:, :, keys] @ qf[:, :, hh, rows].transpose(-1, -2)
                dpt = vf[:, :, keys] @ dof[:, :, hh, rows].transpose(-1, -2)
                hidden = None
                if (causal and q0 < k0 + TILE - 1) or (window and q0 + TILE - 1 - k0 >= window):
                    hidden = hide(rows[None, :], keys[:, None], causal, window)
                pt = probs(st, c, ls[:, :, hh, None, rows], hidden)
                dst = pt * (dpt - delta[:, :, hh, None, rows])
                dv[:, :, keys] += bf16(pt) @ dof[:, :, hh, rows]
                dk[:, :, keys] += bf16(dst) @ qf[:, :, hh, rows]

    dq = (dq * scale).reshape(B, H, Sq, D).permute(0, 2, 1, 3)
    dk, dv = (t.permute(0, 2, 1, 3) for t in (dk * scale, dv))
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def hide(rows, keys, causal, window):
    """Where a query row does not see a key: above the diagonal with
    ``causal``, at or past ``window`` behind it with a window."""
    hidden = (keys > rows) if causal else torch.zeros_like(keys > rows)
    return hidden | (rows - keys >= window) if window else hidden


def forward_lse(q, k, causal, window=0):
    """The float32 log-sum-exp [B, H, Sq] of the scaled, masked scores: what
    the forward kernel hands the backward."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    s = s.masked_fill(hide(torch.arange(Sq)[:, None], torch.arange(Skv)[None, :], causal,
                           window), float("-inf"))
    return torch.logsumexp(s, -1).reshape(B, H, Sq)


def _inputs(seed, B, Sq, Skv, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in
            ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D))]


def _jax_grads(arrays, causal, dtype):
    """(out, dq, dk, dv) of the JAX package's attention by ``jax.vjp`` in
    ``dtype``: the blocked ``flash_attention_jax`` where the lengths tile by
    64, else ``attention_ref`` (to which it falls back)."""
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16).astype(dtype) for a in arrays)
    Sq, Skv = jq.shape[1], jk.shape[1]

    def fn(q, k, v):
        if Sq % TILE == 0 and Skv % TILE == 0:
            return flash_attention_jax(q, k, v, causal=causal, block_q=TILE, block_k=TILE)
        return jattention_ref(q, k, v, causal=causal)

    out, vjp = jax.vjp(fn, jq, jk, jv)
    return (out, *vjp(jdo))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal", [
    (1, 128, 128, 2, 2, 64, True),  # G = 1
    (1, 130, 130, 6, 2, 112, True),  # Zamba2's head dim, G = 3, a ragged tile
    (1, 192, 192, 3, 1, 128, True),  # Phi-4-mini's head dim, G = 3, three tiles
    (2, 100, 160, 6, 2, 64, False),  # not causal, Sq != Skv, both ragged
])
def test_tensor_core_backward_matches_jax(B, Sq, Skv, H, KV, D, causal):
    arrays = _inputs(Sq + Skv + H + D, B, Sq, Skv, H, KV, D)
    jout, *jgrads = _jax_grads(arrays, causal, jnp.bfloat16)
    _, *want32 = _jax_grads(arrays, causal, jnp.float32)
    q, k, v, dout = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    o = torch.as_tensor(np.array(jout.astype(jnp.float32))).to(torch.bfloat16)
    got = tensor_core_backward(q, k, v, o, dout, forward_lse(q, k, causal), causal)
    for name, g, jg, w32 in zip(("dq", "dk", "dv"), got, jgrads, want32):
        assert g.dtype == torch.bfloat16 and g.shape == (q if name == "dq" else k).shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                                   err_msg=name, **GRAD_TOL_BF16)
        w32 = np.asarray(w32)
        rel = np.abs(g.float().numpy() - w32).max() / np.abs(w32).max()
        assert rel <= GRAD_BF16_REL, (name, rel)


@pytest.mark.parametrize("B,Sq,H,KV,D,Dv,causal,window", [
    (1, 200, 4, 2, 64, 64, True, 70),  # a window: the tiles before its edge skipped
    (1, 192, 2, 1, 32, 32, True, 64),  # a window of one tile, JAX's blocked attention
    (1, 130, 4, 2, 256, 256, True, 48),  # Gemma 3's head dim, windowed
    (1, 130, 2, 2, 256, 256, True, 0),  # and global
    (1, 140, 8, 2, 192, 128, True, 0),  # MLA's head dims, G = 4
    (1, 150, 2, 1, 64, 64, False, 40),  # a window, not causal
])
def test_windowed_and_wide_backward_matches_jax(B, Sq, H, KV, D, Dv, causal, window):
    """The new instances' arithmetic and schedule: a window (its first and
    last tiles), D = Dv = 256 and D = 192 with Dv = 128, against ``jax.vjp``
    of the JAX attention with the window, in bf16 and against float32."""
    rng = np.random.default_rng(Sq + D + window)
    arrays = [rng.standard_normal(s, np.float32) for s in
              ((B, Sq, H, D), (B, Sq, KV, D), (B, Sq, KV, Dv), (B, Sq, H, Dv))]

    def jax_grads(dtype):
        jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16).astype(dtype) for a in arrays)

        def fn(q, k, v):
            if Sq % TILE == 0:
                return flash_attention_jax(q, k, v, causal=causal, window=window, block_q=TILE,
                                           block_k=TILE)
            return jattention_ref(q, k, v, causal=causal, window=window)

        out, vjp = jax.vjp(fn, jq, jk, jv)
        return (out, *vjp(jdo))

    jout, *jgrads = jax_grads(jnp.bfloat16)
    _, *want32 = jax_grads(jnp.float32)
    q, k, v, dout = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    o = torch.as_tensor(np.array(jout.astype(jnp.float32))).to(torch.bfloat16)
    got = tensor_core_backward(q, k, v, o, dout, forward_lse(q, k, causal, window), causal,
                               window)
    for name, g, jg, w32, like in zip(("dq", "dk", "dv"), got, jgrads, want32, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                                   err_msg=name, **GRAD_TOL_BF16)
        w32 = np.asarray(w32)
        rel = np.abs(g.float().numpy() - w32).max() / np.abs(w32).max()
        assert rel <= GRAD_BF16_REL, (name, rel)


def test_emulation_rounds_p_and_ds():
    """The emulation is not the float32 backward in disguise: without the
    bf16 rounding of P and dS its gradients differ in some elements, while
    both stay within the bf16 tolerance of each other."""
    arrays = _inputs(7, 1, 128, 128, 2, 2, 64)
    q, k, v, dout = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) * 64 ** -0.5
    s = s.masked_fill(torch.ones(128, 128).triu(1).bool(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), leaves[2])
    o.backward(dout.float())
    got = tensor_core_backward(q, k, v, o.detach().to(torch.bfloat16), dout,
                               forward_lse(q, k, True))
    exact = [t.grad.to(torch.bfloat16) for t in leaves]
    assert any(not torch.equal(a, b) for a, b in zip(got, exact))
    for a, b in zip(got, exact):
        torch.testing.assert_close(a.float(), b.float(), **GRAD_TOL_BF16)


def test_rows_that_see_no_key_get_zero_gradients():
    """A row whose log-sum-exp is +inf (it saw no key) gets P = 2^-inf = 0
    in both kernels, so its dq is 0 and it adds nothing to dk and dv."""
    arrays = _inputs(11, 1, 64, 64, 2, 2, 32)
    q, k, v, dout = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    lse = forward_lse(q, k, True)
    o = torch.zeros_like(q)
    dq, dk, dv = tensor_core_backward(q, k, v, o, dout, torch.full_like(lse, float("inf")))
    assert not dq.float().abs().max() and not dk.float().abs().max()
    assert not dv.float().abs().max()
