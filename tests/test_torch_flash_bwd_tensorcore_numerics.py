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
the forward's float32 log-sum-exp; P = 0 wherever the causal mask hides a
key, checked only on the tiles on the diagonal; dS = P (dP - Delta) in
float32; P and dS rounded to bf16; float32 accumulators over the kernels'
tiles, scaled by D^-0.5 (dQ, dK) and rounded to bf16 once. It also repeats
the schedule: the dQ kernel's 64-row query tiles walk the key tiles up to
their diagonal; the dK / dV kernel's 64-key tiles walk the G query heads
of their group and, under ``causal``, the query tiles from the one holding
their first key on, summing the group in one accumulator. The emulation
lives here, not in the package.

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


def tensor_core_backward(q, k, v, o, dout, lse, causal=True):
    """bf16 q, o, dout [B, Sq, H, D], k, v [B, Skv, KV, D] and the float32
    log-sum-exp [B, H, Sq] -> bf16 (dq, dk, dv), computed as the two
    tensor-core kernels compute them, in their schedule."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    # [B, KV, G, S, D]: query head h = g G + hh reads KV head g
    qf, of, dof = (t.float().permute(0, 2, 1, 3).reshape(B, KV, G, Sq, D) for t in (q, o, dout))
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # [B, KV, Skv, D]
    ls = lse.reshape(B, KV, G, Sq)
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (dof * of).sum(-1)  # [B, KV, G, Sq]

    # the dQ kernel: a CTA per query tile, walking the key tiles
    dq = torch.zeros(B, KV, G, Sq, D)
    for q0 in range(0, Sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, Sq))
        kend = min(Skv, q0 + TILE) if causal else Skv
        for k0 in range(0, kend, TILE):
            keys = torch.arange(k0, min(k0 + TILE, Skv))
            s = qf[:, :, :, rows] @ kf[:, :, None, keys].transpose(-1, -2)
            dp = dof[:, :, :, rows] @ vf[:, :, None, keys].transpose(-1, -2)
            hidden = None
            if causal and k0 + TILE - 1 > q0:  # a tile on the diagonal
                hidden = keys[None, :] > rows[:, None]
            p = probs(s, c, ls[..., rows, None], hidden)
            ds = p * (dp - delta[..., rows, None])
            dq[:, :, :, rows] += bf16(ds) @ kf[:, :, None, keys]

    # the dK / dV kernel: a CTA per key tile, walking the group's heads and
    # their query tiles
    dk = torch.zeros(B, KV, Skv, D)
    dv = torch.zeros(B, KV, Skv, D)
    for k0 in range(0, Skv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, Skv))
        qt0 = k0 // TILE if causal else 0
        for hh in range(G):
            for q0 in range(qt0 * TILE, Sq, TILE):
                rows = torch.arange(q0, min(q0 + TILE, Sq))
                st = kf[:, :, keys] @ qf[:, :, hh, rows].transpose(-1, -2)
                dpt = vf[:, :, keys] @ dof[:, :, hh, rows].transpose(-1, -2)
                hidden = None
                if causal and q0 < k0 + TILE - 1:  # a tile on the diagonal
                    hidden = keys[:, None] > rows[None, :]
                pt = probs(st, c, ls[:, :, hh, None, rows], hidden)
                dst = pt * (dpt - delta[:, :, hh, None, rows])
                dv[:, :, keys] += bf16(pt) @ dof[:, :, hh, rows]
                dk[:, :, keys] += bf16(dst) @ qf[:, :, hh, rows]

    dq = (dq * scale).reshape(B, H, Sq, D).permute(0, 2, 1, 3)
    dk, dv = (t.permute(0, 2, 1, 3) for t in (dk * scale, dv))
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def forward_lse(q, k, causal):
    """The float32 log-sum-exp [B, H, Sq] of the scaled, masked scores: what
    the forward kernel hands the backward."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.arange(Skv)[None, :] > torch.arange(Sq)[:, None], float("-inf"))
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
