"""The dense and MoE blocks (GQA or MLA attention), the SSM (Mamba-2)
block, the encoder-decoder's decoder block (self- and cross-attention)
and the layer-stack loop.

The counterparts of ``repro.models.transformer`` for every family: every
block has the signature
``block(p, x, cache_layer, ctx) -> (x', new_cache_layer, aux)``, and
``ctx`` carries the mode ("train" | "prefill" | "decode"), positions
(M-RoPE's [B, S, 3] among them), the encoder's output, whether
attention is causal and whether training recomputes each layer (``remat``).
There is no mesh, so the JAX package's sharding constraints (``_cb``,
``_gw``) have no counterpart. ``scan_stack`` is a Python loop over the
layers' modules; it sums a MoE block's aux (load-balance loss, router
z-loss, dropped share) over the layers, as the JAX package's scan does.

Decode updates the stacked cache in place (the JAX package returns an
updated copy): the new token's K/V is written into its slot (a local
layer's into slot ``pos % W`` of its window-sized ring; an MLA layer's
compressed ``ckv`` / ``krope`` row into slot ``pos``; the cross-attention
caches ``ck`` / ``cv`` are written once, by the prefill), and an SSM layer
overwrites its state and conv prefixes (``models.ssm``). The cache
is the largest live tensor after the weights, and no caller keeps the old
one. A layer's cache is a (nested) dict of tensors; the stacked cache has
the same tree with a leading layer axis on every leaf. An int8 KV cache
(``k`` / ``v`` int8 with float32 ``k_scale`` / ``v_scale`` per token and KV
head, JAX's ``cache_quant``) quantises the decoded token's K/V on its way
in and attends over the dequantised cache (JAX's ``gqa_attn``,
``repro/models/transformer.py:134-162``).

With ``ctx.remat`` a training forward runs each layer under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
layer's activations instead of keeping them. The JAX package rematerialises
each scanned layer too, but keeps the products without batch dimensions
(``dots_with_no_batch_dims_saveable``); the port recomputes the whole
layer. The numbers are the same; the memory kept and the work recomputed
differ (on the card the layer's kernels launch twice a step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    mlp,
    mlp_schema,
    rmsnorm,
    rmsnorm_schema,
)
from repro_torch.models.spec import PSpec, Stacked


@dataclass
class Ctx:
    """What a block needs beside its weights and input."""

    cfg: ModelConfig
    mode: str  # "train" | "prefill" | "decode"
    pos: Any = None  # [B, S] (or [B, S, 3] M-RoPE); decode: [B] write position
    rope_pos: Any = None  # decode only: rotary position if != write slot (M-RoPE)
    enc_out: Any = None  # encoder output [B, S_enc, d] for cross-attention
    enc_len: Any = None  # [B] valid encoder length (decode's cross-attention)
    causal: bool = True
    remat: bool = False  # train: recompute each layer in the backward pass


def make_rope_fn(cfg: ModelConfig) -> Callable:
    """``rope(x, pos)`` for the config's rotary kind."""
    if cfg.rope_kind == "none":
        return lambda x, pos: x
    if cfg.rope_kind == "mrope":
        return lambda x, pos: apply_mrope(x, pos, cfg.mrope_sections, cfg.rope_theta)
    return lambda x, pos: apply_rope(x, pos, cfg.rope_theta)


# ----------------------------------------------------------------------
# GQA attention sub-layer
# ----------------------------------------------------------------------
def gqa_schema(cfg: ModelConfig) -> dict:
    """Projections in the JAX layouts: ``wq`` [d, H, D], ``wk``/``wv``
    [d, KV, D], ``wo`` [H, D, d]."""
    H, KV, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    return {
        "wq": PSpec((d, H, D), ("embed", "heads", "head_dim"), init="scaled:0"),
        "wk": PSpec((d, KV, D), ("embed", "kv_heads", "head_dim"), init="scaled:0"),
        "wv": PSpec((d, KV, D), ("embed", "kv_heads", "head_dim"), init="scaled:0"),
        "wo": PSpec((H, D, d), ("heads", "head_dim", "embed"), init="scaled:0"),
    }


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, H, K = w.shape
    return (x @ w.reshape(d, H * K)).reshape(*x.shape[:-1], H, K)


def _out(o, w):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    H, K, d = w.shape
    return o.reshape(*o.shape[:-2], H * K) @ w.reshape(H * K, d)


def _ring(x, W: int):
    """The window-sized ring of a prefill's keys or values [B, S, KV, D]:
    the last ``W`` positions at slots ``pos % W``, zeros where S < W (the
    JAX package's ``gqa_attn``, ``repro/models/transformer.py:110-118``)."""
    S = x.shape[1]
    ring = x.new_zeros((x.shape[0], W) + tuple(x.shape[2:]))
    ring[:, torch.arange(max(S - W, 0), S, device=x.device) % W] = x[:, -W:]
    return ring


def gqa_attn(p, x, cache, ctx: Ctx, *, window: int = 0, ring: bool = False):
    """Returns (out, new_cache). Prefill builds ``{"k", "v"}`` (with
    ``ring`` and a window, the window-sized ring of the last W positions),
    causal unless ``ctx.causal`` is false (the encoder); decode rotates by
    ``ctx.rope_pos`` where set (M-RoPE: [B] broadcast to [B, 1, 3]), else by
    the write position, writes slot ``min(pos, S - 1)`` of the layer's
    cache in place and attends over ``pos + 1`` entries (the last
    ``window`` of them with a window), or with ``ring`` writes slot
    ``pos % S`` and attends over ``min(pos + 1, S)`` slots."""
    rope_fn = make_rope_fn(ctx.cfg)
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])

    if ctx.mode in ("train", "prefill"):
        q = rope_fn(q, ctx.pos)
        k = rope_fn(k, ctx.pos)
        o = attention(q, k, v, causal=ctx.causal, window=window)
        out = _out(o, p["wo"])
        if ctx.mode == "train":
            return out, None
        if ring and window:
            return out, {"k": _ring(k, window), "v": _ring(v, window)}
        return out, {"k": k, "v": v}

    posB = ctx.pos  # [B] absolute position of the new token (cache slot)
    rpos = (posB if ctx.rope_pos is None else ctx.rope_pos)[:, None]  # [B, 1]
    if ctx.cfg.rope_kind == "mrope":
        rpos = rpos[..., None].expand(-1, 1, 3)
    q = rope_fn(q, rpos)
    k = rope_fn(k, rpos)
    S = cache["k"].shape[1]
    idx = (posB % S if ring else torch.clamp(posB, max=S - 1)).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    if "k_scale" in cache:  # int8 KV cache, per-token-per-head scales
        for name, t in (("k", k), ("v", v)):
            t_q, t_s = _quant_i8(t[:, 0])
            cache[name][bidx, idx] = t_q
            cache[name + "_scale"][bidx, idx] = t_s
        k_eff, v_eff = (cache[n].to(torch.bfloat16)
                        * cache[n + "_scale"][..., None].to(torch.bfloat16) for n in ("k", "v"))
    else:
        cache["k"][bidx, idx] = k[:, 0]
        cache["v"][bidx, idx] = v[:, 0]
        k_eff, v_eff = cache["k"], cache["v"]
    cache_len = torch.clamp(posB + 1, max=S) if ring else posB + 1
    o = decode_attention(q, k_eff, v_eff, cache_len, window=0 if ring else window, ring=ring)
    return _out(o, p["wo"]), cache


def _quant_i8(x):
    """[B, KV, D] -> (int8 values, [B, KV] float32 scales): the scale is
    ``max(max |x|, 1e-8) / 127`` over D in float32, the values
    ``clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cross_attn(p, x, cache, ctx: Ctx):
    """Cross-attention to the encoder's output (``gqa_schema`` weights).
    Train and prefill project ``ctx.enc_out`` to keys and values and attend
    over all of them, not causally (Sq = S_dec, Skv = S_enc); prefill
    returns them as the layer's ``{"ck", "cv"}``, built once. Decode
    attends over the cached ``ck`` / ``cv`` up to ``ctx.enc_len`` and
    leaves them as they are."""
    q = _proj(x, p["wq"])
    if ctx.mode in ("train", "prefill"):
        k, v = _proj(ctx.enc_out, p["wk"]), _proj(ctx.enc_out, p["wv"])
        out = _out(attention(q, k, v, causal=False), p["wo"])
        return out, (None if ctx.mode == "train" else {"ck": k, "cv": v})
    o = decode_attention(q, cache["ck"], cache["cv"], ctx.enc_len)
    return _out(o, p["wo"]), cache


# ----------------------------------------------------------------------
# MLA attention sub-layer (DeepSeek-V2)
# ----------------------------------------------------------------------
def mla_schema(cfg: ModelConfig) -> dict:
    """Low-rank projections in the JAX layouts: ``wq_a`` [d, ql], the bare
    float32 ``q_norm`` scale [ql], ``wq_b`` [ql, H, dn + dr], ``wkv_a`` [d,
    kl + dr], ``kv_norm`` [kl], ``wk_b`` [kl, H, dn], ``wv_b`` [kl, H, dv],
    ``wo`` [H, dv, d]."""
    d, H = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": PSpec((d, ql), ("embed", "q_lora"), init="scaled:0"),
        "q_norm": rmsnorm_schema(ql)["scale"],
        "wq_b": PSpec((ql, H, dn + dr), ("q_lora", "heads", None), init="scaled:0"),
        "wkv_a": PSpec((d, kl + dr), ("embed", None), init="scaled:0"),
        "kv_norm": rmsnorm_schema(kl)["scale"],
        "wk_b": PSpec((kl, H, dn), ("kv_lora", "heads", None), init="scaled:0"),
        "wv_b": PSpec((kl, H, dv), ("kv_lora", "heads", None), init="scaled:0"),
        "wo": PSpec((H, dv, d), ("heads", None, "embed"), init="scaled:1"),
    }


def _mla_qkv(p, x, cfg: ModelConfig):
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr], the normed latent ckv
    [B, S, kl], k_rope [B, S, 1, dr]), before the rotary embedding."""
    kl, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    cq = rmsnorm({"scale": p["q_norm"]}, x @ p["wq_a"], cfg.norm_eps)
    q = _proj(cq, p["wq_b"])
    kv_a = x @ p["wkv_a"]  # [B, S, kl + dr]
    ckv = rmsnorm({"scale": p["kv_norm"]}, kv_a[..., :kl], cfg.norm_eps)
    return q[..., :dn], q[..., dn:], ckv, kv_a[..., None, kl:]


def mla_attn(p, x, cache, ctx: Ctx):
    """Returns (out, new_cache). Prefill builds each head's key from the
    latent (``wk_b``) and the rotary key shared by the heads, and runs the
    flash kernel at D = dn + dr, Dv = dv; its cache is the compressed
    ``{"ckv": [B, S, kl], "krope": [B, S, dr]}``. Decode writes the token's
    row at slot ``min(pos, S - 1)`` in place, absorbs ``wk_b`` into the
    query and attends over ``[ckv | krope]`` as one KV head of kl + dr
    (values ``ckv``), scaled by ``(dn + dr) ** -0.5``, then applies
    ``wv_b`` and ``wo``."""
    cfg = ctx.cfg
    dr = cfg.qk_rope_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg)

    if ctx.mode in ("train", "prefill"):
        q_rope = apply_rope(q_rope, ctx.pos, cfg.rope_theta)
        k_rope = apply_rope(k_rope, ctx.pos, cfg.rope_theta)
        k_nope = _proj(ckv, p["wk_b"])
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], dr)], -1)
        o = attention(q, k, _proj(ckv, p["wv_b"]))
        out = _out(o, p["wo"])
        if ctx.mode == "train":
            return out, None
        return out, {"ckv": ckv, "krope": k_rope[:, :, 0]}

    posB = ctx.pos
    q_rope = apply_rope(q_rope, posB[:, None], cfg.rope_theta)
    k_rope = apply_rope(k_rope, posB[:, None], cfg.rope_theta)
    S = cache["ckv"].shape[1]
    idx = torch.clamp(posB, max=S - 1).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["ckv"][bidx, idx] = ckv[:, 0]
    cache["krope"][bidx, idx] = k_rope[:, 0, 0]
    # scores = (q_nope wk_b^T) . ckv + q_rope . k_rope
    q_abs = torch.einsum("bshn,khn->bshk", q_nope, p["wk_b"])  # [B, 1, H, kl]
    q_eff = torch.cat([q_abs, q_rope], -1)
    k_eff = torch.cat([cache["ckv"], cache["krope"]], -1)[:, :, None]  # [B, S, 1, kl + dr]
    o = decode_attention(q_eff, k_eff, cache["ckv"][:, :, None], posB + 1,
                         scale=1.0 / math.sqrt(cfg.qk_nope_head_dim + dr))  # [B, 1, H, kl]
    o = torch.einsum("bshk,khv->bshv", o, p["wv_b"])
    return _out(o, p["wo"]), cache


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------
ATTN_SCHEMAS = {"gqa": gqa_schema, "mla": mla_schema}


def dense_block_schema(cfg: ModelConfig, *, attn: str = "gqa", ff: int | None = None) -> dict:
    """A pre-norm block: ``ln1``, ``attn`` (GQA or MLA), ``ln2``, ``mlp``."""
    if attn not in ATTN_SCHEMAS:
        raise NotImplementedError(
            f"{attn!r} attention is not ported yet (ROADMAP Queue 1 item 12)")
    d = cfg.d_model
    return {
        "ln1": rmsnorm_schema(d),
        "attn": ATTN_SCHEMAS[attn](cfg),
        "ln2": rmsnorm_schema(d),
        "mlp": mlp_schema(d, ff or cfg.d_ff),
    }


def _attn(p, h, cache, ctx: Ctx, attn_kind: str, window: int = 0, ring: bool = False):
    """The attention sub-layer of ``attn_kind``: (out, new_cache)."""
    if attn_kind == "mla":
        return mla_attn(p, h, cache, ctx)
    return gqa_attn(p, h, cache, ctx, window=window, ring=ring)


def dense_block(p, x, cache, ctx: Ctx, *, window: int = 0, ring: bool = False,
                attn_kind: str = "gqa"):
    """``x + attn(ln1(x))``, then ``+ mlp(ln2(.))``; the residual sums are
    rounded to x's dtype before each norm, as in the JAX package. A local
    layer passes its ``window`` and ``ring`` to ``gqa_attn``; ``attn_kind``
    "mla" takes ``mla_attn``."""
    h = rmsnorm(p["ln1"], x, ctx.cfg.norm_eps)
    a, new_cache = _attn(p["attn"], h, cache, ctx, attn_kind, window, ring)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, ctx.cfg.norm_eps))
    return x, new_cache, None


def moe_layer_schema(cfg: ModelConfig) -> dict:
    """A pre-norm MoE block: ``ln1``, ``attn`` (``cfg.attn_kind``), ``ln2``,
    ``moe``."""
    d = cfg.d_model
    return {
        "ln1": rmsnorm_schema(d),
        "attn": ATTN_SCHEMAS[cfg.attn_kind](cfg),
        "ln2": rmsnorm_schema(d),
        "moe": moe_mod.moe_schema(cfg),
    }


def moe_layer_block(p, x, cache, ctx: Ctx):
    """``x + attn(ln1(x))`` (GQA or MLA by ``cfg.attn_kind``), then
    ``+ moe(ln2(.))``. Returns the MoE layer's aux."""
    h = rmsnorm(p["ln1"], x, ctx.cfg.norm_eps)
    a, new_cache = _attn(p["attn"], h, cache, ctx, ctx.cfg.attn_kind)
    x = x + a
    mo, aux = moe_mod.moe_block(p["moe"], rmsnorm(p["ln2"], x, ctx.cfg.norm_eps), cfg=ctx.cfg)
    return x + mo, new_cache, aux


def ssm_block_schema(cfg: ModelConfig) -> dict:
    """A pre-norm Mamba-2 block: ``ln`` and ``mixer``."""
    return {"ln": rmsnorm_schema(cfg.d_model), "mixer": ssm_mod.ssm_schema(cfg)}


def ssm_block(p, x, cache, ctx: Ctx):
    """``x + mamba2(ln(x))``: the chunked scan in train and prefill (prefill
    returns the layer's state and conv prefixes), one recurrent step in
    decode (the layer's cache updated in place)."""
    h = rmsnorm(p["ln"], x, ctx.cfg.norm_eps)
    if ctx.mode == "train":
        return x + ssm_mod.mamba2_block(p["mixer"], h, cfg=ctx.cfg), None, None
    if ctx.mode == "prefill":
        out, new_cache = ssm_mod.mamba2_block(p["mixer"], h, cfg=ctx.cfg, cache=cache,
                                              return_cache=True)
        return x + out, new_cache, None
    out, new_cache = ssm_mod.mamba2_decode_step(p["mixer"], h, cache, cfg=ctx.cfg)
    return x + out, new_cache, None


def encdec_dec_block_schema(cfg: ModelConfig) -> dict:
    """The decoder block of an encoder-decoder: ``ln1``, ``self_attn``,
    ``ln_x``, ``cross_attn`` (both GQA), ``ln2``, ``mlp``."""
    d = cfg.d_model
    return {
        "ln1": rmsnorm_schema(d),
        "self_attn": gqa_schema(cfg),
        "ln_x": rmsnorm_schema(d),
        "cross_attn": gqa_schema(cfg),
        "ln2": rmsnorm_schema(d),
        "mlp": mlp_schema(d, cfg.d_ff),
    }


def encdec_dec_block(p, x, cache, ctx: Ctx):
    """``x + self_attn(ln1(x))`` (causal), ``+ cross_attn(ln_x(.))`` over
    the encoder's output, then ``+ mlp(ln2(.))``. The layer's cache is
    ``{"k", "v"}`` of the self-attention and ``{"ck", "cv"}`` of the
    cross-attention in one dict."""
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    cross_cache = None if cache is None else {"ck": cache["ck"], "cv": cache["cv"]}
    eps = ctx.cfg.norm_eps
    a, new_self = gqa_attn(p["self_attn"], rmsnorm(p["ln1"], x, eps), self_cache, ctx)
    x = x + a
    c, new_cross = cross_attn(p["cross_attn"], rmsnorm(p["ln_x"], x, eps), cross_cache, ctx)
    x = x + c
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, eps))
    return x, (None if new_self is None else {**new_self, **new_cross}), None


# ----------------------------------------------------------------------
# Stack machinery
# ----------------------------------------------------------------------
def stack_schema(layer_schema: dict, n: int) -> Stacked:
    """``n`` layers of one schema (one module each, in the per-layer
    layout)."""
    return Stacked(layer_schema, n)


def tree_index(tree, i):
    """Layer ``i`` of a stacked cache tree (views: writes reach the stack)."""
    return {k: tree_index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def tree_stack(trees):
    """Stack the layers' cache trees along a new leading axis."""
    return {k: tree_stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def run_layer(block_fn, p, x, cache, ctx: Ctx):
    """One layer, ``block_fn(p, x, cache, ctx)``; with ``ctx.remat`` in a
    training forward that autograd records, under a non-reentrant
    ``torch.utils.checkpoint``."""
    if ctx.remat and ctx.mode == "train" and torch.is_grad_enabled():
        return checkpoint(block_fn, p, x, cache, ctx, use_reentrant=False)
    return block_fn(p, x, cache, ctx)


def scan_stack(block_fn, stacked_p, x, ctx: Ctx, stacked_cache=None):
    """Run the layers in order (each through ``run_layer``).
    ``stacked_cache`` (decode) holds tensors with a leading layer axis;
    prefill returns the layers' new caches stacked the same way. Returns
    (x, new_stacked_cache, aux): aux is the sum over the layers of each
    entry of the blocks' aux (MoE blocks), or ``None`` for blocks without
    one."""
    new_caches = []
    aux = None
    for i, p in enumerate(stacked_p):
        cache = None if stacked_cache is None else tree_index(stacked_cache, i)
        x, new_cache, a = run_layer(block_fn, p, x, cache, ctx)
        new_caches.append(new_cache)
        if a is not None:
            aux = a if aux is None else {k: aux[k] + v for k, v in a.items()}
    if stacked_cache is not None:
        return x, stacked_cache, aux  # the layer views were written in place
    if new_caches[0] is None:
        return x, None, aux
    return x, tree_stack(new_caches), aux
