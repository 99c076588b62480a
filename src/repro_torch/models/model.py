"""Model assembly for the port: ``param_schema`` / ``forward`` /
``prefill`` / ``decode_step``, driven by ``ModelConfig``.

The counterpart of ``repro.models.model`` for the dense GQA family
without local:global attention (Phi-4-mini, Granite, Mistral-Large). Every
other family and attention kind raises ``NotImplementedError`` naming
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    embed,
    embed_schema,
    positions_for,
    rmsnorm,
    rmsnorm_schema,
    unembed,
)
from repro_torch.models.spec import DTYPES, PSpec, build_tree, count_params_tree, init_tree
from repro_torch.models.transformer import (
    Ctx,
    dense_block,
    dense_block_schema,
    scan_stack,
    stack_schema,
)


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    why = None
    if cfg.family != "dense":
        why = f"the {cfg.family!r} family"
    elif cfg.local_global_period or cfg.sliding_window:
        why = "sliding-window / local:global attention"
    elif cfg.attn_kind != "gqa":
        why = f"{cfg.attn_kind!r} attention"
    elif cfg.rope_kind == "mrope":
        why = "M-RoPE"
    elif cfg.modality != "text":
        why = f"the {cfg.modality!r} front end"
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported yet (ROADMAP Queue 1 item 12)")


# ======================================================================
# Schema
# ======================================================================
def param_schema(cfg: ModelConfig) -> dict:
    """The model's parameter schema: embedding, final norm, the blocks."""
    check_supported(cfg)
    return {
        "embed": embed_schema(cfg),
        "final_norm": rmsnorm_schema(cfg.d_model),
        "blocks": stack_schema(dense_block_schema(cfg), cfg.n_layers),
    }


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``'s schema."""
    return count_params_tree(param_schema(cfg))  # dense: every weight is active


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None):
    """Random parameters on ``device`` (a card unless the caller names
    another), drawn from ``generator`` (seed 0 on that device if omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return init_tree(param_schema(cfg), generator, dev)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None):
    """The port's parameter modules for ``cfg`` from the JAX package's
    parameters as numpy arrays keyed by pytree path, stacked layers with
    their leading layer axis (``"blocks.attn.wq"`` [L, d, H, D]). Every
    leaf is checked against the schema's shape and cast to its dtype; keys
    the schema lacks, or lacks in ``tree``, raise."""
    dev = resolve_device(device)
    used = set()

    def leaf(path, spec):
        parts = path.split(".")
        key = ".".join(x for x in parts if not x.isdigit())
        layer = tuple(int(x) for x in parts if x.isdigit())
        if key not in tree:
            raise KeyError(f"{cfg.name}: no parameter {key!r} in the tree")
        used.add(key)
        arr = np.asarray(tree[key])
        want = (cfg.n_layers,) * len(layer) + spec.shape
        if arr.shape != want:
            raise ValueError(f"{key}: shape {arr.shape}, expected {want}")
        return torch.as_tensor(np.array(arr[layer], np.float32)).to(DTYPES[spec.dtype]).to(dev)

    params = build_tree(param_schema(cfg), leaf)
    extra = sorted(set(tree) - used)
    if extra:
        raise KeyError(f"{cfg.name}: parameters the port does not have: {extra}")
    return params


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def _embed_input(cfg: ModelConfig, p, batch):
    """Token embedding. Returns (x, pos)."""
    tokens = batch["tokens"]
    x = embed(p["embed"], tokens)
    return x, positions_for(cfg, tuple(tokens.shape), device=tokens.device)


def _run_lm_stacks(cfg: ModelConfig, p, x, ctx: Ctx, caches=None):
    """The dense branch of the JAX package's ``_run_lm_stacks``. Returns
    (x, new_caches, aux)."""
    c = caches or {}
    x, bc, _ = scan_stack(dense_block, p["blocks"], x, ctx, stacked_cache=c.get("blocks"))
    return x, {"blocks": bc}, None


def forward(cfg: ModelConfig, p, batch, mode: str = "train"):
    """Teacher-forced forward. Returns (logits [B, S, V] float32, caches,
    aux)."""
    check_supported(cfg)
    x, pos = _embed_input(cfg, p, batch)
    ctx = Ctx(cfg=cfg, mode=mode, pos=pos)
    x, caches, aux = _run_lm_stacks(cfg, p, x, ctx)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = unembed(p["embed"], x)
    return logits, (caches if mode == "prefill" else None), aux


# ======================================================================
# KV cache + decode
# ======================================================================
def cache_schema(cfg: ModelConfig, B: int, S: int) -> dict:
    """PSpec tree mirroring what prefill/decode produce. S = max context."""
    check_supported(cfg)
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    kv = PSpec((L, B, S, KV, D), ("layers", "batch", None, "kv_heads", None), init="zeros")
    return {"len": PSpec((B,), ("batch",), "int32", "zeros"),
            "blocks": {"k": kv, "v": kv}}


def init_cache(cfg: ModelConfig, B: int, S: int, device=None):
    """An empty cache (zeros; the JAX package fills the unwritten slots
    with random values, which decode masks either way)."""
    dev = resolve_device(device)
    sch = cache_schema(cfg, B, S)
    z = lambda s: torch.zeros(s.shape, dtype=getattr(torch, s.dtype), device=dev)
    return {"len": z(sch["len"]), "blocks": {k: z(s) for k, s in sch["blocks"].items()}}


def decode_step(cfg: ModelConfig, p, cache, tokens):
    """One decode step. tokens: [B, 1]. Returns (logits [B, 1, V],
    new_cache); the cache's K/V tensors are updated in place."""
    posB = cache["len"]  # [B] current length == write position
    x = embed(p["embed"], tokens)
    ctx = Ctx(cfg=cfg, mode="decode", pos=posB)
    stacks = {k: v for k, v in cache.items() if k != "len"}
    x, new_stacks, _ = _run_lm_stacks(cfg, p, x, ctx, caches=stacks)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = unembed(p["embed"], x)
    new_cache = dict(new_stacks)
    new_cache["len"] = posB + 1
    return logits, new_cache


def pad_cache(cfg: ModelConfig, cache, extra: int):
    """Grow the sequence dim of the KV caches by ``extra`` decode slots
    (prefill sizes them to the prompt)."""
    if extra <= 0:
        return cache
    grown = {k: F.pad(t, (0, 0, 0, 0, 0, extra)) for k, t in cache["blocks"].items()}
    return {**cache, "blocks": grown}


def prefill(cfg: ModelConfig, p, batch, *, pad_to: int = 0):
    """Prefill: forward with cache construction. Returns (logits, cache).

    pad_to: total cache capacity (prompt + decode head-room); 0 = prompt only.
    """
    logits, caches, _ = forward(cfg, p, batch, mode="prefill")
    B, S = batch["tokens"].shape
    cache = dict(caches)
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    return logits, pad_cache(cfg, cache, pad_to - S)
