"""Model assembly for the port: ``param_schema`` / ``forward`` /
``prefill`` / ``decode_step``, driven by ``ModelConfig``.

The counterpart of ``repro.models.model`` for every family: dense, with
GQA (Phi-4-mini, Granite, Mistral-Large; Qwen2-VL's M-RoPE and vision
stub: ``patch_proj`` maps precomputed patch embeddings into the leading
``min(frontend_tokens, S)`` slots, which rotate by their (t, h, w) grid
position; Gemma 3's local:global attention:
superblocks of ``local_global_period - 1`` sliding-window layers with
window-sized ring caches, then one global layer, then the trailing local
layers) or MLA attention; ``moe`` with GQA or MLA attention and gather
dispatch (Llama-4-Scout; DeepSeek-V2: MoE blocks after ``first_k_dense``
dense ones, sharing their cache layout: K/V for GQA, the compressed
``ckv`` / ``krope`` for MLA); ``ssm`` (Mamba-2) and ``hybrid`` (Zamba2:
superblocks of ``shared_attn_period`` Mamba-2 layers, each followed by one
tied dense GQA block with its own KV cache per application, then the
trailing Mamba-2 layers); ``encdec`` (SeamlessM4T: the speech front end
is a stub fed frame embeddings, which ``frame_proj`` and the learned
``enc_pos`` turn into the non-causal encoder's input; each decoder layer
attends causally to itself and across to the encoder's output, whose keys
and values the prefill caches once as ``ck`` / ``cv``). A local:global or
hybrid model may have no
superblock at all (fewer layers than one period): its ``superblocks``
leaves are then zero-size, as the JAX package's. Every other attention
kind, MLA in a local:global, hybrid or encoder-decoder model (where the
JAX package silently builds GQA), M-RoPE or a vision front end outside a
plain dense GQA model (where the JAX package builds no ``patch_proj`` or
was never run), an audio front end outside the encoder-decoder, and a
sliding window anywhere but in a dense model's local:global layers, raises
``NotImplementedError`` naming ROADMAP Queue 1 item 12.

Training: ``loss_fn`` (JAX's: float32 cross-entropy over ``loss_mask``, a
z-loss and, for a MoE model, the load-balance and router z-losses), over a
``forward`` that recomputes each layer in the backward pass when
``rt.remat`` is set; ``params_to_numpy`` carries the port's parameters back
to JAX's flat stacked layout. Serving may build an int8 KV cache
(``cache_schema`` / ``init_cache`` with ``quant=True``).
"""
from __future__ import annotations

import math
from functools import partial

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.spec import (
    DTYPES,
    PSpec,
    build_tree,
    count_params_tree,
    init_tree,
    stack_layers,
    stacked_shapes,
)
from repro_torch.runtime import Runtime, default_runtime
from repro_torch.models.transformer import (
    ATTN_SCHEMAS,
    Ctx,
    dense_block,
    dense_block_schema,
    encdec_dec_block,
    encdec_dec_block_schema,
    moe_layer_block,
    moe_layer_schema,
    run_layer,
    scan_stack,
    ssm_block,
    ssm_block_schema,
    stack_schema,
    tree_index,
    tree_stack,
)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")  # the families the port runs
MAX_ENC_POS = 16_384  # rows of an encoder-decoder's learned positions
MOE_AUX_COEF = 0.01  # the load-balance loss's weight in the training loss
ROUTER_Z_COEF = 1e-3  # the router z-loss's


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    why = None
    local_global = cfg.family == "dense" and cfg.local_global_period and cfg.sliding_window
    # M-RoPE and the vision stub run in a plain dense GQA model only; the
    # frames of an encoder-decoder stand for its audio front end
    plain_dense = (cfg.family == "dense" and not cfg.local_global_period
                   and cfg.attn_kind == "gqa")
    front_end_ok = {"text": True, "vision": plain_dense,
                    "audio": cfg.family == "encdec"}.get(cfg.modality, False)
    if cfg.family not in FAMILIES:
        why = f"the {cfg.family!r} family"
    elif not front_end_ok:
        why = f"the {cfg.modality!r} front end in a {cfg.family!r} model"
    elif cfg.rope_kind == "mrope" and not plain_dense:
        why = "M-RoPE outside a plain dense GQA model"
    elif cfg.family == "ssm":
        pass  # attention-free
    elif (cfg.local_global_period or cfg.sliding_window) and not local_global:
        # the JAX package applies a window only in a dense model's local
        # layers, and silently none elsewhere
        why = "sliding-window attention outside a dense model's local:global layers"
    elif cfg.attn_kind not in ATTN_SCHEMAS:
        why = f"{cfg.attn_kind!r} attention"
    elif cfg.attn_kind == "mla" and (local_global or cfg.family in ("hybrid", "encdec")):
        why = "MLA attention in a local:global, hybrid or encoder-decoder model"
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported yet (ROADMAP Queue 1 item 12)")


# ======================================================================
# Schema
# ======================================================================
def _superblock_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """(layers per superblock, superblocks, trailing layers) of a hybrid
    (``shared_attn_period``) or a local:global model
    (``local_global_period``)."""
    per = cfg.shared_attn_period if cfg.family == "hybrid" else cfg.local_global_period
    n_super = cfg.n_layers // per
    return per, n_super, cfg.n_layers - n_super * per


def param_schema(cfg: ModelConfig) -> dict:
    """The model's parameter schema: embedding, final norm, the blocks
    (for a moe model: ``dense_blocks`` when ``first_k_dense > 0``, then
    the MoE ``blocks``; for a hybrid: ``superblocks`` [n_super][per], one
    ``shared_attn`` block and the ``trailing`` layers; for a local:global
    model: ``superblocks`` [n_super] of ``local`` [per - 1] blocks and one
    ``global`` block, then the ``trailing`` local blocks; a vision model
    adds ``patch_proj`` [d, d]; an encoder-decoder has ``frame_proj`` [d,
    d], ``enc_pos`` and ``dec_pos`` [MAX_ENC_POS, d], ``enc_blocks``,
    ``dec_blocks`` and ``enc_final_norm``)."""
    check_supported(cfg)
    sch = {"embed": embed_schema(cfg), "final_norm": rmsnorm_schema(cfg.d_model)}
    if cfg.family == "dense" and cfg.local_global_period:
        per, n_super, trailing = _superblock_split(cfg)
        sch["superblocks"] = stack_schema(
            {"local": stack_schema(dense_block_schema(cfg), per - 1),
             "global": dense_block_schema(cfg)}, n_super)
        if trailing:
            sch["trailing"] = stack_schema(dense_block_schema(cfg), trailing)
    elif cfg.family == "dense":
        sch["blocks"] = stack_schema(dense_block_schema(cfg, attn=cfg.attn_kind), cfg.n_layers)
        if cfg.modality == "vision":
            sch["patch_proj"] = PSpec((cfg.d_model,) * 2, ("embed_in", "embed"), init="scaled:0")
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            sch["dense_blocks"] = stack_schema(dense_block_schema(cfg, attn=cfg.attn_kind),
                                               cfg.first_k_dense)
        sch["blocks"] = stack_schema(moe_layer_schema(cfg), cfg.n_layers - cfg.first_k_dense)
    elif cfg.family == "ssm":
        sch["blocks"] = stack_schema(ssm_block_schema(cfg), cfg.n_layers)
    elif cfg.family == "encdec":
        d = cfg.d_model
        sch["frame_proj"] = PSpec((d, d), ("embed_in", "embed"), init="scaled:0")
        sch["enc_pos"] = PSpec((MAX_ENC_POS, d), (None, "embed"), scale=0.01)
        sch["dec_pos"] = PSpec((MAX_ENC_POS, d), (None, "embed"), scale=0.01)
        sch["enc_blocks"] = stack_schema(dense_block_schema(cfg), cfg.n_enc_layers)
        sch["dec_blocks"] = stack_schema(encdec_dec_block_schema(cfg), cfg.n_dec_layers)
        sch["enc_final_norm"] = rmsnorm_schema(d)
    else:
        per, n_super, trailing = _superblock_split(cfg)
        sch["superblocks"] = stack_schema(stack_schema(ssm_block_schema(cfg), per), n_super)
        sch["shared_attn"] = dense_block_schema(cfg)  # tied weights (one copy)
        if trailing:
            sch["trailing"] = stack_schema(ssm_block_schema(cfg), trailing)
    return sch


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``'s schema; ``active_only`` counts a MoE
    model's routed experts at ``moe_top_k / n_experts`` of their weights
    (the JAX package's formula)."""
    total = count_params_tree(param_schema(cfg))
    if active_only and cfg.family == "moe":
        d, ff = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        routed = 3 * cfg.n_experts * d * ff * (cfg.n_layers - cfg.first_k_dense)
        total = total - routed + int(routed * cfg.moe_top_k / cfg.n_experts)
    return total


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
    their leading layer axes (``"blocks.attn.wq"`` [L, d, H, D],
    ``"blocks.moe.w1"`` [L, E, d, ff], ``"blocks.moe.router"`` [L, d, E],
    ``"superblocks.mixer.wz"`` [n_super, per, d, H, P], ``"superblocks.
    local.attn.wq"`` [n_super, per - 1, d, H, D], ``"shared_attn.attn.wq"``
    unstacked). Every leaf is checked against the schema's
    stacked shape and cast to its dtype; keys the schema lacks, or lacks in
    ``tree``, raise. The zero-size leaves of a stack with no layers (a
    model with no superblock) hold no parameter: their shapes are checked
    alone."""
    dev = resolve_device(device)
    schema = param_schema(cfg)
    shapes = stacked_shapes(schema)
    used = set()

    def leaf(path, spec):
        parts = path.split(".")
        key = ".".join(x for x in parts if not x.isdigit())
        layer = tuple(int(x) for x in parts if x.isdigit())
        if key not in tree:
            raise KeyError(f"{cfg.name}: no parameter {key!r} in the tree")
        used.add(key)
        arr = np.asarray(tree[key])
        want = shapes[key]
        if arr.shape != want:
            raise ValueError(f"{key}: shape {arr.shape}, expected {want}")
        return torch.as_tensor(np.array(arr[layer], np.float32)).to(DTYPES[spec.dtype]).to(dev)

    params = build_tree(schema, leaf)
    # the schema's keys that built no parameter are those of stacks with no
    # layers: their leaves must be there, zero-size, of the stacked shape
    for key in sorted(set(shapes) - used):
        if key not in tree:
            raise KeyError(f"{cfg.name}: no parameter {key!r} in the tree")
        if np.shape(tree[key]) != shapes[key]:
            raise ValueError(f"{key}: shape {np.shape(tree[key])}, expected {shapes[key]}")
    extra = sorted(set(tree) - set(shapes))
    if extra:
        raise KeyError(f"{cfg.name}: parameters the port does not have: {extra}")
    return params


def params_to_numpy(cfg: ModelConfig, params) -> dict:
    """The inverse of ``params_from_numpy``: the port's parameters as
    float32 numpy arrays keyed by the JAX package's flat paths, stacked
    layers with their leading layer axes (a stack with no layers as a
    zero-size array of its stacked shape)."""
    flat = stack_layers(dict(params.named_parameters()),
                        stacked_shapes(param_schema(cfg)))
    return {k: t.to(torch.float32).numpy() for k, t in flat.items()}


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def _mrope_positions(cfg: ModelConfig, B: int, S: int, device=None):
    """[B, S, 3] (t, h, w) int32: the leading P = min(frontend_tokens, S)
    patch slots at (0, i // g, i % g) on a grid of g = floor(sqrt(P))
    columns, then text at t == h == w = i - P + g."""
    P = min(cfg.frontend_tokens, S)
    g = max(int(math.sqrt(P)), 1)
    i = torch.arange(S, device=device)
    is_patch = i < P
    text = i - P + g
    pos = torch.stack([torch.where(is_patch, torch.zeros_like(i), text),
                       torch.where(is_patch, i // g, text),
                       torch.where(is_patch, i % g, text)], -1).to(torch.int32)
    return pos[None].expand(B, S, 3)


def _embed_input(cfg: ModelConfig, p, batch):
    """Token embedding; a vision model's batch may carry ``patch_embeds``
    [B, P, d], which ``patch_proj`` maps into the first P slots (cast to
    its dtype first: the JAX package promotes a float32 stub against bf16
    weights instead). Returns (x, pos): M-RoPE's grid positions, else the
    default ones."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(p["embed"], tokens)
    if cfg.modality == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        pe = pe.to(p["patch_proj"].dtype) @ p["patch_proj"]
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if cfg.rope_kind == "mrope":
        return x, _mrope_positions(cfg, B, S, tokens.device)
    return x, positions_for(cfg, (B, S), device=tokens.device)


def _run_superblocks(pairs, keys, stack_fn, block_fn, x, ctx: Ctx, sc=None):
    """Superblock i runs ``stack_fn`` over the layers of ``pairs[i][0]``,
    then ``block_fn`` with ``pairs[i][1]``, their caches under ``keys``
    (stack's, block's) of the superblock's cache ``sc[i]``. Returns (x, the
    superblocks' stacked caches): decode's written in place, prefill's
    new; with no superblock, zero-size leaves of the prefill's shapes)."""
    outs = []
    for i, (stack_p, block_p) in enumerate(pairs):
        scache = None if sc is None else tree_index(sc, i)
        x, stack_c, _ = scan_stack(stack_fn, stack_p, x, ctx,
                                   stacked_cache=None if scache is None else scache[keys[0]])
        x, block_c, _ = run_layer(block_fn, block_p, x,
                                  None if scache is None else scache[keys[1]], ctx)
        outs.append({keys[0]: stack_c, keys[1]: block_c})
    if sc is None and ctx.mode == "prefill":
        sc = tree_stack(outs) if outs else _no_superblocks(ctx.cfg, x)
    return x, sc


def _no_superblocks(cfg: ModelConfig, x):
    """The zero-size ``superblocks`` caches of a prefill of ``x`` [B, S, d]
    by a model with no superblock: ``cache_schema``'s shapes, but local
    rings of ``sliding_window`` slots, as a prefill builds them, and every
    leaf but the float32 SSM state in x's dtype (the JAX package's scan over
    no layers)."""
    B, S = x.shape[:2]
    sch = cache_schema(cfg, B, S)["superblocks"]
    if cfg.family == "dense":
        sch["local"] = cache_schema(cfg, B, max(S, cfg.sliding_window))["superblocks"]["local"]
    return _tree_map(lambda s: torch.zeros(
        s.shape, dtype=torch.float32 if s.dtype == "float32" else x.dtype, device=x.device), sch)


def _run_lm_stacks(cfg: ModelConfig, p, x, ctx: Ctx, caches=None):
    """The dense (with its local:global branch), moe, ssm and hybrid
    branches of the JAX package's ``_run_lm_stacks``. Returns (x,
    new_caches, aux): aux is the MoE blocks' aux summed over the layers,
    ``None`` for the other families."""
    c = caches or {}
    dense = partial(dense_block, attn_kind=cfg.attn_kind)
    if cfg.family == "moe":
        new_caches = {}
        if "dense_blocks" in p:
            x, new_caches["dense_blocks"], _ = scan_stack(
                dense, p["dense_blocks"], x, ctx, stacked_cache=c.get("dense_blocks"))
        x, new_caches["blocks"], aux = scan_stack(moe_layer_block, p["blocks"], x, ctx,
                                                  stacked_cache=c.get("blocks"))
        return x, new_caches, aux
    if cfg.family == "ssm" or (cfg.family == "dense" and not cfg.local_global_period):
        block = dense if cfg.family == "dense" else ssm_block
        x, bc, _ = scan_stack(block, p["blocks"], x, ctx, stacked_cache=c.get("blocks"))
        return x, {"blocks": bc}, None
    if cfg.family == "dense":
        # local:global: each superblock's sliding-window layers (ring caches
        # outside training), then its global layer; the trailing layers local
        layer = partial(dense_block, window=cfg.sliding_window, ring=ctx.mode != "train")
        pairs = [(sp["local"], sp["global"]) for sp in p["superblocks"]]
        keys = ("local", "global")
    else:
        # hybrid: each superblock's SSM layers, then the shared attention
        # block with this application's KV cache
        layer = ssm_block
        pairs = [(sp, p["shared_attn"]) for sp in p["superblocks"]]
        keys = ("ssm", "attn")
    x, sc = _run_superblocks(pairs, keys, layer, dense_block, x, ctx, c.get("superblocks"))
    new_caches = {"superblocks": sc}
    if "trailing" in p:
        x, new_caches["trailing"], _ = scan_stack(layer, p["trailing"], x, ctx,
                                                  stacked_cache=c.get("trailing"))
    return x, new_caches, None


def _encdec_encode(cfg: ModelConfig, p, frames, remat: bool = False):
    """The encoder: ``frames`` [B, S_enc, d] (cast to the weights' dtype)
    through ``frame_proj``, plus ``enc_pos``, then the non-causal stack in
    train mode (the encoder caches nothing; ``remat`` as the JAX package's
    runtime sets it) and ``enc_final_norm``."""
    B, S_enc, _ = frames.shape
    h = frames.to(p["frame_proj"].dtype) @ p["frame_proj"]
    h = h + p["enc_pos"][:S_enc][None]
    ctx = Ctx(cfg=cfg, mode="train", pos=positions_for(cfg, (B, S_enc), frames.device),
              causal=False, remat=remat)
    h, _, _ = scan_stack(dense_block, p["enc_blocks"], h, ctx)
    return rmsnorm(p["enc_final_norm"], h, cfg.norm_eps)


def _encdec_forward(cfg: ModelConfig, p, batch, mode: str, remat: bool = False):
    """An encoder-decoder's forward: the encoder over ``batch["frames"]``,
    then the decoder over the tokens plus ``dec_pos``, attending across to
    the encoder's output (``batch["enc_len"]`` long, all of it if absent).
    A prefill's caches are the decoder's ``dec_blocks`` {k, v, ck, cv} and
    ``enc_out``."""
    enc_out = _encdec_encode(cfg, p, batch["frames"], remat)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(p["embed"], tokens) + p["dec_pos"][:S][None]
    enc_len = batch.get("enc_len")
    if enc_len is None:
        enc_len = torch.full((B,), enc_out.shape[1], dtype=torch.int32, device=tokens.device)
    ctx = Ctx(cfg=cfg, mode=mode, pos=positions_for(cfg, (B, S), tokens.device),
              enc_out=enc_out, enc_len=enc_len, remat=remat)
    x, bc, _ = scan_stack(encdec_dec_block, p["dec_blocks"], x, ctx)
    logits = unembed(p["embed"], rmsnorm(p["final_norm"], x, cfg.norm_eps))
    return logits, ({"dec_blocks": bc, "enc_out": enc_out} if mode == "prefill" else None), None


def forward(cfg: ModelConfig, p, batch, mode: str = "train", rt: Runtime | None = None):
    """Teacher-forced forward. Returns (logits [B, S, V] float32, caches,
    aux). With ``rt.remat`` (the default runtime's) a training forward that
    autograd records recomputes each layer in the backward pass."""
    check_supported(cfg)
    remat = (rt or default_runtime()).remat
    if cfg.family == "encdec":
        return _encdec_forward(cfg, p, batch, mode, remat)
    x, pos = _embed_input(cfg, p, batch)
    ctx = Ctx(cfg=cfg, mode=mode, pos=pos, remat=remat)
    x, caches, aux = _run_lm_stacks(cfg, p, x, ctx)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = unembed(p["embed"], x)
    return logits, (caches if mode == "prefill" else None), aux


# ======================================================================
# Loss
# ======================================================================
def loss_fn(cfg: ModelConfig, p, batch, rt: Runtime | None = None):
    """The training loss of JAX's ``loss_fn``: float32 ``log_softmax``
    cross-entropy averaged over ``batch["loss_mask"]`` (ones if absent; the
    denominator at least 1), plus 1e-4 x the z-loss (the mask-averaged
    squared ``logsumexp`` of the logits); a MoE model adds
    ``MOE_AUX_COEF`` x its load-balance loss and ``ROUTER_Z_COEF`` x its
    router z-loss, each summed over its MoE layers and divided by their
    number. Returns (loss, metrics): ``ce``, ``z_loss`` (and ``lb_loss``,
    ``router_z``, ``dropped_frac``) and ``loss``, 0-d float32 tensors."""
    logits, _, aux = forward(cfg, p, batch, mode="train", rt=rt)
    targets = batch["targets"].long()
    mask = batch.get("loss_mask")
    mask = torch.ones(targets.shape, device=logits.device) if mask is None else mask
    mask = mask.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    # z-loss stabilizes the f32 softmax at scale
    zl = ((torch.logsumexp(logits, dim=-1) ** 2) * mask).sum() / denom
    loss = ce + 1e-4 * zl
    metrics = {"ce": ce, "z_loss": zl}
    if aux is not None:
        n_moe = max(cfg.n_layers - cfg.first_k_dense, 1)
        lb, rz = aux["lb_loss"] / n_moe, aux["router_z"] / n_moe
        loss = loss + MOE_AUX_COEF * lb + ROUTER_Z_COEF * rz
        metrics.update(lb_loss=lb, router_z=rz, dropped_frac=aux["dropped_frac"] / n_moe)
    metrics["loss"] = loss
    return loss, metrics


# ======================================================================
# KV cache + decode
# ======================================================================
def cache_schema(cfg: ModelConfig, B: int, S: int, *, quant: bool = False) -> dict:
    """PSpec tree mirroring what prefill/decode produce. S = max context.
    KV caches are [layers, B, S, KV, D] bf16 (a moe model's as a dense
    model's: ``dense_blocks`` and ``blocks``; with MLA the compressed
    ``ckv`` [layers, B, S, kv_lora_rank] and ``krope`` [layers, B, S,
    qk_rope_head_dim] instead; a local:global model's local
    layers [n_super, per - 1, B, W, KV, D] and trailing layers rings of W =
    ``min(sliding_window, S)`` slots, its global layers [n_super, B, S, KV,
    D]; an encoder-decoder's ``dec_blocks`` hold ``k`` / ``v`` and the
    cross-attention's ``ck`` / ``cv`` [n_dec_layers, B, S, KV, D] (S_enc =
    S), beside ``enc_out`` [B, S, d] and ``enc_len`` [B]); an SSM layer
    holds its state [B, H, P, N] float32 and the last W - 1 raw conv inputs
    in bf16. ``quant``: the GQA caches JAX quantises (every one but a
    local:global model's local rings and an encoder-decoder's) hold int8
    ``k`` / ``v`` and float32 ``k_scale`` / ``v_scale`` [..., B, S, KV]."""
    check_supported(cfg)
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim

    def kv(lead, s=S, quantised=quant):
        ax = ("layers", "layers2")[: len(lead)]
        if cfg.attn_kind == "mla":
            return {key: PSpec(lead + (B, s, n), ax + ("batch", None, None), init="zeros")
                    for key, n in (("ckv", cfg.kv_lora_rank), ("krope", cfg.qk_rope_head_dim))}
        spec = PSpec(lead + (B, s, KV, D), ax + ("batch", None, "kv_heads", None),
                     "int8" if quantised else "bfloat16", "zeros")
        if not quantised:
            return {"k": spec, "v": spec}
        scale = PSpec(lead + (B, s, KV), ax + ("batch", None, "kv_heads"), "float32", "zeros")
        return {"k": spec, "v": spec, "k_scale": scale, "v_scale": scale}

    def ssm_cache(*lead):
        _, H, P_, N = ssm_mod.ssm_dims(cfg)
        W = cfg.ssm_conv_width
        ax = ("layers", "layers2")[: len(lead)]
        return {
            "state": PSpec(lead + (B, H, P_, N), ax + ("batch", "ssm_heads", None, None),
                           "float32", "zeros"),
            "conv": {
                "x": PSpec(lead + (B, W - 1, H, P_), ax + ("batch", None, "ssm_heads", None),
                           init="zeros"),
                "B": PSpec(lead + (B, W - 1, N), ax + ("batch", None, None), init="zeros"),
                "C": PSpec(lead + (B, W - 1, N), ax + ("batch", None, None), init="zeros"),
            },
        }

    sch = {"len": PSpec((B,), ("batch",), "int32", "zeros")}
    if cfg.family == "dense" and cfg.local_global_period:
        per, n_super, trailing = _superblock_split(cfg)
        W = min(cfg.sliding_window, S)
        sch["superblocks"] = {"local": kv((n_super, per - 1), W, False),
                              "global": kv((n_super,))}
        if trailing:
            sch["trailing"] = kv((trailing,), W)
    elif cfg.family in ("dense", "moe"):
        n_dense = cfg.first_k_dense if cfg.family == "moe" else 0
        sch["blocks"] = kv((cfg.n_layers - n_dense,))
        if n_dense:
            sch["dense_blocks"] = kv((n_dense,))
    elif cfg.family == "ssm":
        sch["blocks"] = ssm_cache(cfg.n_layers)
    elif cfg.family == "encdec":
        self_kv = kv((cfg.n_dec_layers,), S, False)
        sch["dec_blocks"] = {**self_kv, "ck": self_kv["k"], "cv": self_kv["v"]}
        sch["enc_out"] = PSpec((B, S, cfg.d_model), ("batch", None, None), init="zeros")
        sch["enc_len"] = PSpec((B,), ("batch",), "int32", "zeros")
    else:
        per, n_super, trailing = _superblock_split(cfg)
        sch["superblocks"] = {"ssm": ssm_cache(n_super, per), "attn": kv((n_super,))}
        if trailing:
            sch["trailing"] = ssm_cache(trailing)
    return sch


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def init_cache(cfg: ModelConfig, B: int, S: int, device=None, *, quant: bool = False):
    """An empty cache (zeros; the JAX package fills the unwritten KV slots
    with random values, which decode masks either way); ``quant`` the int8
    KV cache of ``cache_schema(..., quant=True)``."""
    dev = resolve_device(device)
    return _tree_map(lambda s: torch.zeros(s.shape, dtype=DTYPES[s.dtype], device=dev),
                     cache_schema(cfg, B, S, quant=quant))


def decode_step(cfg: ModelConfig, p, cache, tokens):
    """One decode step. tokens: [B, 1]. Returns (logits [B, 1, V],
    new_cache); the cache's K/V, SSM state and conv tensors are updated in
    place. An encoder-decoder adds ``dec_pos[pos]`` to the token and
    attends across to the cached ``ck`` / ``cv``; M-RoPE rotates the token
    by ``pos - frontend_tokens + g`` (g = floor(sqrt(frontend_tokens))), the
    JAX package's text position after a full patch grid, even where the
    prefill's grid was clipped to fewer slots."""
    posB = cache["len"]  # [B] current length == write position
    if cfg.family == "encdec":
        x = embed(p["embed"], tokens) + p["dec_pos"][posB.long()][:, None]
        ctx = Ctx(cfg=cfg, mode="decode", pos=posB, enc_len=cache["enc_len"])
        x, _, _ = scan_stack(encdec_dec_block, p["dec_blocks"], x, ctx,
                             stacked_cache=cache["dec_blocks"])
        logits = unembed(p["embed"], rmsnorm(p["final_norm"], x, cfg.norm_eps))
        return logits, {**cache, "len": posB + 1}
    x = embed(p["embed"], tokens)
    rope_pos = None
    if cfg.rope_kind == "mrope" and cfg.frontend_tokens:
        P = cfg.frontend_tokens
        rope_pos = posB - P + max(int(math.sqrt(P)), 1)
    ctx = Ctx(cfg=cfg, mode="decode", pos=posB, rope_pos=rope_pos)
    stacks = {k: v for k, v in cache.items() if k != "len"}
    x, new_stacks, _ = _run_lm_stacks(cfg, p, x, ctx, caches=stacks)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = unembed(p["embed"], x)
    new_cache = dict(new_stacks)
    new_cache["len"] = posB + 1
    return logits, new_cache


# the sequence dim of each kind of KV leaf, counted from the end
SEQ_DIM = {"k": -3, "v": -3, "ckv": -2, "krope": -2}


def pad_cache(cfg: ModelConfig, cache, extra: int):
    """Grow the sequence dim of the KV caches (-3 of every ``k`` / ``v``
    leaf, -2 of MLA's ``ckv`` / ``krope``) by ``extra`` decode slots
    (prefill sizes them to the prompt); a local:global model's ``local``
    and ``trailing`` rings, SSM states and conv prefixes, and an
    encoder-decoder's cross-attention ``ck`` / ``cv`` and ``enc_out`` (the
    encoder's length) are fixed-size and stay as they are."""
    if extra <= 0:
        return cache

    def grow(tree, ring):
        return {k: grow(v, ring or (bool(cfg.local_global_period) and k in ("local", "trailing")))
                if isinstance(v, dict)
                else F.pad(v, (0, 0) * (-SEQ_DIM[k] - 1) + (0, extra))
                if k in SEQ_DIM and not ring else v
                for k, v in tree.items()}

    return grow(cache, False)


def prefill(cfg: ModelConfig, p, batch, *, pad_to: int = 0):
    """Prefill: forward with cache construction. Returns (logits, cache).

    pad_to: total cache capacity (prompt + decode head-room); 0 = prompt only.
    """
    logits, caches, _ = forward(cfg, p, batch, mode="prefill")
    B, S = batch["tokens"].shape
    cache = dict(caches)
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    if cfg.family == "encdec":
        cache["enc_len"] = torch.full((B,), cache["enc_out"].shape[1], dtype=torch.int32,
                                      device=logits.device)
    return logits, pad_cache(cfg, cache, pad_to - S)
