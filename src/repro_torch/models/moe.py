"""Mixture-of-Experts on one device: routing, gather dispatch, the grouped
SwiGLU product and the weighted combine.

The counterpart of ``repro.models.moe``'s gather implementation
(``_moe_local``) with one expert shard (``n_shards=1``, no mesh axis).
Dispatch is the FlooNoC multi-stream DMA analogue: the (token, expert)
assignments are sorted by expert (stably) and moved in bulk, one grouped
product per expert weight over row groups, instead of a [T, E, C] one-hot
dispatch tensor.

On one shard every assignment is local, so the reference's bucket of
foreign rows stays empty: the sorted assignments past the capacity ``M``
are the dropped ones (``T * k - M``, known on the host), and the capped
group sizes end exactly at ``M``. The group sizes are counted with a
fixed-length scatter-add, capped at ``M`` and handed as end offsets to
``torch._grouped_mm`` (the counterpart of ``jax.lax.ragged_dot``, which
the JAX package runs outside any Pallas kernel), on every device. On a
card that is one kernel in bf16, and nothing is read back to the host;
PyTorch's float32 grouped product reads the offsets.

The all-to-all dispatch (``_moe_local_a2a``) needs a device mesh and is
not ported (ROADMAP Queue 1 item 12, step 7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp
from repro_torch.models.spec import PSpec


def moe_schema(cfg: ModelConfig) -> dict:
    """The float32 router [d, E], the routed experts ``w1`` / ``w3``
    [E, d, ff] and ``w2`` [E, ff, d], and the shared experts as one SwiGLU
    MLP of width ``ff * n_shared_experts``."""
    d, ff = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    sch = {
        "router": PSpec((d, cfg.n_experts), ("embed", None), "float32", "scaled:0"),
        "w1": PSpec((cfg.n_experts, d, ff), ("experts", "embed", "expert_mlp"), init="scaled:1"),
        "w3": PSpec((cfg.n_experts, d, ff), ("experts", "embed", "expert_mlp"), init="scaled:1"),
        "w2": PSpec((cfg.n_experts, ff, d), ("experts", "expert_mlp", "embed"), init="scaled:1"),
    }
    if cfg.n_shared_experts:
        ffs = ff * cfg.n_shared_experts
        sch["shared"] = {
            "w1": PSpec((d, ffs), ("embed", "mlp"), init="scaled:0"),
            "w3": PSpec((d, ffs), ("embed", "mlp"), init="scaled:0"),
            "w2": PSpec((ffs, d), ("mlp", "embed"), init="scaled:0"),
        }
    return sch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity_rows(capacity_factor: float, T: int, k: int, E: int) -> int:
    """Rows of the grouped product (the JAX package's ``M``, with its
    Python arithmetic and one shard of all ``E`` experts):
    ``capacity_factor`` times the ``T * k`` assignments, at least 8, a
    multiple of 8, at most ``T * k``."""
    M = _round_up(max(int(capacity_factor * T * k * E / E), 8), 8)
    return min(M, T * k)


def router_logits(xf, router):
    """float32 ``xf @ router`` in full float32 on every device: on a card
    whose process allows TF32 (or bf16) for float32 matrix products, the
    precision is set to "highest" for this one product and restored as it
    was (TF32 keeps about three decimal digits, enough to move a token to
    another expert)."""
    xf = xf.to(torch.float32)
    precision = torch.get_float32_matmul_precision()
    if not xf.is_cuda or precision == "highest":
        return xf @ router
    torch.set_float32_matmul_precision("highest")
    try:
        return xf @ router
    finally:
        torch.set_float32_matmul_precision(precision)


def moe_block(p, x, *, cfg: ModelConfig, capacity_factor: float | None = None,
              impl: str = "gather"):
    """x [B, S, d] -> (out [B, S, d] in x's dtype, aux): the JAX package's
    ``_moe_local`` on one shard. ``capacity_factor=None`` takes
    ``cfg.moe_capacity_factor``. aux holds 0-d float32 tensors:
    ``lb_loss`` (the Switch load-balance loss), ``router_z`` (the router
    z-loss) and ``dropped_frac`` (assignments past capacity over
    ``T * k``). ``impl="a2a"`` (the all-to-all dispatch) is refused."""
    if impl != "gather":
        raise NotImplementedError(
            f"the {impl!r} MoE dispatch needs a device mesh and is not ported yet "
            "(ROADMAP Queue 1 item 12, step 7)")
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    b, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = b * S
    dev = x.device
    xf = x.reshape(T, d)

    # --- routing (float32) ---
    logits = router_logits(xf, p["router"])  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)  # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    eid = top_e.reshape(-1)  # [T*k]

    # aux: Switch load-balance loss + router z-loss
    me = probs.mean(dim=0)  # [E]
    ce = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, eid, torch.ones(T * k, dtype=torch.float32, device=dev)) / (T * k)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # --- dispatch: assignments sorted by expert (stable); the first M kept ---
    tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    order = torch.sort(eid, stable=True).indices
    M = capacity_rows(cf, T, k, E)
    ids = order[:M]
    sel_tok = tok[ids]
    sel_w = top_w.reshape(-1)[ids]

    # group sizes within capacity, as end offsets (the last is M)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, eid, torch.ones_like(eid))
    offs = torch.clamp(torch.cumsum(counts, 0), max=M).to(torch.int32)

    xg = xf[sel_tok].to(p["w1"].dtype)  # [M, d]
    h = (F.silu(torch._grouped_mm(xg, p["w1"], offs=offs))
         * torch._grouped_mm(xg, p["w3"], offs=offs))
    y = torch._grouped_mm(h, p["w2"], offs=offs)  # [M, d]

    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    out.index_add_(0, sel_tok, y.to(torch.float32) * sel_w[:, None])
    if "shared" in p:
        out = out + mlp(p["shared"], xf).to(torch.float32)

    dropped = torch.full((), T * k - M, dtype=torch.float32, device=dev)  # past capacity
    aux = {"lb_loss": lb_loss, "router_z": z_loss, "dropped_frac": dropped / (T * k)}
    return out.reshape(b, S, d).to(x.dtype), aux
