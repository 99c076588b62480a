"""A MoE layer's routing, recorded for checks: the port's ``moe_block``
wrapped (through ``monkeypatch``) to recompute, from the same input and
router, each call's top-k expert ids and each token's router margin (the
k-th probability less the next one). Imports neither JAX nor ``repro``."""
import torch

from repro_torch.models import moe as TMOE


def route(p, x, k):
    """(top-k expert ids [T, k], router margin [T]) of the MoE layer ``p``
    on ``x`` [..., d], on the CPU."""
    probs = torch.softmax(TMOE.router_logits(x.reshape(-1, x.shape[-1]), p["router"]), -1)
    top = torch.topk(probs, k + 1, dim=-1)
    return top.indices[:, :k].cpu(), (top.values[:, k - 1] - top.values[:, k]).cpu()


def record_routing(monkeypatch):
    """Wrap the port's ``moe_block`` so that each call appends its
    ``route`` to the list returned, in call order (a model's MoE layers in
    layer order)."""
    records = []
    inner = TMOE.moe_block

    def recorded(p, x, *, cfg, **kw):
        records.append(route(p, x, cfg.moe_top_k))
        return inner(p, x, cfg=cfg, **kw)

    monkeypatch.setattr(TMOE, "moe_block", recorded)
    return records
