"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule: the counterpart of ``repro.optim.adamw``.

The optimizer state mirrors the parameters: float32 ``m`` and ``v`` keyed
by the port's parameter names (``blocks.0.attn.wq``), and ``step``, an
int32 0-d tensor, all on the parameters' device. Every number is computed
as the JAX package computes it: the schedule in float32 from the step, the
clipped gradient rounded to the gradient's dtype before the update (JAX's
``clip_by_global_norm`` returns it in that dtype), the moments and the new
parameter in float32, cast to the parameter's dtype at the end. The global
norm sums each JAX leaf's squares in JAX's leaf order (the sorted keys, a
stacked leaf's layers in order). ``torch.optim.AdamW`` rounds elsewhere,
so it is not used.

JAX's update is pure; the port's updates the parameters and the state in
place, one parameter at a time, under ``torch.no_grad()`` (plain tensor
ops: the update runs outside any kernel in JAX too). Each parameter is
walked in flat slices of at most ``SLICE`` elements, with up to three
float32 temporaries of one slice's size, never the model's (every
operation after the global norm is elementwise, so the bits are those of
the whole leaf; DeepSeek-V2's expert leaves would otherwise take 15 GB of
temporaries). Fused
multiply-adds (``add_(alpha=)``, ``addcmul_``) may round a last bit apart
from JAX's separate products. A caller that may discard the step (the
trainer's NaN guard) decides before calling it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.spec import jax_key

SLICE = 1 << 28  # elements of a parameter updated at once (1 GiB in float32)


@dataclass(frozen=True)
class AdamWConfig:
    """The optimizer's settings (the JAX package's defaults)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def jax_order(names):
    """``names`` in the JAX package's leaf order: sorted by their JAX keys
    (``spec.jax_key``; a dict's sorted keys at every level), each stacked
    leaf's layers in order."""
    def key(name):
        return (tuple(jax_key(name).split(".")),
                tuple(int(p) for p in name.split(".") if p.isdigit()))

    return sorted(names, key=key)


def adamw_init(params: dict) -> dict:
    """Zero float32 ``m`` and ``v`` for each parameter of ``{name: tensor}``,
    and ``step`` 0."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in params.items()}
    return {"m": zeros, "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``, in float32 (``step`` an integer
    tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


@torch.no_grad()
def global_norm(grads: dict):
    """The float32 L2 norm over every gradient of ``{name: tensor}``, summed
    leaf by leaf in the JAX package's order."""
    total = None
    for k in jax_order(grads):
        sq = torch.sum(torch.square(grads[k].to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """``(grads scaled by min(1, max_norm / max(norm, 1e-9)) in their
    dtypes, norm)``; the gradients are fresh tensors."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}, gn


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2):
    """The update of one parameter (or a slice of one) in place."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.to(torch.float32) * scale  # a fresh float32 tensor
    if g.dtype != torch.float32:  # the clipped gradient in its own dtype
        gf = gf.to(g.dtype).to(torch.float32)
    # b1 m + (1 - b1) g and b2 v + (1 - b2) g^2, in place
    m.mul_(b1).add_(gf, alpha=1 - b1)
    v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
    # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p, in two buffers
    den = torch.div(v, bc2).sqrt_().add_(cfg.eps)
    delta = torch.div(m, bc1, out=gf).div_(den)
    if p.dtype == torch.float32:
        p.sub_(delta.add_(p, alpha=cfg.weight_decay).mul_(lr))
    else:
        pf = p.to(torch.float32)
        p.copy_(pf.sub_(delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt_state):
    """One AdamW step in place on ``{name: tensor}`` parameters and
    gradients: clip the gradients by their global norm, advance ``step``,
    update ``m``, ``v`` and the parameters. Returns ``(params, opt_state,
    {"grad_norm", "lr"})`` (the same objects; the metrics 0-d float32
    tensors)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for k, p in params.items():
        flat = [t.view(-1) for t in (p, grads[k], opt_state["m"][k], opt_state["v"][k])]
        for i in range(0, p.numel(), SLICE):
            _update(cfg, *(t[i:i + SLICE] for t in flat), scale, lr, bc1, bc2)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gn, "lr": lr}
