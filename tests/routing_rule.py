"""The routing rule that holds a MoE model on the port to the JAX package:
each JAX MoE layer's routing recorded (its ``moe_block`` wrapped through
``monkeypatch``), and the two sides' routings compared.

Rounding may send a token whose top-k / top-(k + 1) router margin is tiny
to another expert, and that token's output then differs by far more than
the bf16 tolerance. In float32 every MoE layer must route every token
alike. In bf16 a position routed differently in some layer must have had a
router margin below ``MARGIN_BOUND`` in the first layer where it differs,
and at most ``MAX_FLIP_SHARE`` of the positions may be; the caller then
compares logits only at the positions routed alike in every layer.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import moe as JMOE

MAX_FLIP_SHARE = 0.05  # bf16: positions that may route differently in some layer
MARGIN_BOUND = 1e-2  # bf16: a router margin below it is a near-tie


def record_jax_routing(monkeypatch):
    """Each JAX MoE layer's top-k expert ids [T, k] (sorted per token), in
    call order: the JAX package's ``moe_block`` wrapped to recompute its
    float32 routing from the same input and send it to the host."""
    rec = []
    moe_block = JMOE.moe_block

    def recorded(p, x, *, cfg, rt):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, e = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1), cfg.moe_top_k)
        jax.debug.callback(lambda e: rec.append(np.sort(np.asarray(e), -1)), e, ordered=True)
        return moe_block(p, x, cfg=cfg, rt=rt)

    monkeypatch.setattr(JMOE, "moe_block", recorded)
    return rec


def agreed(port_routing, jax_routing, n_layers, dtype):
    """Per position (token), whether every MoE layer routed it alike on
    both sides; float32 demands all, bf16 at most ``MAX_FLIP_SHARE`` not.
    ``port_routing``: the port's ``(top_e, margin)`` records
    (``torch_routing.record_routing``), ``n_layers`` per call, as
    ``jax_routing``'s arrays. ``None`` for a model without MoE layers."""
    jax.effects_barrier()  # every recorded callback has run
    assert len(port_routing) == len(jax_routing)
    if not port_routing:
        return None
    got = np.stack([np.sort(e.numpy(), -1) for e, _ in port_routing])
    want = np.stack(jax_routing)
    T = got.shape[1]
    same = (got == want).all(-1).reshape(-1, n_layers, T)  # [calls, layers, T]
    agree = same.all(1)  # [calls, T]
    if dtype == "float32":
        assert agree.all(), f"float32 routing differs at {np.argwhere(~agree).tolist()}"
        return agree
    margin = np.stack([m.numpy() for _, m in port_routing]).reshape(-1, n_layers, T)
    near = int((margin < MARGIN_BOUND).sum())
    call, tok = np.nonzero(~agree)
    first = np.argmin(same[call, :, tok], axis=1)  # the first layer that differs
    assert (margin[call, first, tok] < MARGIN_BOUND).all(), (
        f"a position routed differently at a margin of {margin[call, first, tok].max()}")
    assert 1 - agree.mean() <= MAX_FLIP_SHARE, (
        f"{(~agree).sum()} of {agree.size} positions routed differently; "
        f"{near} layer decisions below a margin of {MARGIN_BOUND}")
    return agree
