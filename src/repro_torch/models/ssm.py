"""Mamba-2 (SSD, state-space duality; arXiv:2405.21060) for the port.

The counterpart of ``repro.models.ssm``: the chunked SSD scan for prefill
(``kernels.ssd``: the CUDA kernel on a card, its plain version on the CPU)
and the O(1)-state recurrent step for decode, which stays plain PyTorch on
both devices, as the JAX package computes it without a kernel. Weights keep
the JAX layouts (``wz`` [d, H, P], ``wo`` [H, P, d]).

The decode step updates its layer's cache in place (the JAX package
returns a new one): ``state`` [B, H, P, N] is overwritten with the new state
after its last read, and each conv prefix [B, W - 1, ...] with its shifted
copy, built as a fresh tensor first so that no copy runs between
overlapping views.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.spec import PSpec


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P_ = cfg.ssm_head_dim
    return d_inner, d_inner // P_, P_, cfg.ssm_state


def ssm_schema(cfg: ModelConfig) -> dict:
    """The mixer's weights, as ``repro.models.ssm.ssm_schema``."""
    d = cfg.d_model
    _, H, P_, N = ssm_dims(cfg)
    W = cfg.ssm_conv_width
    return {
        "wz": PSpec((d, H, P_), ("embed", "ssm_heads", None), init="scaled:0"),
        "wx": PSpec((d, H, P_), ("embed", "ssm_heads", None), init="scaled:0"),
        "wB": PSpec((d, N), ("embed", None), init="scaled:0"),
        "wC": PSpec((d, N), ("embed", None), init="scaled:0"),
        "wdt": PSpec((d, H), ("embed", "ssm_heads"), init="scaled:0"),
        "dt_bias": PSpec((H,), ("ssm_heads",), "float32", "zeros"),
        "A_log": PSpec((H,), ("ssm_heads",), "float32", "zeros"),
        "D": PSpec((H,), ("ssm_heads",), "float32", "ones"),
        "conv_x": PSpec((W, H, P_), (None, "ssm_heads", None), init="normal"),
        "conv_B": PSpec((W, N), (None, None), init="normal"),
        "conv_C": PSpec((W, N), (None, None), init="normal"),
        "norm": PSpec((H, P_), ("ssm_heads", None), "float32", "ones"),
        "wo": PSpec((H, P_, d), ("ssm_heads", None, "embed"), init="scaled:1"),
    }


def _causal_conv(x, kernel, prefix=None):
    """Depthwise causal conv over axis 1, float32 sums, in x's dtype.
    x [B, S, ...ch], kernel [W, ...ch]; prefix [B, W - 1, ...ch] the previous
    raw inputs (decode), else zeros."""
    W, S = kernel.shape[0], x.shape[1]
    if prefix is None:
        xp = F.pad(x, (0, 0) * (x.dim() - 2) + (W - 1, 0))
    else:
        xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for w in range(W):
        out = out + xp[:, w:w + S].to(torch.float32) * kernel[w].to(torch.float32)
    return out.to(x.dtype)


def _heads(u, w):
    """einsum("bsd,dhp->bshp") as one matrix product."""
    d, H, P_ = w.shape
    return (u @ w.reshape(d, H * P_)).reshape(*u.shape[:-1], H, P_)


def _project(p, u):
    """u [B, S, d] -> z, x, Bv, Cv, dt (pre-conv, pre-activation). dt is
    computed in u's dtype and then widened to float32, as in the JAX
    package (bf16 weights round it to bf16 first)."""
    z, x = _heads(u, p["wz"]), _heads(u, p["wx"])
    Bv, Cv = u @ p["wB"], u @ p["wC"]
    dt = (u @ p["wdt"]).to(torch.float32)
    return z, x, Bv, Cv, dt


def _act(v, kernel, prefix, dtype):
    """silu of the causal conv, in float32, rounded to ``dtype``."""
    return F.silu(_causal_conv(v, kernel, prefix).to(torch.float32)).to(dtype)


def _gated_out(p, y, z, eps):
    """Gated RMSNorm (float32) and the output projection. y, z [B, S, H, P]."""
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + eps) * p["norm"]
    H, P_, d = p["wo"].shape
    y = y.to(z.dtype)
    return y.reshape(*y.shape[:-2], H * P_) @ p["wo"].reshape(H * P_, d)


def mamba2_block(p, u, *, cfg: ModelConfig, cache=None, return_cache: bool = False):
    """The Mamba-2 mixer for train / prefill. u [B, S, d].

    cache (optional): {"state": [B, H, P, N] float32, "conv": {"x", "B",
    "C"} raw prefixes}. Returns out [B, S, d], or (out, new_cache) with
    ``return_cache`` (fresh tensors: the final state and the last W - 1
    raw conv inputs)."""
    z, x_raw, B_raw, C_raw, dt = _project(p, u)
    prefix = cache["conv"] if cache is not None else {"x": None, "B": None, "C": None}
    state0 = cache["state"] if cache is not None else None
    x = _act(x_raw, p["conv_x"], prefix["x"], u.dtype)
    Bv = _act(B_raw, p["conv_B"], prefix["B"], u.dtype)
    Cv = _act(C_raw, p["conv_C"], prefix["C"], u.dtype)
    dt = F.softplus(dt + p["dt_bias"])
    y, fstate = ssd_ops.ssd_chunked(x, dt, p["A_log"], Bv, Cv, p["D"], cfg.ssm_chunk,
                                    state0)
    out = _gated_out(p, y, z, cfg.norm_eps)
    if not return_cache:
        return out
    W = cfg.ssm_conv_width

    def tail(prev, raw):  # the last W - 1 raw conv inputs, after prev
        if prev is None:
            prev = torch.zeros(raw.shape[:1] + (W - 1,) + raw.shape[2:], dtype=raw.dtype,
                               device=raw.device)
        return torch.cat([prev.to(raw.dtype), raw], dim=1)[:, -(W - 1):].contiguous()

    return out, {"state": fstate,
                 "conv": {k: tail(prefix[k], raw) for k, raw in
                          (("x", x_raw), ("B", B_raw), ("C", C_raw))}}


def mamba2_decode_step(p, u_t, cache, *, cfg: ModelConfig):
    """One decode step. u_t [B, 1, d]; cache {"state", "conv": {x, B, C}},
    updated in place (see the module docstring). Returns (out [B, 1, d],
    cache)."""
    state, conv = cache["state"], cache["conv"]
    z, x_raw, B_raw, C_raw, dt = _project(p, u_t)
    x = _act(x_raw, p["conv_x"], conv["x"], u_t.dtype)
    Bv = _act(B_raw, p["conv_B"], conv["B"], u_t.dtype)
    Cv = _act(C_raw, p["conv_C"], conv["C"], u_t.dtype)
    dt = F.softplus(dt + p["dt_bias"])  # [B, 1, H]
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = torch.exp(dt[:, 0, :] * A)  # [B, H]
    xf = x.to(torch.float32)[:, 0]  # [B, H, P]
    dB = Bv.to(torch.float32)[:, 0]  # [B, N]
    dC = Cv.to(torch.float32)[:, 0]
    upd = torch.einsum("bhp,bn->bhpn", xf * dt[:, 0, :, None], dB)
    new_state = state * a[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, dC) + xf * p["D"].to(torch.float32)[None, :, None]
    out = _gated_out(p, y[:, None], z, cfg.norm_eps)
    state.copy_(new_state)
    for k, raw in (("x", x_raw), ("B", B_raw), ("C", C_raw)):
        conv[k].copy_(torch.cat([conv[k][:, 1:], raw.to(conv[k].dtype)], dim=1))
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None):
    """One layer's SSM cache of zeros (state + conv prefixes)."""
    _, H, P_, N = ssm_dims(cfg)
    W = cfg.ssm_conv_width
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {"state": z((batch, H, P_, N), torch.float32),
            "conv": {"x": z((batch, W - 1, H, P_), dtype),
                     "B": z((batch, W - 1, N), dtype),
                     "C": z((batch, W - 1, N), dtype)}}
