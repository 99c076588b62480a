"""Plain PyTorch SSD (state-space duality) scans: the CPU path and the CUDA
kernel's yardstick.

* ``ssd_ref`` is the sequential recurrence of the JAX package's oracle
  (``repro/kernels/ssd/ref.py``), in its ``[BH, S, P]`` layout;
* ``ssd_chunked_ref`` is the chunked algorithm of ``repro.models.ssm.
  ssd_chunked``, the function of the Pallas kernel ``_kernel``
  (``repro/kernels/ssd/ssd.py:21``) with the state carried in and out:
  within a chunk the decay-masked ``C·Bᵀ`` product times x, plus the
  entering state read through C, plus ``D·x``; across chunks the state
  decays by the chunk's total and gains each step's ``dt·B xᵀ``. A ragged
  tail is zero-padded: dt = 0 there gives decay 1 and no contribution, so
  the outputs and the final state are exact.

Everything is computed in float32 whatever the inputs' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_ref(x, dt, Bv, Cv, A_log, D):
    """x [BH, S, P]; dt [BH, S]; Bv, Cv [BH, S, N]; A_log, D [BH]. The
    recurrence one step at a time; y [BH, S, P] in x's dtype."""
    BH, S, P = x.shape
    N = Bv.shape[-1]
    A = -torch.exp(A_log.to(torch.float32))
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Bf, Cf = Bv.to(torch.float32), Cv.to(torch.float32)
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A)  # [BH]
        state = state * a[:, None, None] + torch.einsum(
            "bn,bp->bnp", Bf[:, t], xf[:, t] * dtf[:, t, None])
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], state))
    y = torch.stack(ys, 1) + xf * D.to(torch.float32)[:, None, None]
    return y.to(x.dtype)


def ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk: int, state_init=None):
    """x [B, S, H, P]; dt [B, S, H] (post-softplus); Bv, Cv [B, S, N]
    (shared across heads); A_log, D [H]; state_init [B, H, P, N] float32 or
    None (zeros). Chunks of ``min(chunk, S)`` steps. Returns (y [B, S, H, P]
    float32, final state [B, H, P, N] float32)."""
    Bt, S, H, P = x.shape
    N = Bv.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, pad))
        S += pad
    nC = S // Q

    A = -torch.exp(A_log.to(torch.float32))  # [H]
    xf = x.to(torch.float32).reshape(Bt, nC, Q, H, P)
    dtc = dt.to(torch.float32).reshape(Bt, nC, Q, H)
    Bc = Bv.to(torch.float32).reshape(Bt, nC, Q, N)
    Cc = Cv.to(torch.float32).reshape(Bt, nC, Q, N)

    cs = torch.cumsum(dtc * A, dim=2)  # [b, c, q, h] inclusive log decay
    cs_total = cs[:, :, -1, :]  # [b, c, h]

    # intra-chunk: y[i] = sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) dt_j x_j
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    dec = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [b, c, i, j, h]
    dec = torch.where(causal, torch.exp(torch.where(causal, dec, 0.0)), 0.0)
    M = CB[..., None] * dec * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xf)

    # each chunk's own contribution to the state, then the carry
    w = torch.exp(cs_total[:, :, None, :] - cs) * dtc  # [b, c, q, h]
    S_chunk = torch.einsum("bcjn,bcjhp->bchpn", Bc, xf * w[..., None])
    s = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if state_init is None else state_init.to(torch.float32))
    s_prev = []
    for c in range(nC):
        s_prev.append(s)  # the state entering chunk c
        s = s * torch.exp(cs_total[:, c])[:, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(s_prev, 1)  # [b, c, H, P, N]

    # inter-chunk: the entering state read through C, decayed to step i
    y = y + torch.einsum("bcin,bchpn->bcihp", Cc, S_prev) * torch.exp(cs)[..., None]
    y = y + xf * D.to(torch.float32)[None, None, None, :, None]
    return y.reshape(Bt, S, H, P)[:, :S_orig], s
