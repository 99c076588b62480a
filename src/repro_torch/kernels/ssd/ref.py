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
  the outputs and the final state are exact;
* ``ssd_chunked_bwd_ref`` is its gradient, written as the backward
  kernels' passes (``csrc/ssd_bwd.cu``): the states entering each chunk,
  a reverse scan over chunks that carries the state's gradient G, then a
  pass per chunk for dx, dt, B, C (summed over heads), A_log and D.

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


def ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, chunk: int, state_init, dy,
                        d_final_state=None):
    """The gradients of ``ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk,
    state_init)`` for the cotangents ``dy`` [B, S, H, P] of y and
    ``d_final_state`` [B, H, P, N] (None: zero) of the final state.

    Per chunk, with cs the inclusive cumsum of dt A and L_ij = exp(cs_i -
    cs_j) for j <= i (else 0):

    * G, the gradient of the state leaving a chunk: ``d_final_state`` for
      the last; G entering chunk c is ``exp(cs_Q) G + sum_i exp(cs_i) dy_i
      C_i^T``, and entering chunk 0 it is d state_init;
    * dx_j = sum_i L_ij dt_j (C_i . B_j) dy_i + D dy_j + exp(cs_Q - cs_j)
      dt_j G B_j;
    * dC_i = sum_h [sum_j E_ij B_j + exp(cs_i) dy_i^T S_prev] and dB_j =
      sum_h [sum_i E_ij C_i + exp(cs_Q - cs_j) dt_j x_j^T G], E_ij = L_ij
      dt_j (dy_i . x_j);
    * d cs from every exponential, summed backward over the chunk into
      d(dt A): ddt gets it times A beside its direct terms, and dA_log =
      sum d(dt A) dt A;
    * dD = sum dy . x.

    Positions past S count as dt = 0 and their gradients are dropped.
    Returns float32 (dx, ddt, dA_log, dBv, dCv, dD, dstate_init), the last
    None when ``state_init`` is None."""
    Bt, S, H, P = x.shape
    N = Bv.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt, Bv, Cv = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bv, Cv))
        S += pad
    nC = S // Q
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))  # [H]
    xf = x.to(f32).reshape(Bt, nC, Q, H, P)
    dyf = dy.to(f32).reshape(Bt, nC, Q, H, P)
    dtc = dt.to(f32).reshape(Bt, nC, Q, H)
    Bc = Bv.to(f32).reshape(Bt, nC, Q, N)
    Cc = Cv.to(f32).reshape(Bt, nC, Q, N)
    cs = torch.cumsum(dtc * A, dim=2)  # [b, c, q, h]
    cs_tot = cs[:, :, -1, :]  # [b, c, h]
    es = torch.exp(cs)  # exp(cs_i)
    wq = torch.exp(cs_tot[:, :, None, :] - cs) * dtc  # exp(cs_Q - cs_j) dt_j

    # the forward's states entering each chunk
    S_chunk = torch.einsum("bcjn,bcjhp->bchpn", Bc, xf * wq[..., None])
    s = (torch.zeros((Bt, H, P, N), dtype=f32, device=x.device)
         if state_init is None else state_init.to(f32))
    s_prev = []
    for c in range(nC):
        s_prev.append(s)
        s = s * torch.exp(cs_tot[:, c])[:, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(s_prev, 1)  # [b, c, H, P, N]

    # the reverse scan: G leaving each chunk
    G = (torch.zeros((Bt, H, P, N), dtype=f32, device=x.device)
         if d_final_state is None else d_final_state.to(f32))
    gain = torch.einsum("bcihp,bcin->bchpn", dyf * es[..., None], Cc)
    g_out = [None] * nC
    for c in reversed(range(nC)):
        g_out[c] = G
        G = G * torch.exp(cs_tot[:, c])[:, :, None, None] + gain[:, c]
    G_out = torch.stack(g_out, 1)  # [b, c, H, P, N]

    # the pass per chunk
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    dec = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [b, c, i, j, h]
    L = torch.where(causal, torch.exp(torch.where(causal, dec, 0.0)), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    DX = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dtj = dtc[:, :, None, :, :]
    R = L * CB * DX  # d y_i . (M_ij x_j) / d dt_j
    E = L * dtj * DX
    T = R * dtj  # d cs_i (+) and d cs_j (-) of the intra-chunk decay
    dx = (torch.einsum("bcijh,bcihp->bcjhp", L * dtj * CB, dyf)
          + dyf * D.to(f32)[:, None]
          + wq[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, G_out))
    Z = torch.einsum("bcihp,bchpn->bcihn", dyf, S_prev)  # dy_i^T S_prev
    Y = torch.einsum("bcjhp,bchpn->bcjhn", xf, G_out)  # x_j^T G
    dC = (torch.einsum("bcijh,bcjn->bcin", E, Bc)
          + torch.einsum("bcih,bcihn->bcin", es, Z))
    dB = (torch.einsum("bcijh,bcin->bcjn", E, Cc)
          + torch.einsum("bcjh,bcjhn->bcjn", wq, Y))
    U = es * torch.einsum("bcin,bcihn->bcih", Cc, Z)  # d cs_i of the inter term
    W = torch.exp(cs_tot[:, :, None, :] - cs) * torch.einsum("bcjn,bcjhn->bcjh", Bc, Y)
    dcs = T.sum(3) - T.sum(2) + U - W * dtc
    dcs_tot = (torch.exp(cs_tot) * (G_out * S_prev).sum((3, 4))
               + (W * dtc).sum(2))  # [b, c, h]
    dcs[:, :, -1] += dcs_tot
    da = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), 2), (2,))  # d(dt A)
    ddt = R.sum(2) + W + da * A
    dA_log = (da * dtc).sum((0, 1, 2)) * A
    dD = (dyf * xf).sum((0, 1, 2, 4))
    crop = lambda t, *rest: t.reshape(Bt, S, *rest)[:, :S_orig]
    return (crop(dx, H, P), crop(ddt, H), dA_log, crop(dB, N), crop(dC, N), dD,
            None if state_init is None else G)
