"""The bf16 tensor-core SSD backward's arithmetic, emulated in plain PyTorch
on the CPU, against ``jax.vjp`` of the JAX package's
``repro.models.ssm.ssd_chunked``.

The CUDA kernels (``repro_torch/kernels/ssd/csrc/ssd_bwd.cu``,
``ssd_bwd_state_tc_kernel`` and ``ssd_bwd_chunk_tc_kernel``) run only on the
card. Their numerics differ from the plain backward in the operands they
make in float32 and feed to the bf16 tensor cores, each split into bf16 hi
+ bf16 lo: the output gradient dy, the masked products M^T = L dt_j o B C^T
and E^T = L dt_j o x dy^T, the entering state S_prev and the weighted
operands exp(cs) o dy and exp(cs_Q - cs) dt o x; the state's gradient G
enters the chunk pass as bf16 alone. This file repeats the kernels'
arithmetic step by step (up to the order of float32 sums and the last bits
of their exponentials):

* the reverse state scan: G entering a chunk = exp(cs_Q) G + (exp(cs) o
  dy)^T C, the weighted dy split, C exact; <G, S_prev> in float32;
* per (batch, chunk) and group of ``heads`` heads, in the heads' order: the
  first pass Z = (exp(cs) o dy) S_prev (both split; U_i = C_i . Z_i), dC +=
  Z + E B (E = L dt_j o dy x^T, dy split, E split); the second Y = B G^T
  (W_j = exp(cs_Q - cs_j) x_j . Y_j), dx = exp(cs_Q - cs_j) dt_j Y + D dy
  + M^T dy (both split, the lo x lo term dropped), dB += (wq o x) G + E^T C
  (wq o x and E^T split); d cs from the sums of R = L o B C^T o x dy^T, U
  and W; the group's dB and dC float32 partials summed over groups in
  order; dx, dB and dC rounded to bf16 once.

Each gradient is held within ``SSD_GRAD_REL["bfloat16"]`` (1e-2 of its
largest value; ``chip_smoke.py``'s tolerance, unchanged) of ``jax.vjp`` on
the same bf16-representable inputs in float32. Which lo terms the kernels
drop: only G's (``KERNEL_DROPS``), whose loss leaves every reading at least
3x inside the limit (ddt and dA_log move from ~1e-5 to ~1e-4-1e-3; the rest,
~2-3e-3, come from rounding dx, dB and dC to bf16). Dropping dy's, M^T's or
E's lo instead takes some reading past a third of the limit
(``test_dropping_a_kept_lo_term_costs_the_3x_margin``); the lo terms of
S_prev, exp(cs) o dy, wq o x and the state scan's operand feed the [Q x 64
x N] products, not the Q x Q ones, and stay.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS

torch.set_num_threads(1)

SSD_GRAD_REL = 1e-2  # chip_smoke.SSD_GRAD_REL["bfloat16"]
LOG2E = 1.4426950408889634
NAMES = ("dx", "ddt", "dA_log", "dBv", "dCv", "dD", "dstate_init")
TERMS = ("state_lo", "dy_lo", "m_lo", "e_lo", "s_lo", "g_lo", "a_lo")
KERNEL_DROPS = ("g_lo",)  # the lo terms the kernels leave out


def split(v, keep_lo=True):
    """v (float32) as bf16 hi + bf16 lo, in float32 (lo zero unless
    ``keep_lo``)."""
    hi = v.to(torch.bfloat16).float()
    return hi, ((v - hi).to(torch.bfloat16).float() if keep_lo else torch.zeros_like(v))


def bf16(v):
    return v.to(torch.bfloat16).float()


def tensor_core_ssd_bwd(x, dt, A_log, Bv, Cv, D, chunk, states, dy, dfin=None, s0=None,
                        heads=3, drop=KERNEL_DROPS):
    """The kernels' backward: x, Bv, Cv bf16-representable float32 [B, S, H,
    P] / [B, S, N]; dt [B, S, H], A_log, D [H], states [B, nC, H, P, N] (the
    state entering each chunk), dy [B, S, H, P], dfin [B, H, P, N] or None
    float32; ``s0`` only says whether d state_init is wanted; ``heads`` per
    group; ``drop``: lo terms of ``TERMS`` left out. Returns (dx, ddt,
    dA_log, dBv, dCv, dD, dstate_init or None), float32, dx / dB / dC
    rounded to bf16."""
    keep = {t: t not in drop for t in TERMS}
    Bt, S, H, P = x.shape
    N = Bv.shape[-1]
    Q = min(chunk, S)
    nC = -(-S // Q)
    pad = nC * Q - S
    pad4 = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))  # noqa: E731
    xs, dys = pad4(x), pad4(dy)
    dts = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bs, Cs = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bv, Cv))
    A = -torch.exp(A_log)
    i = torch.arange(Q)
    causal = i[:, None] >= i[None, :]  # [i, j]

    def chunk_vals(b, c, h):
        sl = slice(c * Q, (c + 1) * Q)
        dtc = dts[b, sl, h]
        cs = torch.cumsum(dtc * A[h], 0)
        return sl, dtc, cs, cs * LOG2E, torch.exp(cs), torch.exp(cs[-1] - cs)

    # the reverse state scan: G leaving each chunk, <G, S_prev>
    gout = torch.empty(Bt, nC, H, P, N)
    gs = torch.empty(Bt, nC, H)
    ds0 = torch.empty(Bt, H, P, N)
    for b in range(Bt):
        for h in range(H):
            G = torch.zeros(P, N) if dfin is None else dfin[b, h].clone()
            for c in reversed(range(nC)):
                gout[b, c, h] = G
                gs[b, c, h] = (G * states[b, c, h]).sum()
                sl, dtc, cs, _, es, _ = chunk_vals(b, c, h)
                ahi, alo = split(es[:, None] * dys[b, sl, h], keep["state_lo"])
                G = torch.exp(cs[-1]) * G + ahi.T @ Cs[b, sl] + alo.T @ Cs[b, sl]
            ds0[b, h] = G

    dx = torch.empty(Bt, nC * Q, H, P)
    ddt = torch.empty(Bt, nC * Q, H)
    groups = -(-H // heads)
    dBp = torch.zeros(Bt, nC, groups, Q, N)
    dCp = torch.zeros(Bt, nC, groups, Q, N)
    dAp = torch.zeros(Bt, nC, H)
    dDp = torch.zeros(Bt, nC, H)
    for b in range(Bt):
        for c in range(nC):
            sl = slice(c * Q, (c + 1) * Q)
            Bc, Cc = Bs[b, sl], Cs[b, sl]
            BCt = Bc @ Cc.T  # [j, i], head-independent
            for g in range(groups):
                U = {}
                for h in range(g * heads, min(H, (g + 1) * heads)):  # the first pass: dC
                    _, dtc, cs, cs2, es, eq = chunk_vals(b, c, h)
                    xh = xs[b, sl, h]
                    dyh, dyl = split(dys[b, sl, h], keep["dy_lo"])
                    ahi, alo = split(es[:, None] * (dyh + dyl), keep["a_lo"])
                    Shi, Slo = split(states[b, c, h], keep["s_lo"])
                    Z = ahi @ Shi + alo @ Shi + ahi @ Slo  # [i, n]
                    U[h] = (Cc * Z).sum(1)
                    DX = dyh @ xh.T + dyl @ xh.T  # [i, j]
                    L = torch.where(causal, torch.exp2(cs2[:, None] - cs2[None, :]), 0.0)
                    Ehi, Elo = split(L * dtc[None, :] * DX, keep["e_lo"])
                    dCp[b, c, g] += Z + Ehi @ Bc + Elo @ Bc
                for h in range(g * heads, min(H, (g + 1) * heads)):  # the second: dB, dx
                    _, dtc, cs, cs2, es, eq = chunk_vals(b, c, h)
                    wq = eq * dtc
                    xh = xs[b, sl, h]
                    dyh, dyl = split(dys[b, sl, h], keep["dy_lo"])
                    Ghi, Glo = split(gout[b, c, h], keep["g_lo"])
                    Y = Bc @ Ghi.T + Bc @ Glo.T  # [j, p]
                    W = eq * (xh * Y).sum(1)
                    ahi, alo = split(wq[:, None] * xh, keep["a_lo"])
                    dB = ahi @ Ghi + alo @ Ghi + ahi @ Glo
                    DXT = xh @ dyh.T + xh @ dyl.T  # [j, i]
                    Lt = torch.where(causal.T, torch.exp2(cs2[None, :] - cs2[:, None]), 0.0)
                    R = Lt * BCt * DXT
                    rsum = R.sum(1)
                    colT = (R * dtc[:, None]).sum(0)
                    Mhi, Mlo = split(Lt * dtc[:, None] * BCt, keep["m_lo"])
                    Ehi, Elo = split(Lt * dtc[:, None] * DXT, keep["e_lo"])
                    dxh = (wq[:, None] * Y + D[h] * (dyh + dyl)
                           + Mhi @ dyh + Mhi @ dyl + Mlo @ dyh)
                    dB = dB + Ehi @ Cc + Elo @ Cc
                    dBp[b, c, g] += dB
                    dx[b, sl, h] = bf16(dxh)
                    dcs = colT - dtc * rsum + U[h] - W * dtc
                    dcs[-1] += torch.exp(cs[-1]) * gs[b, c, h] + (W * dtc).sum()
                    da = torch.flip(torch.cumsum(torch.flip(dcs, (0,)), 0), (0,))
                    ddt[b, sl, h] = da * A[h] + rsum + W
                    dAp[b, c, h] = (da * dtc).sum() * A[h]
                    dDp[b, c, h] = torch.diagonal(DXT).sum()
    crop = lambda t: t.reshape(Bt, nC * Q, *t.shape[3:])[:, :S]  # noqa: E731
    dB = bf16(crop(dBp.sum(2)))
    dC = bf16(crop(dCp.sum(2)))
    return (dx[:, :S], ddt[:, :S], dAp.sum((0, 1)), dB, dC, dDp.sum((0, 1)),
            None if s0 is None else ds0)


def _inputs(seed, B, S, H, P, N, init, fin):
    """chip_smoke.ssd_bwd_inputs' distributions from numpy: x, B and C
    rounded to bf16 (float32 arrays of bf16 values), dt post-softplus / 4
    (/ 20 with an entering state), A_log, D, the entering state, dy, the
    final state's cotangent. (At chip_smoke's dt, |cs| reaches ~90 within a
    chunk of 128 and JAX's own ddt and dA_log overflow to NaN.)"""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    b = lambda a: bf16(torch.as_tensor(a)).numpy()  # noqa: E731
    x, Bv, Cv = b(f(B, S, H, P) * 0.5), b(f(B, S, N) * 0.5), b(f(B, S, N) * 0.5)
    dt = (np.log1p(np.exp(f(B, S, H))) / (20 if init else 4)).astype(np.float32)
    A_log, D = f(H) * 0.2, np.ones(H, np.float32)
    s0 = f(B, H, P, N) if init else None
    return x, dt, A_log, Bv, Cv, D, s0, f(B, S, H, P), f(B, H, P, N) if fin else None


def _states(x, dt, A_log, Bv, Cv, s0, Q):
    """The state entering each chunk, float32 [B, nC, H, P, N] (the
    forward's ``STATES`` output), from the plain chunked forward."""
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    Bt, S, H, P = x.shape
    nC, out = -(-S // Q), []
    s = None if s0 is None else torch.as_tensor(s0)
    for c in range(nC):
        out.append(torch.zeros(Bt, H, P, Bv.shape[-1]) if s is None else s)
        sl = slice(c * Q, min(S, (c + 1) * Q))
        _, s = ssd_chunked_ref(*(torch.as_tensor(a[:, sl]) for a in (x, dt)),
                               torch.as_tensor(A_log),
                               *(torch.as_tensor(a[:, sl]) for a in (Bv, Cv)),
                               torch.zeros(H), Q, s)
    return torch.stack(out, 1)


def readings(B, S, H, P, N, init, fin, heads, drop=KERNEL_DROPS, seed=0):
    """Each gradient's max |emulated - jax.vjp| / max |jax.vjp|."""
    Q = 128
    x, dt, A_log, Bv, Cv, D, s0, dy, dfin = _inputs(seed + S + N, B, S, H, P, N, init, fin)

    def grads(dy, dfin, *primals):  # jitted: op by op, the vjp takes seconds
        def f(x, dt, A_log, Bv, Cv, D, *s):
            return JS.ssd_chunked(x, dt, A_log, Bv, Cv, D, Q, state_init=s[0] if s else None)

        (_, fs), vjp = jax.vjp(f, *primals)
        return vjp((dy, jnp.zeros_like(fs) if dfin is None else dfin))

    primals = [jnp.asarray(a) for a in (x, dt, A_log, Bv, Cv, D)] + (
        [jnp.asarray(s0)] if init else [])
    want = jax.jit(grads)(jnp.asarray(dy), None if dfin is None else jnp.asarray(dfin),
                          *primals)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    got = tensor_core_ssd_bwd(*map(t, (x, dt, A_log, Bv, Cv, D)), Q,
                              _states(x, dt, A_log, Bv, Cv, s0, Q), t(dy), t(dfin), t(s0),
                              heads=heads, drop=drop)
    out = {}
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        out[name] = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
    return out


# (B, S, H, P, N, init, fin, heads): Q 128 at S 256 and a ragged S, H not a
# multiple of the group, an entering state and a final-state cotangent, N 64
# (Zamba2) and 128 (Mamba-2)
CASES = [
    (1, 256, 5, 64, 128, False, False, 2),
    (1, 300, 4, 64, 64, False, True, 3),
    (2, 200, 3, 64, 128, True, True, 2),
    (1, 256, 7, 64, 64, True, False, 4),
]


@pytest.mark.parametrize("B,S,H,P,N,init,fin,heads", CASES)
def test_tensor_core_bwd_arithmetic_matches_jax_vjp(B, S, H, P, N, init, fin, heads):
    got = readings(B, S, H, P, N, init, fin, heads)
    assert (got["dstate_init"] is not None) if init else True
    for name, err in got.items():
        assert err <= SSD_GRAD_REL, (name, err, got)


@pytest.mark.parametrize("term,case", [
    ("dy_lo", (1, 256, 4, 64, 64, True, True, 3, 0)),
    ("m_lo", (1, 256, 4, 64, 64, True, True, 3, 0)),
    ("e_lo", (1, 256, 4, 64, 128, False, False, 2, 0)),
])
def test_dropping_a_kept_lo_term_costs_the_3x_margin(term, case):
    *shape, seed = case
    kept = max(readings(*shape, seed=seed).values())
    dropped = max(readings(*shape, drop=KERNEL_DROPS + (term,), seed=seed).values())
    assert kept <= SSD_GRAD_REL / 3 < dropped, (term, kept, dropped)
