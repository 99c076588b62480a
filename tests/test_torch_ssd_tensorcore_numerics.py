"""The bf16 tensor-core SSD kernel's arithmetic, emulated in plain PyTorch
on the CPU, against the JAX package's Pallas kernel in interpret mode and
JAX ``repro.models.ssm.ssd_chunked``.

The CUDA kernel (``repro_torch/kernels/ssd/csrc/ssd.cu``, ``ssd_tc_kernel``)
runs only on the card. Its numerics differ from the plain version in the
operands it makes in float32 and feeds to the bf16 tensor cores: the masked
decay matrix M, the entering state S_prev and the weighted x w of the state
update each go in as bf16 hi + bf16 lo, two products into one float32
accumulator. This file repeats the kernel's arithmetic step by step (up to
the order of float32 sums and the last bits of its exponentials), so that
the difference is held to the unchanged tolerance before any chip time:
bf16 x, B and C; per chunk, in order, the float32 cumsum cs of dt A; the
decays exp2(cs_i log2 e - cs_j log2 e) dt_j on and above the 64 x 64 block
diagonal and exp2(cs_i log2 e - cs_63 log2 e) exp2((cs_63 - cs_j) log2 e)
dt_j below it; M = (C B^T) o decay split into hi + lo; y = M x +
exp(cs_i) C S_prev (S_prev split) + D x; the state exp(cs_last) S_prev +
(x w)^T B (x w split), w_j = exp(cs_last - cs_j) dt_j. One (batch, head)
per CTA, as the kernel: no head grouping. The emulation lives here, not in
the package.

Tolerance: ``SSD_TOL`` of ``test_torch_cuda_model_kernels.py`` and
``chip_smoke.py`` (atol = rtol = 1e-3), unchanged. The references take the
same bf16-representable values in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as jssd
from repro.models.ssm import ssd_chunked as jssd_chunked

torch.set_num_threads(1)

SSD_TOL = dict(atol=1e-3, rtol=1e-3)
LOG2E = 1.4426950408889634
BLOCK = 64  # the kernel's 64 x 64 blocks of C B^T


def split(v, lo=True):
    """v (float32) as bf16 hi + bf16 lo, returned in float32 (lo dropped
    when ``lo`` is False: one bf16 rounding)."""
    hi = v.to(torch.bfloat16).float()
    if not lo:
        return hi, torch.zeros_like(v)
    return hi, (v - hi).to(torch.bfloat16).float()


def tensor_core_ssd(x, dt, A_log, Bv, Cv, D, chunk, state_init=None, lo=True):
    """bf16 x [B, S, H, P], Bv, Cv [B, S, N]; float32 dt [B, S, H], A_log,
    D [H], state_init [B, H, P, N] or None -> (y [B, S, H, P], final state
    [B, H, P, N]), float32, computed as the tensor-core kernel computes
    them (``lo=False``: each split operand rounded to bf16 once)."""
    Bt, S, H, P = x.shape
    N = Bv.shape[-1]
    Q = min(chunk, S)
    nC = -(-S // Q)
    pad = nC * Q - S  # past S: zeros, dt = 0
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    dtp = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).permute(0, 2, 1)  # [B, H, S]
    Bf = torch.nn.functional.pad(Bv.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cv.float(), (0, 0, 0, pad))
    A = -torch.exp(A_log.float())[None, :, None]
    Dh = D.float()[None, :, None, None]
    st = (torch.zeros(Bt, H, P, N) if state_init is None else state_init.float().clone())
    i = torch.arange(Q)
    causal = i[:, None] >= i[None, :]
    ys = []
    for c in range(nC):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, Bc, Cc = xf[:, :, sl], dtp[:, :, sl], Bf[:, sl], Cf[:, sl]
        cs = torch.cumsum(dtc * A, dim=-1)  # [B, H, Q]
        cs2 = cs * LOG2E
        last = cs[..., -1:]
        # the decay as two factors, applied to C B^T in this order
        f1 = torch.exp2(cs2[..., :, None] - cs2[..., None, :])
        f2 = dtc[..., None, :].expand(-1, -1, Q, -1)
        if Q > BLOCK:  # below the block diagonal: each factor at most 1
            f1 = f1.clone()
            f2 = f2.clone()
            f1[..., BLOCK:, :BLOCK] = torch.exp2(cs2[..., BLOCK:, None] - cs2[..., BLOCK - 1, None, None])
            f2[..., BLOCK:, :BLOCK] = (torch.exp2((cs[..., BLOCK - 1, None] - cs[..., :BLOCK]) * LOG2E)
                                       * dtc[..., :BLOCK])[..., None, :]
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)[:, None]
        M = torch.where(causal, CB * f1 * f2, torch.zeros(()))
        Mhi, Mlo = split(M, lo)
        y = Mhi @ xc + Mlo @ xc
        Shi, Slo = split(st, lo)
        z = (torch.einsum("bin,bhpn->bhip", Cc, Shi) + torch.einsum("bin,bhpn->bhip", Cc, Slo))
        y = y + torch.exp(cs)[..., None] * z + Dh * xc
        ys.append(y)
        w = torch.exp(last - cs) * dtc
        xwhi, xwlo = split(xc * w[..., None], lo)
        st = (st * torch.exp(last)[..., None]
              + torch.einsum("bhjp,bjn->bhpn", xwhi, Bc) + torch.einsum("bhjp,bjn->bhpn", xwlo, Bc))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S]
    return y, st


def _inputs(seed, B, S, H, P, N, init=False):
    """chip_smoke.ssd_inputs' distributions from numpy: x, B and C rounded
    to bf16 (float32 arrays of bf16 values), dt post-softplus (/ 20 with an
    entering state, so that it survives the chunks), A_log, D, state."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    x = bf(rng.standard_normal((B, S, H, P), np.float32) * 0.5)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), np.float32))) / (20 if init else 1)
    Bv = bf(rng.standard_normal((B, S, N), np.float32) * 0.5)
    Cv = bf(rng.standard_normal((B, S, N), np.float32) * 0.5)
    A_log = rng.standard_normal(H, np.float32) * 0.2
    D = np.ones(H, np.float32)
    s0 = rng.standard_normal((B, H, P, N), np.float32) if init else None
    return x, dt.astype(np.float32), Bv, Cv, A_log, D, s0


def _emulate(x, dt, Bv, Cv, A_log, D, chunk, s0=None, lo=True):
    b16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    return tensor_core_ssd(b16(x), torch.as_tensor(dt), torch.as_tensor(A_log), b16(Bv),
                           b16(Cv), torch.as_tensor(D), chunk,
                           None if s0 is None else torch.as_tensor(s0), lo=lo)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),  # tests/test_kernels.py::test_ssd_sweep's shapes
    (2, 128, 3, 16, 8, 32),
    (1, 128, 1, 32, 16, 64),
])
def test_tensor_core_arithmetic_matches_pallas(B, S, H, P, N, chunk):
    x, dt, Bv, Cv, A_log, D, _ = _inputs(S + H + N, B, S, H, P, N)
    want = jssd(*map(jnp.asarray, (x, dt, Bv, Cv, A_log, D)), chunk=chunk, interpret=True)
    y, _ = _emulate(x, dt, Bv, Cv, A_log, D, chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **SSD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", [
    (1, 256, 4, 64, 128, 128, False),  # Mamba-2's widths, two chunks
    (1, 520, 4, 64, 128, 128, False),  # a ragged last chunk
    (1, 256, 4, 64, 64, 128, False),  # Zamba2's widths
    (1, 520, 4, 64, 64, 128, False),
    (1, 100, 4, 16, 16, 32, False),  # the reduced() configs' N 16, P 16, Q 32; ragged
    (2, 200, 4, 64, 128, 128, True),  # an entering state
])
def test_tensor_core_arithmetic_matches_ssd_chunked(B, S, H, P, N, chunk, init):
    x, dt, Bv, Cv, A_log, D, s0 = _inputs(S + N + init, B, S, H, P, N, init)
    args = [jnp.asarray(a) for a in (x, dt, A_log, Bv, Cv, D)]
    yj, sj = jssd_chunked(*args, chunk, None if s0 is None else jnp.asarray(s0))
    y, st = _emulate(x, dt, Bv, Cv, A_log, D, chunk, s0)
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **SSD_TOL)


def test_one_bf16_rounding_misses_the_tolerance():
    """Why the kernel splits: with each float32 operand rounded to bf16 once
    (lo dropped), the same arithmetic leaves the tolerance at Mamba-2's
    widths, while hi + lo stays within it."""
    x, dt, Bv, Cv, A_log, D, _ = _inputs(7, 1, 256, 4, 64, 128)
    args = [jnp.asarray(a) for a in (x, dt, A_log, Bv, Cv, D)]
    yj = np.asarray(jssd_chunked(*args, 128)[0])
    once, _ = _emulate(x, dt, Bv, Cv, A_log, D, 128, lo=False)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(once.numpy(), yj, **SSD_TOL)
    split_y, _ = _emulate(x, dt, Bv, Cv, A_log, D, 128)
    np.testing.assert_allclose(split_y.numpy(), yj, **SSD_TOL)
