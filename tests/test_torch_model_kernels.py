"""The port's plain flash attention and RMSNorm against the JAX package's
Pallas kernels (interpret mode), at the sweep shapes and tolerances of
``tests/test_kernels.py``: float32 atol 2e-5 / rtol 1e-5 (sums in another
order), bfloat16 3e-2 (one bf16 rounding of the output, plus the inputs'
rounding carried through the float32 arithmetic).

Inputs are made with numpy from a seed and rounded to bf16 the same way on
both sides (round to nearest even from float32). On the CPU the port's
entry points (``kernels.*.ops``) run their plain versions, which the CUDA
kernels are held against on the card (``test_torch_cuda_model_kernels.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.kernels.rmsnorm.ops import rmsnorm_residual as jrmsnorm_residual
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rmsnorm import ops as trms

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,Dv,bq,bk", [
    (1, 128, 2, 2, 64, 64, 64, 64),
    (2, 256, 4, 2, 64, 64, 128, 64),
    (1, 128, 8, 1, 32, 32, 32, 32),  # MQA
    (1, 100, 4, 2, 64, 64, 128, 128),  # one ragged tile (the kernel masks it)
    (2, 64, 4, 4, 64, 32, 32, 32),  # Dv != D
])
def test_flash_attention_matches_pallas(B, S, H, KV, D, Dv, bq, bk, dtype):
    rng = np.random.default_rng(S + H + D + Dv)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, Dv), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jflash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    got = tflash.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, Dv)
    _close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(64, 128), (256, 384), (32, 1024)])
def test_rmsnorm_matches_pallas(N, d, dtype):
    rng = np.random.default_rng(N + d)
    x = rng.standard_normal((N, d), np.float32)
    w = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jrmsnorm(jx, jnp.asarray(w), interpret=True)
    got = trms.rmsnorm(tx, torch.as_tensor(w))
    assert got.dtype == tx.dtype
    _close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(64, 256), (4, 3072)])
def test_rmsnorm_residual_matches_pallas(N, d, dtype):
    rng = np.random.default_rng(N * d)
    x = rng.standard_normal((N, d), np.float32)
    r = rng.standard_normal((N, d), np.float32)
    w = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    (jx, tx), (jr, tr) = _pair(x, dtype), _pair(r, dtype)
    want_out, want_res = jrmsnorm_residual(jx, jr, jnp.asarray(w), interpret=True)
    got_out, got_res = trms.rmsnorm_residual(tx, tr, torch.as_tensor(w))
    _close(want_out, got_out, dtype)
    _close(want_res, got_res, dtype)


def test_rmsnorm_over_leading_dims():
    """[B, S, d] activations go through as [B * S, d] rows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    want = jrmsnorm(jx, jnp.asarray(w), interpret=True)
    got = trms.rmsnorm(tx, torch.as_tensor(w))
    assert tuple(got.shape) == (2, 5, 64)
    _close(want, got, "bfloat16")
