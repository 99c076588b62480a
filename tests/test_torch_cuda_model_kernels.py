"""The CUDA flash-attention and RMSNorm kernels against their plain PyTorch
versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_model_kernels.py``.
This file imports neither JAX nor ``repro``. Tolerances: float32 atol
2e-5 / rtol 1e-5 for RMSNorm (one row sum in another order) and 1e-4 /
1e-4 for attention (exp and row sums of up to 520 keys in another order);
bfloat16 3e-2, as ``tests/test_kernels.py`` (one bf16 rounding of outputs
of size ~1, where the two sides may round a float32 a ulp apart).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rkern
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
RMS_TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _card(rng, shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.as_tensor(rng.standard_normal(shape, np.float32)).to("cuda", DT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,Dv,causal", [
    (1, 128, 2, 2, 64, 64, True),
    (2, 256, 4, 2, 64, 64, True),
    (1, 128, 8, 1, 32, 32, True),  # MQA
    (1, 520, 24, 8, 128, 128, True),  # ragged last tile
    (2, 200, 4, 2, 128, 64, True),  # Dv != D
    (1, 96, 4, 4, 32, 128, False),
])
def test_flash_attention_kernel_matches_plain(B, S, H, KV, D, Dv, causal, dtype):
    rng = np.random.default_rng(S + D + Dv)
    q = _card(rng, (B, S, H, D), dtype)
    k = _card(rng, (B, S, KV, D), dtype)
    v = _card(rng, (B, S, KV, Dv), dtype)
    before = fkern.LAUNCHES["flash_attention"]
    got = fkern.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fkern.LAUNCHES["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(4, 3072), (2048, 3072), (64, 128), (3, 100)])
def test_rmsnorm_kernels_match_plain(N, d, dtype):
    """Both variants; d = 100 takes the scalar (non-vector) path."""
    rng = np.random.default_rng(N + d)
    x = _card(rng, (N, d), dtype)
    r = _card(rng, (N, d), dtype)
    w = torch.as_tensor(rng.standard_normal(d, np.float32) * 0.1 + 1, device="cuda")
    before = dict(rkern.LAUNCHES)
    out = rkern.rmsnorm_cuda(x, w, 1e-5)
    out_r, res = rkern.rmsnorm_cuda(x, w, 1e-5, res2=r)
    torch.cuda.synchronize()
    assert rkern.LAUNCHES == {k: v + 1 for k, v in before.items()}
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(), **RMS_TOL[dtype])
    want_out, want_res = rmsnorm_residual_ref(x, r, w)
    torch.testing.assert_close(out_r.float(), want_out.float(), **RMS_TOL[dtype])
    torch.testing.assert_close(res.float(), want_res.float(), **RMS_TOL[dtype])
