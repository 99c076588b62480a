"""The CUDA flash-attention, RMSNorm and SSD kernels against their plain
PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_model_kernels.py``.
This file imports neither JAX nor ``repro``. Tolerances: float32 atol
2e-5 / rtol 1e-5 for RMSNorm (one row sum in another order) and 1e-4 /
1e-4 for attention (exp and row sums of up to 520 keys in another order);
bfloat16 3e-2, as ``tests/test_kernels.py`` (one bf16 rounding of outputs
of size ~1, where the two sides may round a float32 a ulp apart; the
tensor-core attention kernel also rounds P to bf16 before ``P V``, which
``test_torch_flash_tensorcore_numerics.py`` holds to the same tolerance
on the CPU). The SSD
kernel's y and final state are float32 whatever x's dtype, so both dtypes
take the float32 tolerance of the ``test_ssd_sweep`` (atol / rtol 1e-3:
sums of up to Q * N products in another order, over up to five chunks; in
bf16 the tensor-core kernel's float32 operands go in as two bf16 terms,
which ``test_torch_ssd_tensorcore_numerics.py`` holds to the same
tolerance on the CPU).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rkern
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
RMS_TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _card(rng, shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions' float32 einsums in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
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
    (4, 512, 32, 32, 112, 112, True),  # Zamba2's shared attention
    (4, 512, 40, 8, 128, 128, True),  # Llama-4-Scout's query-head groups of 5
    (4, 512, 64, 8, 128, 128, True),  # Qwen2-VL's query-head groups of 8
    (4, 512, 16, 16, 64, 64, False),  # SeamlessM4T's encoder and cross-attention
    (4, 512, 16, 16, 64, 64, True),  # SeamlessM4T's decoder self-attention
])
def test_flash_attention_kernel_matches_plain(B, S, H, KV, D, Dv, causal, dtype):
    _flash_matches_plain(B, S, H, KV, D, Dv, causal, dtype)


def _flash_matches_plain(B, S, H, KV, D, Dv, causal, dtype, window=0):
    rng = np.random.default_rng(S + D + Dv + window)
    q = _card(rng, (B, S, H, D), dtype)
    k = _card(rng, (B, S, KV, D), dtype)
    v = _card(rng, (B, S, KV, Dv), dtype)
    keep = [t.clone() for t in (q, k, v)]
    before = fkern.LAUNCHES["flash_attention"]
    got = fkern.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fkern.LAUNCHES["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(keep, (q, k, v)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (4, 2048, 8, 4, 256, True, 1024),  # Gemma 3's local layers
    (2, 300, 4, 2, 256, True, 40),  # a window below one tile, ragged S
    (2, 520, 4, 2, 128, True, 100),  # not a multiple of 64
    (1, 257, 4, 2, 64, True, 64),
    (2, 200, 4, 2, 64, False, 48),  # non-causal: only the left edge
    (1, 130, 2, 2, 32, True, 1),  # every row sees itself alone
])
def test_flash_attention_kernel_window(B, S, H, KV, D, causal, window, dtype):
    """The sliding-window mode: skipped and masked key tiles, and rows
    that see no key of the first tiles they visit."""
    _flash_matches_plain(B, S, H, KV, D, D, causal, dtype, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 100, 2048])
def test_flash_attention_kernel_d256(S, dtype):
    """D = Dv = 256 without a window (Gemma 3's global layers at S 2048):
    a warpgroup a half in bf16, 209 KB of shared memory in float32."""
    _flash_matches_plain(4 if S == 2048 else 2, S, 8, 4, 256, 256, True, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129])
def test_flash_attention_kernel_partial_tiles(S, dtype):
    """Single-row, just-short, exact and just-over 64-row tiles."""
    _flash_matches_plain(2, S, 4, 2, 64, 64, True, dtype)


# every head dim the kernel is built for, in pairs or alone
DIMS = sorted({*fkern.HEAD_DIMS, *(d for pair in fkern.PAIRS for d in pair)})


@pytest.mark.gpu
@pytest.mark.parametrize("Dv", DIMS)
@pytest.mark.parametrize("D", DIMS)
def test_flash_attention_kernel_head_dims(D, Dv):
    """Every (D, Dv) the wrapper admits, in bf16 (the tensor-core kernel);
    non-causal where D < Dv, so (32, 128) runs non-causal and (128, 64)
    causal. A pair with 192 or 256 but not (192, 128) or (256, 256) is
    refused."""
    if not fkern.admits(D, Dv):
        _refused(D, Dv)
        return
    _flash_matches_plain(1, 100, 4, 2, D, Dv, D >= Dv, "bfloat16")


def _refused(D, Dv, dtype="bfloat16"):
    rng = np.random.default_rng(D + Dv)
    q, k = _card(rng, (1, 8, 2, D), dtype), _card(rng, (1, 8, 2, D), dtype)
    before = fkern.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dims"):
        fkern.flash_attention_cuda(q, k, _card(rng, (1, 8, 2, Dv), dtype))
    assert fkern.LAUNCHES["flash_attention"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H", [(4, 512, 128), (2, 520, 16), (2, 1, 16), (1, 100, 4)])
def test_flash_attention_kernel_mla(B, S, H, dtype):
    """MLA's prefill attention (DeepSeek-V2): D = 192 (128 columns without
    and 64 with the rotary embedding), Dv = 128, as many KV heads as query
    heads; at its serve shape, a ragged last tile and a single row."""
    _flash_matches_plain(B, S, H, H, 192, 128, True, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_refuses_mla_reduced_dims(dtype):
    """MLA ``reduced()`` (D = 32 + 16, Dv = 32) is not built: the launch
    raises, and nothing falls back to the plain version."""
    _refused(48, 32, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_sq_ne_skv(causal):
    """Fewer queries than keys (top-left aligned causal mask)."""
    rng = np.random.default_rng(70 + causal)
    q = _card(rng, (2, 70, 4, 128), "bfloat16")
    k = _card(rng, (2, 130, 2, 128), "bfloat16")
    v = _card(rng, (2, 130, 2, 128), "bfloat16")
    got = fkern.flash_attention_cuda(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(512, 512), (300, 512), (512, 300), (1, 512)])
def test_flash_attention_kernel_cross_attention(Sq, Skv, dtype):
    """SeamlessM4T's cross-attention (16 heads, each its own KV head, D =
    64), non-causal: decoder and encoder of one length, a ragged decoder
    shorter than the encoder, one longer, a single query row."""
    rng = np.random.default_rng(Sq + Skv)
    q = _card(rng, (2, Sq, 16, 64), dtype)
    k, v = (_card(rng, (2, Skv, 16, 64), dtype) for _ in range(2))
    keep = [t.clone() for t in (q, k, v)]
    got = fkern.flash_attention_cuda(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(keep, (q, k, v)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(4, 3072), (2048, 3072), (4, 5120), (2048, 5120),
                                 (4, 8192), (2048, 8192), (4, 1024), (2048, 1024),
                                 (64, 128), (3, 100)])
def test_rmsnorm_kernels_match_plain(N, d, dtype):
    """Both variants; d = 100 takes the scalar (non-vector) path."""
    _rmsnorm_matches_plain(N, d, 0, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d,w_offset", [
    (1, 768, 0), (5, 768, 0), (2047, 768, 0),  # Mamba-2's width
    (1, 3584, 0), (5, 3584, 0), (2047, 3584, 0),  # Zamba2's width
    (5, 3072, 1), (2047, 768, 1),  # a weight at an odd element offset
])
def test_rmsnorm_kernels_edges(N, d, w_offset, dtype):
    """N in {1, 5, 2047} are off the rows-per-CTA grid; a weight that
    starts at an odd element offset (4-byte, not 16-byte, aligned) takes
    the scalar (non-vector) path."""
    _rmsnorm_matches_plain(N, d, w_offset, dtype)


def _rmsnorm_matches_plain(N, d, w_offset, dtype):
    rng = np.random.default_rng(N + d)
    x = _card(rng, (N, d), dtype)
    r = _card(rng, (N, d), dtype)
    w = torch.as_tensor(rng.standard_normal(d + w_offset, np.float32) * 0.1 + 1,
                        device="cuda")[w_offset:]
    keep = [t.clone() for t in (x, r, w)]
    before = dict(rkern.LAUNCHES)
    out = rkern.rmsnorm_cuda(x, w, 1e-5)
    out_r, res = rkern.rmsnorm_cuda(x, w, 1e-5, res2=r)
    torch.cuda.synchronize()
    # one launch of each forward variant; the backward's counters untouched
    assert rkern.LAUNCHES == {**before, "rmsnorm": before["rmsnorm"] + 1,
                              "rmsnorm_residual": before["rmsnorm_residual"] + 1}
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(), **RMS_TOL[dtype])
    want_out, want_res = rmsnorm_residual_ref(x, r, w)
    torch.testing.assert_close(out_r.float(), want_out.float(), **RMS_TOL[dtype])
    torch.testing.assert_close(res.float(), want_res.float(), **RMS_TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(keep, (x, r, w)))


SSD_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", [
    (1, 64, 2, 16, 8, 16, False),  # the test_ssd_sweep shapes
    (2, 128, 3, 16, 8, 32, False),
    (1, 128, 1, 32, 16, 64, False),
    (4, 512, 24, 64, 128, 128, False),  # Mamba-2's serve path
    (4, 512, 112, 64, 64, 128, False),  # Zamba2's serve path
    (2, 520, 24, 64, 128, 128, False),  # a ragged last chunk
    (2, 40, 3, 8, 4, 16, True),  # an entering state, ragged, dt / 20
    (1, 300, 3, 40, 72, 100, False),  # Q, P and N off the tiles: zero padding
    (2, 128, 4, 64, 16, 128, False),  # N 16
    (2, 130, 4, 64, 4, 128, False),  # N 4 (unaligned rows: element-wise staging)
    (2, 1, 4, 64, 128, 128, False),  # S 1
])
def test_ssd_kernel_matches_plain(B, S, H, P, N, chunk, init, dtype):
    rng = np.random.default_rng(S + H + N)
    x = _card(rng, (B, S, H, P), dtype) * 0.5
    dt = torch.nn.functional.softplus(_card(rng, (B, S, H), "float32"))
    if init:  # small steps, so that the entering state survives 40 of them
        dt = dt / 20
    Bv, Cv = _card(rng, (B, S, N), dtype) * 0.5, _card(rng, (B, S, N), dtype) * 0.5
    A_log = _card(rng, (H,), "float32") * 0.2
    D = torch.ones(H, device="cuda")
    s0 = _card(rng, (B, H, P, N), "float32") if init else None
    keep = [t.clone() for t in (x, dt, Bv, Cv, A_log, D)]
    before = skern.LAUNCHES["ssd"]
    y, st = skern.ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk, s0)
    torch.cuda.synchronize()
    assert skern.LAUNCHES["ssd"] == before + 1
    want_y, want_s = ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk, s0)
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(st, want_s, **SSD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(keep, (x, dt, Bv, Cv, A_log, D)))
