"""The backward kernels (flash attention's dQ and dK / dV, RMSNorm's dx /
dw, the SSD scan's three) and training on the card, against the plain
versions' autograd (the SSD scan's against its plain backward
``ssd_chunked_bwd_ref``).

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_train.py``.
This file imports neither JAX nor ``repro``. Tolerances (those of
``chip_smoke.py``'s ``kernels_vs_plain_train``): attention gradients
float32 atol / rtol 2e-4 (scores over up to 520 keys and the five products
in another order), bf16 5e-2 (the gradients rounded to bf16 on both sides;
the kernel's Delta from the bf16 output); RMSNorm float32 1e-4 / 1e-5 (dw
sums 2048 rows in another order), bf16 3e-2; the SSD scan's gradients
within 1e-4 of each one's largest value in float32 and 1e-2 in bf16 (the
kernels compute in float32 on the same bf16 inputs and round each gradient
once). Training: a reduced Granite, Mamba-2, Zamba2, Gemma 3, DeepSeek-V2,
SeamlessM4T and Llama-4-Scout trained 3 steps in float32 on the card and on
the CPU from the same parameters, losses within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as trms
from repro_torch.kernels.rmsnorm import rmsnorm as rkern
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.trainer import Trainer, TrainerConfig

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
RMS_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SSD_GRAD_REL = {"float32": 1e-4, "bfloat16": 1e-2}  # of each gradient's largest value


def _card(rng, shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to("cuda", DT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,Dv,window", [
    (2, 512, 512, 24, 8, 128, True, 128, 0),
    (2, 64, 64, 4, 2, 32, True, 32, 0),
    (1, 130, 130, 4, 2, 112, True, 112, 0),
    (2, 65, 65, 4, 4, 64, True, 64, 0),
    (2, 300, 512, 8, 4, 64, False, 64, 0),
    (1, 200, 200, 8, 1, 64, True, 64, 0),  # G = 8: the dK / dV kernel sums eight heads
    (2, 1, 1, 4, 2, 128, True, 128, 0),  # S = 1: one query, one key
    (1, 300, 300, 8, 4, 64, True, 64, 100),  # a window, ragged
    (1, 96, 96, 4, 2, 32, True, 32, 32),
    (1, 200, 200, 4, 2, 128, False, 128, 50),  # a window, not causal
    (1, 600, 600, 8, 4, 256, True, 256, 256),  # Gemma 3's head dim, windowed
    (1, 200, 200, 8, 4, 256, True, 256, 0),  # and global
    (1, 100, 170, 4, 2, 256, False, 256, 0),
    (1, 260, 260, 16, 4, 192, True, 128, 0),  # MLA's head dims, G = 4, ragged
    (1, 130, 70, 4, 4, 192, False, 128, 0),
])
def test_flash_backward_matches_plain(B, Sq, Skv, H, KV, D, causal, Dv, window, dtype):
    rng = np.random.default_rng(11)
    q, k, v, do = (_card(rng, s, dtype) for s in
                   ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv), (B, Sq, H, Dv)))
    before = dict(fkern.LAUNCHES)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tflash.flash_attention(*got, causal=causal, window=window).backward(do)
    assert fkern.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert fkern.LAUNCHES[key] == before[key] + 1
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention_ref(*want, causal=causal, window=window).backward(do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), **ATTN_TOL[dtype])
    out, lse = fkern.flash_attention_cuda(q, k, v, causal=causal, window=window, lse=True)
    runs = [fkern.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal, window=window)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,Dv", [(128, 64), (64, 128), (256, 256), (192, 128)])
def test_flash_lse_refused_outside_backward_dims(D, Dv, dtype):
    """The log-sum-exp is built at the backward kernels' head dims (D = Dv =
    256 and D = 192 with Dv = 128 among them) and refused elsewhere."""
    rng = np.random.default_rng(13)
    q, k, v = (_card(rng, s, dtype) for s in ((1, 64, 2, D), (1, 64, 2, D), (1, 64, 2, Dv)))
    if not fkern.admits_grad(D, Dv):
        with pytest.raises(ValueError, match="log-sum-exp"):
            fkern.flash_attention_cuda(q, k, v, lse=True)
        return
    out, lse = fkern.flash_attention_cuda(q, k, v, lse=True)
    assert torch.equal(out, fkern.flash_attention_cuda(q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    s = s.masked_fill(torch.ones(64, 64, dtype=torch.bool, device="cuda").triu(1), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=2e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(2048, 3072), (5, 3072), (1, 128), (7, 100),
                                 (64, 5120), (3, 32768)])  # rows too wide to hold
def test_rmsnorm_backward_matches_plain(N, d, dtype):
    rng = np.random.default_rng(12)
    x, dy = _card(rng, (N, d), dtype), _card(rng, (N, d), dtype)
    w = 1 + 0.1 * _card(rng, (d,), "float32")
    before = dict(rkern.LAUNCHES)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    trms.rmsnorm(xg, wg, 1e-5).backward(dy)
    assert rkern.LAUNCHES["rmsnorm"] == before["rmsnorm"] + 1
    for key in ("rmsnorm_bwd", "rmsnorm_bwd_dw"):
        assert rkern.LAUNCHES[key] == before[key] + 1
    xp, wp = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    rmsnorm_ref(xp, wp, 1e-5).backward(dy)
    torch.testing.assert_close(xg.grad.float(), xp.grad.float(), **RMS_TOL[dtype])
    torch.testing.assert_close(wg.grad, wp.grad, **RMS_TOL[dtype])
    runs = [rkern.rmsnorm_bwd_cuda(x, w, dy, 1e-5) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_training_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-8b").reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    init = TM.params_to_numpy(cfg, TM.init_params(cfg, device="cpu"))
    hists = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, dcfg, TrainerConfig(steps=3, log_every=0, opt=AdamWConfig(lr=1e-3)),
                     device=dev)

        def init_state(dev=dev):
            p = TM.params_from_numpy(cfg, init, device=dev).float()
            for q in p.parameters():
                q.requires_grad_(True)
            return p, adamw_init(dict(p.named_parameters()))

        tr.init_state = init_state
        before = dict(fkern.LAUNCHES)
        _, _, hists[dev] = tr.run(resume=False)
        if dev == "cuda":
            assert fkern.LAUNCHES["flash_attention_bwd_dq"] - before["flash_attention_bwd_dq"] == 12
    for a, b in zip(hists["cpu"], hists["cuda"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-4)


@pytest.mark.gpu
def test_unembed_gradient_on_card_matches_cpu():
    """The card's bf16 unembedding (``torch.mm`` with a float32 result, no
    autograd of its own) carries the CPU route's gradients: the float32
    output gradient against the other operand widened to float32, rounded
    to bf16 (equal up to float32 sums in another order: bf16 3e-2)."""
    from repro_torch.models.layers import unembed

    rng = np.random.default_rng(13)
    x, E = _card(rng, (2, 8, 64), "bfloat16"), _card(rng, (96, 64), "bfloat16")
    g = _card(rng, (2, 8, 96), "float32")
    grads = []
    for dev in ("cuda", "cpu"):
        xl, El = (t.to(dev).clone().requires_grad_(True) for t in (x, E))
        out = unembed({"embedding": El}, xl)
        assert out.dtype == torch.float32
        out.backward(g.to(dev))
        grads.append((xl.grad.cpu(), El.grad.cpu()))
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), **ATTN_TOL["bfloat16"])


def _ssd_card(rng, B, S, H, P, N, dtype, init, fin):
    """SSD inputs on the card (x, Bv, Cv in ``dtype``), dy and the optional
    entering state and final-state cotangent in float32."""
    f = lambda *sh: _card(rng, sh, "float32")
    x, Bv, Cv = (0.5 * f(*sh) for sh in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.nn.functional.softplus(f(B, S, H))
    A_log, D = 0.2 * f(H), 1 + 0.1 * f(H)
    s0 = 0.5 * f(B, H, P, N) if init else None
    return (x.to(DT[dtype]), dt, A_log, Bv.to(DT[dtype]), Cv.to(DT[dtype]), D, s0,
            f(B, S, H, P), f(B, H, P, N) if fin else None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,init,fin", [
    (2, 96, 3, 16, 8, 32, False, False),
    (2, 100, 3, 16, 16, 32, True, True),  # ragged, an entering state, a final cotangent
    (1, 520, 4, 64, 128, 128, False, True),  # Mamba-2's widths, ragged
    (1, 300, 6, 64, 64, 128, True, False),  # Zamba2's
    (2, 200, 3, 40, 72, 100, False, False),  # off every tile
    (2, 1, 2, 64, 128, 128, False, False),  # S = 1
])
def test_ssd_backward_matches_plain(B, S, H, P, N, chunk, init, fin, dtype):
    rng = np.random.default_rng(14)
    x, dt, A_log, Bv, Cv, D, s0, dy, dfin = _ssd_card(rng, B, S, H, P, N, dtype, init, fin)
    y0, f0 = skern.ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk, s0)
    y, fs, states = skern.ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk, s0, states=True)
    assert torch.equal(y, y0) and torch.equal(fs, f0)  # the STATES instance's outputs
    runs = [skern.ssd_bwd_cuda(x, dt, Bv, Cv, A_log, D, chunk, states, dy, dfin,
                               want_dstate=init) for _ in range(2)]
    want = ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, chunk, s0, dy, dfin)
    for name, got, w in zip(("dx", "ddt", "dA_log", "dBv", "dCv", "dD", "ds0"), runs[0], want):
        if w is None:
            assert got is None
            continue
        assert got.dtype == (x.dtype if name in ("dx", "dBv", "dCv") else torch.float32)
        err = float((got.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err <= SSD_GRAD_REL[dtype], (name, err)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_ssd_chunked_goes_through_the_backward_kernels():
    rng = np.random.default_rng(15)
    x, dt, A_log, Bv, Cv, D, _, dy, _ = _ssd_card(rng, 2, 200, 4, 64, 64, "bfloat16",
                                                  False, False)
    before = dict(skern.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A_log, Bv, Cv, D)]
    y, _ = tssd.ssd_chunked(*leaves, 128)
    y.backward(dy)
    assert {k: skern.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    assert all(t.grad is not None and t.grad.dtype == t.dtype for t in leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_training_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    init = TM.params_to_numpy(cfg, TM.init_params(cfg, device="cpu"))
    hists = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, dcfg, TrainerConfig(steps=3, log_every=0, opt=AdamWConfig(lr=1e-3)),
                     device=dev)

        def init_state(dev=dev):
            p = TM.params_from_numpy(cfg, init, device=dev).float()
            for q in p.parameters():
                q.requires_grad_(True)
            return p, adamw_init(dict(p.named_parameters()))

        tr.init_state = init_state
        before = dict(skern.LAUNCHES)
        _, _, hists[dev] = tr.run(resume=False)
        if dev == "cuda":
            assert skern.LAUNCHES["ssd_bwd_chunk"] - before["ssd_bwd_chunk"] == 3 * cfg.n_layers
    for a, b in zip(hists["cpu"], hists["cuda"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v2-236b", "seamless-m4t-medium",
                                  "llama4-scout-17b-a16e"])
def test_family_training_on_card_matches_cpu(arch):
    """Gemma 3 (windows at D 32 in its reduced config, 128 tokens: past the
    64-token window), DeepSeek-V2 (MLA at D 192 / Dv 128, and MoE), SeamlessM4T (the
    encoder-decoder, with frames) and Llama-4-Scout (MoE) ``reduced()``,
    3 steps in float32 on the card and on the CPU from the same parameters:
    losses and grad norms within rtol 1e-4, and the flash backward launched
    once per attention call a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    if cfg.attn_kind == "mla":  # MLA's own head dims (the reduced 48 / 32 are not built)
        cfg = cfg.replace(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
                      modality=cfg.modality, d_model=cfg.d_model,
                      frontend_tokens=cfg.frontend_tokens)
    init = TM.params_to_numpy(cfg, TM.init_params(cfg, device="cpu"))
    hists = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, dcfg, TrainerConfig(steps=3, log_every=0, opt=AdamWConfig(lr=1e-3)),
                     device=dev)

        def init_state(dev=dev):
            p = TM.params_from_numpy(cfg, init, device=dev).float()
            for q in p.parameters():
                q.requires_grad_(True)
            return p, adamw_init(dict(p.named_parameters()))

        tr.init_state = init_state
        before = dict(fkern.LAUNCHES)
        _, _, hists[dev] = tr.run(resume=False)
        if dev == "cuda":
            calls = (cfg.n_enc_layers + 2 * cfg.n_dec_layers if cfg.family == "encdec"
                     else cfg.n_layers)
            assert fkern.LAUNCHES["flash_attention_bwd_dq"] - before["flash_attention_bwd_dq"] \
                == 3 * calls
    for a, b in zip(hists["cpu"], hists["cuda"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-4)
