"""The backward kernels (flash attention's dQ and dK / dV, RMSNorm's dx /
dw) and training on the card, against the plain versions' autograd.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_train.py``.
This file imports neither JAX nor ``repro``. Tolerances (those of
``chip_smoke.py``'s ``kernels_vs_plain_train``): attention gradients
float32 atol / rtol 2e-4 (scores over up to 520 keys and the five products
in another order), bf16 5e-2 (the gradients rounded to bf16 on both sides;
the kernel's Delta from the bf16 output); RMSNorm float32 1e-4 / 1e-5 (dw
sums 2048 rows in another order), bf16 3e-2. Training: a reduced Granite
trained 3 steps in float32 on the card and on the CPU from the same
parameters, losses within rtol 1e-4.
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
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.trainer import Trainer, TrainerConfig

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
RMS_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _card(rng, shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to("cuda", DT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal", [
    (2, 512, 512, 24, 8, 128, True),
    (2, 64, 64, 4, 2, 32, True),
    (1, 130, 130, 4, 2, 112, True),
    (2, 65, 65, 4, 4, 64, True),
    (2, 300, 512, 8, 4, 64, False),
    (1, 200, 200, 8, 1, 64, True),  # G = 8: the dK / dV kernel sums eight heads
    (2, 1, 1, 4, 2, 128, True),  # S = 1: one query, one key
])
def test_flash_backward_matches_plain(B, Sq, Skv, H, KV, D, causal, dtype):
    rng = np.random.default_rng(11)
    q, k, v, do = (_card(rng, s, dtype) for s in
                   ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D)))
    before = dict(fkern.LAUNCHES)
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tflash.flash_attention(*got, causal=causal).backward(do)
    assert fkern.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert fkern.LAUNCHES[key] == before[key] + 1
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention_ref(*want, causal=causal).backward(do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), **ATTN_TOL[dtype])
    out, lse = fkern.flash_attention_cuda(q, k, v, causal=causal, lse=True)
    runs = [fkern.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,Dv", [(128, 64), (64, 128), (256, 256), (192, 128)])
def test_flash_lse_refused_outside_backward_dims(D, Dv, dtype):
    rng = np.random.default_rng(13)
    q, k, v = (_card(rng, s, dtype) for s in ((1, 64, 2, D), (1, 64, 2, D), (1, 64, 2, Dv)))
    with pytest.raises(ValueError, match="log-sum-exp"):
        fkern.flash_attention_cuda(q, k, v, lse=True)


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
