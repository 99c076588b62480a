"""The port's MoE layer and a MoE model on the card against the CPU.

These tests need a CUDA device and skip without one; run them on the GPU
host with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_moe.py``.
This file imports neither JAX nor ``repro``. The grouped product is
``torch._grouped_mm`` with the group offsets on the device, on the card
and on the CPU. Inputs from numpy, weights from a seeded generator on the
CPU, copied to the card; routing recorded by ``torch_routing``.

* ``moe_block`` (``llama4-scout-17b-a16e`` and ``deepseek-v2-236b``
  reduced, TF32 off): routing equal in float32 and the output within
  atol / rtol 1e-5 (float32 sums in another order); bf16 within 3e-2 on
  tokens routed alike, a token routed differently only at a router margin
  below 1e-2; ``dropped_frac`` equal at capacity factor 0.25;
* the router's float32 product is the same whatever float32 precision the
  process sets (the port sets "highest" for that product), and the
  process's setting is restored exactly;
* no host synchronisation inside the layer in its serving dtypes (bf16,
  the router float32; ``torch.cuda.set_sync_debug_mode``). PyTorch's
  float32 grouped product is a fallback that reads the offsets: only the
  float32 checks take it.
* ``forward`` of ``llama4-scout-17b-a16e`` reduced in float32: routing
  equal in every layer, logits within 1e-4 (the flash kernel's float32
  attention, ``tests/test_torch_cuda_model_kernels.py``'s tolerance),
  the summed aux within 1e-5;
* ``deepseek-v2-236b`` reduced at MLA's serving head dims (D = 192, Dv =
  128) in float32: forward, prefill and decode steps, routing equal and
  logits and the compressed cache within 1e-4.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.spec import init_tree
from torch_routing import record_routing, route

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MARGIN_BOUND = 1e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _moe_case(arch, dtype, S=64):
    cfg = get_config(arch).reduced()
    p = init_tree(TMOE.moe_schema(cfg), torch.Generator().manual_seed(0), "cpu")
    if dtype == "float32":
        p = p.float()
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model), np.float32)).to(DT[dtype])
    return cfg, p, x


def _run(p, x, cfg, cf, device):
    p, x = copy.deepcopy(p).to(device), x.to(device)
    out, aux = TMOE.moe_block(p, x, cfg=cfg, capacity_factor=cf)
    e, m = route(p, x, cfg.moe_top_k)
    return out.cpu(), {k: float(v) for k, v in aux.items()}, np.sort(e.numpy(), -1), m.numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [2.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
def test_moe_block_on_card_matches_cpu(arch, dtype, cf):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _moe_case(arch, dtype)
    got, aux_g, e_g, _ = _run(p, x, cfg, cf, "cuda")
    want, aux_w, e_w, margin = _run(p, x, cfg, cf, "cpu")
    agree = (e_g == e_w).all(-1)
    if dtype == "float32":
        assert agree.all()
        tol = dict(atol=1e-5, rtol=1e-5)
        assert aux_g["dropped_frac"] == aux_w["dropped_frac"]
    else:
        assert (margin[~agree] < MARGIN_BOUND).all()
        assert agree.mean() >= 0.95
        tol = dict(atol=3e-2, rtol=3e-2)
    assert got.dtype == x.dtype
    g = got.float().reshape(-1, cfg.d_model)[torch.as_tensor(agree)]
    w = want.float().reshape(-1, cfg.d_model)[torch.as_tensor(agree)]
    np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)
    for key in ("lb_loss", "router_z"):
        assert abs(aux_g[key] - aux_w[key]) <= (1e-5 if dtype == "float32" else 1e-2), key


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["high", "medium", "tf32_flag"])
def test_router_logits_ignore_tf32(precision):
    """The process allows TF32 (``"high"``, or the legacy flag) or bf16
    (``"medium"``) for float32 products: the router's product equals the
    full float32 one, and the process's precision is the same after."""
    _need_card()
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((512, 5120), np.float32)).cuda()
    router = torch.as_tensor(rng.standard_normal((5120, 16), np.float32)).cuda() / 70
    torch.set_float32_matmul_precision("highest")
    want = TMOE.router_logits(x, router)
    if precision == "tf32_flag":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision(precision)
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        got = TMOE.router_logits(x, router)
        after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert before[1] and after == before
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 512])
def test_moe_block_does_not_synchronise(S):
    """Prefill- and decode-sized inputs: no host read inside the layer."""
    _need_card()
    cfg, p, x = _moe_case("llama4-scout-17b-a16e", "bfloat16", S=S)
    p, x = p.to("cuda"), x.to("cuda")
    TMOE.moe_block(p, x, cfg=cfg)  # first call: any one-time set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = TMOE.moe_block(p, x, cfg=cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out.float()).all()) and float(aux["dropped_frac"]) == 0.0


@pytest.mark.gpu
def test_moe_forward_on_card_matches_cpu(monkeypatch):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").float()
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 96)))
    rec = record_routing(monkeypatch)
    lw, _, aux_w = TM.forward(cfg, p, {"tokens": toks})
    r_cpu = rec[:]
    rec.clear()
    lg, _, aux_g = TM.forward(cfg, p.to("cuda"), {"tokens": toks.cuda()})
    r_gpu = rec[:]
    assert len(r_cpu) == len(r_gpu) == cfg.n_layers
    for (eg, _), (ew, _) in zip(r_gpu, r_cpu):
        np.testing.assert_array_equal(np.sort(eg.numpy(), -1), np.sort(ew.numpy(), -1))
    np.testing.assert_allclose(lg.cpu().numpy(), lw.numpy(), atol=1e-4, rtol=1e-4)
    for key in aux_w:
        assert abs(float(aux_g[key]) - float(aux_w[key])) <= 1e-5, key


@pytest.mark.gpu
def test_mla_moe_model_on_card_matches_cpu(monkeypatch):
    """DeepSeek-V2 reduced at MLA's serving head dims (D = 128 + 64 rotary
    columns = 192, Dv = 128: the flash kernel's MLA instance) in float32:
    forward, then a prefill and three decode steps through the compressed
    cache; routing equal in every layer and call, logits within 1e-4."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-236b").reduced().replace(
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").float()
    pg = copy.deepcopy(p).to("cuda")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 99)))
    rec = record_routing(monkeypatch)

    def run(params, t):
        out = [TM.forward(cfg, params, {"tokens": t[:, :96]})[0]]
        logits, cache = TM.prefill(cfg, params, {"tokens": t[:, :96]}, pad_to=99)
        out.append(logits)
        for i in range(96, 99):
            logits, cache = TM.decode_step(cfg, params, cache, t[:, i:i + 1])
            out.append(logits)
        return [o.cpu() for o in out], cache

    want, cache_w = run(p, toks)
    r_cpu = rec[:]
    rec.clear()
    got, cache_g = run(pg, toks.cuda())
    assert len(rec) == len(r_cpu) == 5 * (cfg.n_layers - cfg.first_k_dense)
    for (eg, _), (ew, _) in zip(rec, r_cpu):
        np.testing.assert_array_equal(np.sort(eg.numpy(), -1), np.sort(ew.numpy(), -1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)
    for stack in ("dense_blocks", "blocks"):
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(cache_g[stack][key].cpu().numpy(),
                                       cache_w[stack][key].numpy(), atol=1e-4, rtol=1e-4)
