"""Qwen2-VL (M-RoPE, vision stub) and SeamlessM4T (encoder-decoder) on the
card against the CPU.

These tests need a CUDA device and skip without one; run them on the GPU
host with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_models.py``.
This file imports neither JAX nor ``repro``: the CPU runs the kernels'
plain versions, the card the flash-attention and RMSNorm kernels. Both
models are ``reduced()`` in depth and width but at their serving head
dims, which the flash kernel is built for: Qwen2-VL's D = 128 with M-RoPE
sections (16, 24, 24), SeamlessM4T's D = 64 with as many KV heads as query
heads. Weights from a seeded generator on the CPU, widened to float32 and
copied to the card, TF32 off; logits and caches within atol / rtol 1e-4
(the flash kernel's float32 tolerance in
``tests/test_torch_cuda_model_kernels.py``), engine tokens equal.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.rmsnorm import rmsnorm as rkern
from repro_torch.models import model as TM
from repro_torch.serve import Engine, ServeConfig

TOL = dict(atol=1e-4, rtol=1e-4)


def _models(cfg):
    """(CPU params, card params) of ``cfg`` in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").float()
    return p, copy.deepcopy(p).to("cuda")


def _run(cfg, params, batch, S, n, toks):
    """forward, then a prefill of S tokens and ``n`` decode steps fed
    ``toks``'s next tokens. Returns (logits on the CPU, the last cache)."""
    out = [TM.forward(cfg, params, batch)[0]]
    logits, cache = TM.prefill(cfg, params, batch, pad_to=S + n)
    out.append(logits)
    for i in range(S, S + n):
        logits, cache = TM.decode_step(cfg, params, cache, toks[:, i:i + 1])
        out.append(logits)
    return [o.cpu() for o in out], cache


def _on_card_matches_cpu(cfg, extra, S=96, n=3):
    """The model on the card against the CPU on one batch (``extra``: the
    front-end stub's entries, built on the CPU); the card's path launches
    each kernel. Returns both caches."""
    p, pg = _models(cfg)
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S + n)))
    want, cache_w = _run(cfg, p, {"tokens": toks[:, :S], **extra}, S, n, toks)
    before = (fkern.LAUNCHES["flash_attention"], rkern.LAUNCHES["rmsnorm"])
    toks_g = toks.cuda()
    got, cache_g = _run(cfg, pg, {"tokens": toks_g[:, :S],
                                  **{k: v.cuda() for k, v in extra.items()}}, S, n, toks_g)
    assert fkern.LAUNCHES["flash_attention"] > before[0]
    assert rkern.LAUNCHES["rmsnorm"] > before[1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    prompts = [toks[0, :50].tolist(), toks[1, :S].tolist()]
    scfg = ServeConfig(max_new_tokens=4)
    assert Engine(cfg, pg, scfg=scfg).generate(prompts) == \
        Engine(cfg, p, scfg=scfg, device="cpu").generate(prompts)
    return cache_w, cache_g


@pytest.mark.gpu
def test_qwen2_vl_on_card_matches_cpu():
    """Qwen2-VL reduced at D = 128: random patch embeddings in the 16
    patch slots, forward, prefill and 3 decode steps (M-RoPE's grid, then
    text positions), the K/V caches."""
    cfg = get_config("qwen2-vl-72b").reduced().replace(head_dim=128,
                                                        mrope_sections=(16, 24, 24))
    pe = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model), np.float32))
    cache_w, cache_g = _on_card_matches_cpu(cfg, {"patch_embeds": pe})
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_g["blocks"][key].cpu().numpy(),
                                   cache_w["blocks"][key].numpy(), **TOL)


@pytest.mark.gpu
def test_seamless_on_card_matches_cpu():
    """SeamlessM4T reduced at D = 64, 4 heads of their own: random frames
    (S_enc 80 != S_dec 96), forward, prefill and 3 decode steps (the
    cross-attention over the cached ``ck`` / ``cv``), every cache leaf."""
    cfg = get_config("seamless-m4t-medium").reduced().replace(head_dim=64, n_kv_heads=4)
    frames = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (2, 80, cfg.d_model), np.float32))
    cache_w, cache_g = _on_card_matches_cpu(cfg, {"frames": frames})
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(cache_g["dec_blocks"][key].cpu().numpy(),
                                   cache_w["dec_blocks"][key].numpy(), **TOL)
    np.testing.assert_allclose(cache_g["enc_out"].cpu().numpy(), cache_w["enc_out"].numpy(),
                               **TOL)
