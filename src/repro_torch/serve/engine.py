"""Batched serving engine: prefill + decode with KV / SSM-state caches
(and an encoder-decoder's cross-attention caches).

The counterpart of ``repro.serve.engine``: a batch of requests is
prefilled together (right-padded to a power of two of at least 8 tokens),
then decoded step by step with per-slot completion tracking (EOS / max
tokens); finished slots keep their tokens frozen until the batch drains.
As in the JAX engine, the pad tokens are prefilled too: attention masks
them by the cache length, but an SSM layer's state and conv prefix absorb
the pads of every prompt shorter than the batch's padded length, so a
short prompt's tokens after the first follow that state. The front ends
are stubs, as in the JAX engine: an encoder-decoder is fed zero frames
[B, S, d] (so its encoder runs over S positions), a vision model zero
patch embeddings for its first ``min(frontend_tokens, S)`` slots.
Greedy, or temperature sampling from a ``torch.Generator`` seeded by
``ServeConfig.seed`` (its draws differ from ``jax.random``'s). Runs on a
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclass(frozen=True)
class ServeConfig:
    """Generation settings of one engine."""

    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1 = never
    seed: int = 0


def pad_prompts(prompts: list[list[int]], device):
    """Right-pad ``prompts`` to one power-of-two length of at least 8.
    Returns (tokens [B, S] int64, lengths [B] int32) on ``device``."""
    S = max(len(p) for p in prompts)
    S = max(8, 1 << (S - 1).bit_length())
    toks = np.zeros((len(prompts), S), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return torch.as_tensor(toks, device=device), torch.as_tensor(lens, device=device)


def frontend_stub(cfg: ModelConfig, B: int, S: int, device) -> dict:
    """The batch entries the JAX engine feeds a model's front end for a
    batch of B prompts padded to S: bf16 zeros, ``frames`` [B, S, d] for an
    encoder-decoder, ``patch_embeds`` [B, min(frontend_tokens, S), d] for a
    vision model; none for a text model."""
    shapes = {}
    if cfg.family == "encdec":
        shapes["frames"] = (B, S, cfg.d_model)
    if cfg.modality == "vision" and cfg.frontend_tokens:
        shapes["patch_embeds"] = (B, min(cfg.frontend_tokens, S), cfg.d_model)
    return {k: torch.zeros(sh, dtype=torch.bfloat16, device=device) for k, sh in shapes.items()}


class Engine:
    """Prefill a batch of prompts together, then decode it step by step."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig | None = None,
                 device=None):
        self.device = resolve_device(device)
        M.check_supported(cfg)
        where = next(params.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg or ServeConfig()

    @torch.no_grad()
    def generate(self, prompts: list[list[int]]) -> list[list[int]]:
        """Up to ``max_new_tokens`` tokens for each prompt."""
        cfg, scfg = self.cfg, self.scfg
        toks, lens = pad_prompts(prompts, self.device)
        B, S = toks.shape
        batch = {"tokens": toks, **frontend_stub(cfg, B, S, self.device)}
        logits, cache = M.prefill(cfg, self.params, batch, pad_to=S + scfg.max_new_tokens + 1)
        # per-slot position = prompt length: padding beyond it is masked by
        # the cache-length check and progressively overwritten during decode
        cache["len"] = lens
        # the last *valid* logit per slot
        last_logits = logits[torch.arange(B, device=self.device), lens.long() - 1]

        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        done = np.zeros((B,), bool)
        outs: list[list[int]] = [[] for _ in range(B)]
        cur = self._sample(last_logits, gen)
        for step in range(scfg.max_new_tokens):
            cur_host = cur.cpu().numpy()
            for i in range(B):
                if not done[i]:
                    outs[i].append(int(cur_host[i]))
                    if scfg.eos_id >= 0 and int(cur_host[i]) == scfg.eos_id:
                        done[i] = True
            # the last token needs no decode step after it
            if done.all() or step == scfg.max_new_tokens - 1:
                break
            logits, cache = M.decode_step(cfg, self.params, cache, cur[:, None])
            cur = self._sample(logits[:, 0], gen)
        return outs

    def _sample(self, logits, gen):
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
