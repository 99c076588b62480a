"""Deterministic, resumable, shard-aware synthetic LM data pipeline.

A copy of the JAX package's ``repro.data.pipeline`` (pure numpy; the port
imports nothing of that package): the same numpy Philox stream gives the
same batches, bit for bit.

Stateless in (seed, step, shard): any host can regenerate any batch — exact
resume after restart/elastic reshape needs no data-state checkpointing.
Tokens follow a noisy affine bigram process so models have real structure to
learn (loss decreases), plus a prefetch thread for input overlap.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of random tokens
    modality: str = "text"  # "text" | "vision" | "audio"
    d_model: int = 0  # for stub frontends
    frontend_tokens: int = 0


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(cfg.seed), counter=[step, shard, 0, 0])
    )


class SyntheticLM:
    """batch_for_step(step, shard, n_shards) -> dict of numpy arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        self.a = 6364136223846793005 % v or 1
        self.b = 1442695040888963407 % v

    def batch_for_step(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        b_local = cfg.global_batch // n_shards
        rng = _rng(cfg, step, shard)
        v = cfg.vocab_size
        first = rng.integers(0, v, size=(b_local, 1), dtype=np.int64)
        toks = np.empty((b_local, cfg.seq_len + 1), np.int64)
        toks[:, :1] = first
        noise_mask = rng.random((b_local, cfg.seq_len)) < cfg.noise
        noise_vals = rng.integers(0, v, size=(b_local, cfg.seq_len), dtype=np.int64)
        for t in range(cfg.seq_len):
            nxt = (toks[:, t] * self.a + self.b) % v
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_vals[:, t], nxt)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((b_local, cfg.seq_len), np.float32),
        }
        if cfg.modality == "vision" and cfg.frontend_tokens:
            batch["patch_embeds"] = rng.standard_normal(
                (b_local, cfg.frontend_tokens, cfg.d_model), np.float32
            ).astype(np.float32)
        if cfg.modality == "audio":
            s_enc = cfg.seq_len
            batch["frames"] = rng.standard_normal(
                (b_local, s_enc, cfg.d_model), np.float32
            ).astype(np.float32)
        return batch


class Prefetcher:
    """Background-thread prefetch of upcoming steps (input/compute overlap)."""

    def __init__(self, source: SyntheticLM, start_step: int, shard: int = 0,
                 n_shards: int = 1, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self.shard, self.n_shards = shard, n_shards
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            b = self.source.batch_for_step(self._next, self.shard, self.n_shards)
            step = self._next
            self._next += 1
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
