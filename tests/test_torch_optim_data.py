"""The port's AdamW and synthetic data pipeline against the JAX package's.

AdamW: five steps on a tree of bf16 and float32 leaves with the same
numpy gradients on both sides; float32 leaves (and ``m``, ``v``) within
atol 1e-6 / rtol 1e-6 (the same float32 operations, which XLA may fuse or
reorder by a rounding), bf16 leaves within one bf16 ulp (a float32 a
rounding apart may round to the neighbouring bf16). The data pipeline is
numpy on both sides: batches equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.optim import adamw as TA

torch.set_num_threads(1)

SHAPES = {"attn.wq": ((4, 8), "bfloat16"), "bias": ((16,), "float32"),
          "blocks.0.w": ((3, 5), "bfloat16"), "blocks.1.w": ((3, 5), "bfloat16"),
          "norm.scale": ((7,), "float32")}
JD = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TD = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    ia, ib = (t.view(torch.int16).to(torch.int32) for t in (a, b))
    return int((ia - ib).abs().max())


def _trees(rng):
    arrays = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in SHAPES.items()}
    jt = {k: jnp.asarray(a, JD[SHAPES[k][1]]) for k, a in arrays.items()}
    tt = {k: torch.as_tensor(a).to(TD[SHAPES[k][1]]) for k, a in arrays.items()}
    return jt, tt


@pytest.mark.parametrize("clip", [1.0, 100.0])  # clipping active / inactive
def test_adamw_matches_jax_over_five_steps(clip):
    rng = np.random.default_rng(0)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    jp, tp = _trees(rng)
    jo, to = JA.adamw_init(jp), TA.adamw_init(tp)
    for step in range(5):
        jg, tg = _trees(rng)
        jp, jo, jm = JA.adamw_update(jcfg, jp, jg, jo)
        tp, to, tm = TA.adamw_update(tcfg, tp, tg, to)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        for k, (_, dt) in SHAPES.items():
            got = tp[k]
            assert got.dtype == TD[dt]
            if dt == "bfloat16":
                want = torch.as_tensor(np.array(jp[k].astype(jnp.float32))).to(torch.bfloat16)
                assert _bf16_ulps(got, want) <= 1, (step, k)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
            for mom in ("m", "v"):
                np.testing.assert_allclose(to[mom][k].numpy(), np.asarray(jo[mom][k]),
                                           atol=1e-6, rtol=1e-6)


def test_adamw_slices_equal_the_whole_leaf(monkeypatch):
    """A parameter of more than ``SLICE`` elements is updated in flat slices
    (every operation after the global norm is elementwise): the bits equal
    the whole leaf's update, in bf16 and float32 parameters alike."""
    from repro_torch.optim import adamw as A

    rng = np.random.default_rng(21)
    runs = []
    for limit in (1 << 28, 7):  # whole leaves, then slices of 7 elements
        monkeypatch.setattr(A, "SLICE", limit)
        params = {"a": torch.as_tensor(rng.standard_normal((5, 6)), dtype=torch.bfloat16),
                  "b": torch.as_tensor(rng.standard_normal((3, 4, 2)), dtype=torch.float32)}
        grads = {k: torch.as_tensor(rng.standard_normal(tuple(p.shape)), dtype=p.dtype)
                 for k, p in params.items()}
        rng = np.random.default_rng(21)  # the same draws for both runs
        opt = A.adamw_init(params)
        cfg = A.AdamWConfig(lr=1e-2, warmup_steps=1)
        for _ in range(3):
            A.adamw_update(cfg, params, grads, opt)
        runs.append((params, opt))
    (p0, o0), (p1, o1) = runs
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and p0[k].dtype == p1[k].dtype
        assert torch.equal(o0["m"][k], o1["m"][k]) and torch.equal(o0["v"][k], o1["v"][k])


def test_lr_schedule_and_clip_match_jax():
    cfg_kw = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 80):
        j = JA.lr_schedule(JA.AdamWConfig(**cfg_kw), jnp.asarray(step, jnp.int32))
        t = TA.lr_schedule(TA.AdamWConfig(**cfg_kw), torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    jg, tg = _trees(np.random.default_rng(1))
    jc, jn = JA.clip_by_global_norm(jg, 0.5)
    tc, tn = TA.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        assert tc[k].dtype == tg[k].dtype
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(jc[k].astype(jnp.float32)),
                                   atol=1e-6, rtol=1e-2 if tc[k].dtype == torch.bfloat16 else 1e-6)


def test_jax_leaf_order():
    """The norm's sum runs over JAX's sorted keys, a stack's layers in order."""
    names = ["embed.embedding", "final_norm.scale", "blocks.10.attn.wq", "blocks.2.attn.wq",
             "blocks.2.ln1.scale", "blocks.10.ln1.scale"]
    assert TA.jax_order(names) == [
        "blocks.2.attn.wq", "blocks.10.attn.wq", "blocks.2.ln1.scale", "blocks.10.ln1.scale",
        "embed.embedding", "final_norm.scale"]


def _cfg(**kw):
    base = dict(vocab_size=97, seq_len=16, global_batch=8, seed=3)
    base.update(kw)
    return base


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 1000), shard=st.integers(0, 7), seed=st.integers(0, 2**31))
def test_batches_bit_equal_to_jax(step, shard, seed):
    kw = _cfg(seed=seed)
    a = SyntheticLM(DataConfig(**kw)).batch_for_step(step, shard, 8)
    b = JSyntheticLM(JDataConfig(**kw)).batch_for_step(step, shard, 8)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("modality,extra", [("vision", dict(d_model=32, frontend_tokens=4)),
                                            ("audio", dict(d_model=32))])
def test_modality_stubs_bit_equal_to_jax(modality, extra):
    kw = _cfg(modality=modality, **extra)
    a = SyntheticLM(DataConfig(**kw)).batch_for_step(2, 1, 4)
    b = JSyntheticLM(JDataConfig(**kw)).batch_for_step(2, 1, 4)
    assert a.keys() == b.keys() and len(a) == 4
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# mirrors of tests/test_data.py
def test_steps_differ():
    src = SyntheticLM(DataConfig(**_cfg()))
    assert not np.array_equal(src.batch_for_step(0)["tokens"], src.batch_for_step(1)["tokens"])


def test_shards_differ_and_partition_batch():
    src = SyntheticLM(DataConfig(**_cfg()))
    s0, s1 = src.batch_for_step(5, 0, 4), src.batch_for_step(5, 1, 4)
    assert s0["tokens"].shape[0] == 2
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_targets_are_shifted_tokens():
    b = SyntheticLM(DataConfig(**_cfg())).batch_for_step(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_learnable_structure():
    cfg = DataConfig(**_cfg(noise=0.1))
    src = SyntheticLM(cfg)
    b = src.batch_for_step(0)
    pred = (b["tokens"].astype(np.int64) * src.a + src.b) % cfg.vocab_size
    assert (pred == b["targets"]).mean() > 0.8


def test_prefetcher_orders_and_resumes():
    src = SyntheticLM(DataConfig(**_cfg()))
    pf = Prefetcher(src, start_step=10)
    s0, b0 = pf.get()
    s1, _ = pf.get()
    pf.close()
    assert (s0, s1) == (10, 11)
    np.testing.assert_array_equal(b0["tokens"], src.batch_for_step(10)["tokens"])
    jb = JSyntheticLM(JDataConfig(**_cfg())).batch_for_step(10)
    np.testing.assert_array_equal(b0["tokens"], jb["tokens"])
