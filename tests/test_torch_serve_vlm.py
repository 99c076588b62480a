"""The port's M-RoPE and vision stub (Qwen2-VL) against the JAX package.

``qwen2-vl-72b`` ``reduced()`` (4 layers, d 128, 4 heads, 2 KV heads of
32, M-RoPE sections (8, 4, 4) of the 16 frequency slots, 16 patch slots on
a 4 x 4 grid), with the JAX-initialised weights carried across by
``models.model.params_from_numpy``. JAX runs ``Runtime(attn_impl="flash",
block_q=64, block_k=64)``; the port's prefill takes
``kernels.flash_attention`` (the plain version on the CPU). The batch
carries random ``patch_embeds`` in the weights' dtype (the port casts them
to it; JAX would promote a float32 stub against bf16 weights to a float32
residual stream).

The rotary quirk of the JAX package is reproduced, not fixed: the prefill
lays out ``P = min(frontend_tokens, S)`` patch slots on a grid of
``floor(sqrt(P))`` columns, but decode rotates by ``pos - frontend_tokens
+ floor(sqrt(frontend_tokens))``, so a batch padded to fewer than
``frontend_tokens`` tokens decodes at positions that do not continue the
prefill's.

Tolerances as ``tests/test_torch_serve.py``: ``apply_mrope`` alone within
1e-6 (float32 angles, ``cos`` / ``sin`` of two libraries); float32 weights
within atol and rtol 1e-5, bfloat16 within 3e-2 (the two frameworks round
bf16 intermediates at other places); greedy tokens compared in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime import default_runtime
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _flat(tree):
    """A JAX tree as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)), **TOL[dtype])


# ----------------------------------------------------------------------
# M-RoPE alone
# ----------------------------------------------------------------------
@pytest.mark.parametrize("D,sections", [(32, (8, 4, 4)), (128, (16, 24, 24)),
                                        (32, (4, 4, 4)), (32, (8, 8, 8))],
                         ids=["reduced", "full", "short", "long"])
def test_apply_mrope_matches_jax(D, sections):
    """Random [B, S, 3] positions (and the grid layout) at the reduced and
    the full sections, and sections that fall short of (the last id
    repeated) or overrun (cut) the D/2 slots, as ``jnp.repeat`` with
    ``total_repeat_length``: float32 within 1e-6."""
    rng = np.random.default_rng(D + sum(sections))
    x = rng.standard_normal((2, 40, 3, D), np.float32)
    for pos in (rng.integers(0, 5000, (2, 40, 3)).astype(np.int32),
                np.array(JM._mrope_positions(jax_get_config(ARCH).reduced(), 2, 40))):
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
        got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections, 1e6)
        assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = TL.apply_mrope(torch.as_tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                         torch.as_tensor(pos), sections, 1e6)
    assert got.dtype == torch.bfloat16
    _close(JL.apply_mrope(xb, jnp.asarray(pos), sections, 1e6), got, "bfloat16")


@pytest.mark.parametrize("S", [8, 16, 17, 40])
def test_mrope_positions_match_jax(S):
    """The grid of the leading min(16, S) patch slots, then text; and the
    default [B, S, 3] positions, t == h == w."""
    cfg_j, cfg_t = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    got = TM._mrope_positions(cfg_t, 2, S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM._mrope_positions(cfg_j, 2, S)))
    np.testing.assert_array_equal(TL.positions_for(cfg_t, (2, S)).numpy(),
                                  np.asarray(JL.positions_for(cfg_j, (2, S))))


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax_get_config(ARCH).reduced(), jax.random.key(0))


def _setup(jax_params, dtype, **replace):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    cfg_j = jax_get_config(ARCH).reduced().replace(**replace)
    cfg_t = get_config(ARCH).reduced().replace(**replace)
    pt = TM.params_from_numpy(cfg_t, _flat(jax_params), device="cpu")
    pj = jax_params
    if dtype == "float32":
        pj, pt = jax.tree.map(lambda a: a.astype(jnp.float32), pj), pt.float()
    return cfg_j, pj, cfg_t, pt


def _batches(cfg, B, S, dtype, n_extra=0, seed=1, patches=None):
    """(JAX batch, port batch, the tokens [B, S + n_extra]): random tokens
    and ``patches`` (default ``min(frontend_tokens, S)``) random patch
    embeddings in ``dtype``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + n_extra)).astype(np.int32)
    P = min(cfg.frontend_tokens, S) if patches is None else patches
    pe = np.array(jnp.asarray(rng.standard_normal((B, P, cfg.d_model), np.float32),
                              DTYPES[dtype][0]).astype(jnp.float32))
    bj = {"tokens": jnp.asarray(toks[:, :S]), "patch_embeds": jnp.asarray(pe, DTYPES[dtype][0])}
    bt = {"tokens": torch.as_tensor(toks[:, :S]).long(),
          "patch_embeds": torch.as_tensor(pe).to(DTYPES[dtype][1])}
    return bj, bt, toks


def test_schema_and_params_mirror_jax(jax_params):
    """``patch_proj`` [d, d] beside the blocks: every leaf has the JAX
    pytree's shape; a missing ``patch_proj`` is refused."""
    cfg = get_config(ARCH).reduced()
    flat = _flat(jax_params)
    pt = TM.params_from_numpy(cfg, flat, device="cpu")
    assert tuple(pt["patch_proj"].shape) == (128, 128)
    np.testing.assert_array_equal(pt["patch_proj"].float().numpy(), flat["patch_proj"])
    with pytest.raises(KeyError, match="patch_proj"):
        TM.params_from_numpy(cfg, {k: v for k, v in flat.items() if k != "patch_proj"},
                             device="cpu")
    assert "patch_proj" not in TM.param_schema(cfg.replace(modality="text"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,patches", [(40, 16), (320, 16), (40, 7)])
def test_forward_matches_jax(jax_params, S, patches, dtype):
    """Random patch embeddings in the first 16 slots (7: fewer than the
    grid's, the rest text embeddings at grid positions), 40 tokens and 320
    (JAX's blocked flash path)."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    bj, bt, _ = _batches(cfg_j, 2, S, dtype, patches=patches)
    lj, _, _ = JM.forward(cfg_j, pj, bj, RT_JAX, mode="train")
    lt, caches, _ = TM.forward(cfg_t, pt, bt)
    assert lt.dtype == torch.float32 and caches is None
    _close(lj, lt, dtype)
    # the stub moves the logits: the patch slots are not the tokens' embeddings
    lt_text, _, _ = TM.forward(cfg_t, pt, {"tokens": bt["tokens"]})
    assert not torch.allclose(lt_text[:, :patches], lt[:, :patches])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, dtype):
    """A prefill padded to 32 tokens (16 patch slots, then text), then 4
    greedy decode steps fed JAX's tokens: logits at every step, the K/V
    caches after the prefill and the last step, and in float32 the greedy
    tokens equal."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    S, n = 32, 4
    bj, bt, _ = _batches(cfg_j, 2, S, dtype, seed=2)
    lj, cj = JM.prefill(cfg_j, pj, bj, RT_JAX, pad_to=S + n + 1)
    lt, ct = TM.prefill(cfg_t, pt, bt, pad_to=S + n + 1)
    _close(lj, lt, dtype)
    assert set(ct) == set(cj) == {"len", "blocks"}
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for _ in range(n):
        if dtype == "float32":
            np.testing.assert_array_equal(lt[:, -1].argmax(-1).numpy(), tok)
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(tok[:, None]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(tok[:, None]).long())
        _close(lj, lt, dtype)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for key in ("k", "v"):
        assert tuple(ct["blocks"][key].shape) == cj["blocks"][key].shape
        # bf16: the first layer's, below it the roundings drift with depth
        layers = slice(None) if dtype == "float32" else slice(0, 1)
        _close(cj["blocks"][key][layers], ct["blocks"][key][layers], dtype)
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [S + n] * 2


def test_engine_greedy_tokens_match_jax(jax_params):
    """Three prompts of 20 / 13 / 29 tokens, right-padded to 32 (the zero
    patch stub in the first 16 slots), four greedy tokens each (float32
    weights)."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (20, 13, 29)]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=4), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 4 for t in got)


def test_short_batch_rotary_quirk_matches_jax(jax_params):
    """A batch padded to 8 < 16 patch slots: the prefill lays the 8 slots
    out on a 2 x 2 grid (P = 8, g = 2), but decode rotates by ``pos - 16 +
    4`` (from ``frontend_tokens`` unclipped), not by the prefill's ``pos -
    8 + 2``. The port decodes as JAX does (float32 logits within 1e-5,
    engine tokens equal); a config with ``frontend_tokens = 8``, whose
    prefill is the same, decodes to other logits."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    S, n = 8, 4
    bj, bt, toks = _batches(cfg_j, 2, S, "float32", n_extra=n, seed=3)
    lj, cj = JM.prefill(cfg_j, pj, bj, RT_JAX, pad_to=S + n)
    lt, ct = TM.prefill(cfg_t, pt, bt, pad_to=S + n)
    cfg_8 = cfg_t.replace(frontend_tokens=8)
    l8, c8 = TM.prefill(cfg_8, pt, bt, pad_to=S + n)
    _close(lj, lt, "float32")
    assert torch.equal(l8, lt)
    for t in range(S, S + n):
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        l8, c8 = TM.decode_step(cfg_8, pt, c8, torch.as_tensor(toks[:, t:t + 1]).long())
        _close(lj, lt, "float32")
        assert (l8 - lt).abs().max() > 1e-3
    prompts = [toks[0, :5].tolist(), toks[1, :8].tolist()]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=4), device="cpu").generate(prompts)
    assert got == want


def test_init_cache_mirrors_jax():
    """``init_cache`` has JAX's cache tree, shapes and dtypes."""
    cfg_j, cfg_t = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = {".".join(str(k.key) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(JM.cache_structs(cfg_j, 2, 16))[0]}
    got = TM.init_cache(cfg_t, 2, 16, device="cpu")
    flat = {"len": got["len"], **{f"blocks.{k}": v for k, v in got["blocks"].items()}}
    assert set(flat) == set(want)
    for k, s in want.items():
        assert tuple(flat[k].shape) == s.shape, k
        assert str(flat[k].dtype).removeprefix("torch.") == str(s.dtype), k
