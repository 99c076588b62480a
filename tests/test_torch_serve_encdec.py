"""The port's encoder-decoder (SeamlessM4T) against the JAX package.

``seamless-m4t-medium`` ``reduced()`` (2 encoder and 2 decoder layers, d
128, 4 heads, 2 KV heads of 32, no rotary embedding: learned ``enc_pos``
/ ``dec_pos``), with the JAX-initialised weights carried across by
``models.model.params_from_numpy``. The speech front end is a stub on
both sides: the batch carries frame embeddings ``frames`` [B, S_enc, d],
which ``frame_proj`` maps into the encoder; the JAX engine feeds zeros
[B, S, d]. JAX runs ``Runtime(attn_impl="flash", block_q=64,
block_k=64)``; the port's encoder, decoder self-attention and prefill
cross-attention take ``kernels.flash_attention`` (the plain version on the
CPU), non-causal in the encoder and across, with Sq = S_dec and Skv =
S_enc. Decode attends across to the ``ck`` / ``cv`` the prefill cached,
which ``pad_cache`` must not grow (only the self-attention's ``k`` /
``v``).

Tolerances as ``tests/test_torch_serve.py``: float32 weights within atol
and rtol 1e-5, bfloat16 within 3e-2 (the two frameworks round bf16
intermediates at other places); greedy tokens compared in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.runtime import default_runtime
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CACHE_KEYS = ("k", "v", "ck", "cv")


def _flat(tree):
    """A JAX tree as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)), **TOL[dtype])


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax_get_config(ARCH).reduced(), jax.random.key(0))


def _setup(jax_params, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    cfg_t = get_config(ARCH).reduced()
    pt = TM.params_from_numpy(cfg_t, _flat(jax_params), device="cpu")
    pj = jax_params
    if dtype == "float32":
        pj, pt = jax.tree.map(lambda a: a.astype(jnp.float32), pj), pt.float()
    return jax_get_config(ARCH).reduced(), pj, cfg_t, pt


def _batches(cfg, B, S_dec, S_enc, dtype, n_extra=0, seed=1):
    """(JAX batch, port batch, the tokens [B, S_dec + n_extra]): random
    tokens and random frames [B, S_enc, d] in ``dtype``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S_dec + n_extra)).astype(np.int32)
    fr = np.array(jnp.asarray(rng.standard_normal((B, S_enc, cfg.d_model), np.float32),
                              DTYPES[dtype][0]).astype(jnp.float32))
    bj = {"tokens": jnp.asarray(toks[:, :S_dec]), "frames": jnp.asarray(fr, DTYPES[dtype][0])}
    bt = {"tokens": torch.as_tensor(toks[:, :S_dec]).long(),
          "frames": torch.as_tensor(fr).to(DTYPES[dtype][1])}
    return bj, bt, toks


def test_schema_and_params_mirror_jax(jax_params):
    """``frame_proj``, ``enc_pos`` / ``dec_pos`` [16 384, d], the encoder's
    dense blocks, the decoder's blocks (``self_attn``, ``ln_x``,
    ``cross_attn``) and ``enc_final_norm``: every leaf of the JAX pytree,
    with its stacked shape; an unknown or a missing leaf is refused."""
    cfg = get_config(ARCH).reduced()
    flat = _flat(jax_params)
    pt = TM.params_from_numpy(cfg, flat, device="cpu")
    assert tuple(pt["enc_pos"].shape) == tuple(pt["dec_pos"].shape) == (TM.MAX_ENC_POS, 128)
    assert len(pt["enc_blocks"]) == len(pt["dec_blocks"]) == 2
    np.testing.assert_array_equal(pt["dec_blocks"][1]["cross_attn"]["wk"].float().numpy(),
                                  flat["dec_blocks.cross_attn.wk"][1])
    assert pt["enc_final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(KeyError, match="dec_blocks.ln_x.scale"):
        TM.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                   if k != "dec_blocks.ln_x.scale"}, device="cpu")
    with pytest.raises(KeyError, match="patch_proj"):
        TM.params_from_numpy(cfg, {**flat, "patch_proj": flat["frame_proj"]}, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_dec,S_enc", [(40, 24), (24, 300), (320, 96)])
def test_forward_matches_jax(jax_params, S_dec, S_enc, dtype):
    """Random frames, S_enc != S_dec: fewer frames than tokens, more (300:
    JAX's encoder takes its blocked flash path), and a decoder over 256
    tokens."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    bj, bt, _ = _batches(cfg_j, 2, S_dec, S_enc, dtype)
    lj, _, _ = JM.forward(cfg_j, pj, bj, RT_JAX, mode="train")
    lt, caches, _ = TM.forward(cfg_t, pt, bt)
    assert lt.dtype == torch.float32 and caches is None
    assert tuple(lt.shape) == (2, S_dec, cfg_t.vocab_size)
    _close(lj, lt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, dtype):
    """A prefill of 32 tokens over 48 frames (caches padded to 37), then 4
    greedy decode steps fed JAX's tokens: logits at every step; after the
    prefill and the last step ``k`` / ``v`` grown to 37 slots, ``ck`` /
    ``cv`` and ``enc_out`` still 48 long, every leaf and ``len`` /
    ``enc_len`` equal to JAX's (bf16: the first layer's K/V); in float32
    the greedy tokens equal."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    S, S_enc, n = 32, 48, 4
    bj, bt, _ = _batches(cfg_j, 2, S, S_enc, dtype, seed=2)
    lj, cj = JM.prefill(cfg_j, pj, bj, RT_JAX, pad_to=S + n + 1)
    lt, ct = TM.prefill(cfg_t, pt, bt, pad_to=S + n + 1)
    _close(lj, lt, dtype)

    def caches_close():
        assert set(ct) == set(cj) == {"len", "enc_len", "enc_out", "dec_blocks"}
        assert set(ct["dec_blocks"]) == set(CACHE_KEYS)
        for key in CACHE_KEYS:
            leaf = ct["dec_blocks"][key]
            assert tuple(leaf.shape) == cj["dec_blocks"][key].shape
            assert leaf.shape[2] == (S + n + 1 if key in ("k", "v") else S_enc)
            layers = slice(None) if dtype == "float32" else slice(0, 1)
            _close(cj["dec_blocks"][key][layers], leaf[layers], dtype)
        assert tuple(ct["enc_out"].shape) == (2, S_enc, cfg_t.d_model)
        _close(cj["enc_out"], ct["enc_out"], dtype)
        assert ct["enc_len"].tolist() == np.asarray(cj["enc_len"]).tolist() == [S_enc] * 2

    caches_close()
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for _ in range(n):
        if dtype == "float32":
            np.testing.assert_array_equal(lt[:, -1].argmax(-1).numpy(), tok)
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(tok[:, None]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(tok[:, None]).long())
        _close(lj, lt, dtype)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    caches_close()
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [S + n] * 2


@pytest.mark.parametrize("lens", [(20, 13, 29), (5,)])
def test_engine_greedy_tokens_match_jax(jax_params, lens):
    """Prompts right-padded to 32 (or 8), the engine's zero frames as long,
    four greedy tokens each (float32 weights)."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in lens]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=4), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 4 for t in got)


def test_cache_schema_and_pad_cache_mirror_jax():
    """``init_cache`` has JAX's cache tree, shapes and dtypes (``dec_blocks``
    {k, v, ck, cv} [L, B, S, KV, D] bf16, ``enc_out`` [B, S, d], ``len``
    and ``enc_len`` int32); ``pad_cache`` grows ``k`` / ``v`` along the
    sequence dim (-3) as JAX's does, values kept, and leaves ``ck`` /
    ``cv`` / ``enc_out`` as they are."""
    cfg_j, cfg_t = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = {".".join(str(k.key) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(JM.cache_structs(cfg_j, 2, 16))[0]}
    got_tree = TM.init_cache(cfg_t, 2, 16, device="cpu")
    got = {f"dec_blocks.{k}": v for k, v in got_tree["dec_blocks"].items()}
    got.update({k: v for k, v in got_tree.items() if k != "dec_blocks"})
    assert set(got) == set(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype), k
    rng = np.random.default_rng(5)
    filled = {"dec_blocks": {k: rng.standard_normal(want[f"dec_blocks.{k}"].shape, np.float32)
                             for k in CACHE_KEYS},
              "enc_out": rng.standard_normal(want["enc_out"].shape, np.float32)}
    grown_j = JM.pad_cache(cfg_j, jax.tree.map(jnp.asarray, filled), 7)
    grown_t = TM.pad_cache(cfg_t, {"dec_blocks": {k: torch.as_tensor(v) for k, v in
                                                  filled["dec_blocks"].items()},
                                   "enc_out": torch.as_tensor(filled["enc_out"])}, 7)
    for k in CACHE_KEYS:
        v = grown_t["dec_blocks"][k]
        assert v.shape[2] == (16 + 7 if k in ("k", "v") else 16)
        np.testing.assert_array_equal(v.numpy(), np.asarray(grown_j["dec_blocks"][k]))
    np.testing.assert_array_equal(grown_t["enc_out"].numpy(), filled["enc_out"])
    assert grown_j["enc_out"].shape == filled["enc_out"].shape
