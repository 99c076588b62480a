"""The port's dense GQA serving path against the JAX package, on
``phi4-mini-3.8b``'s ``reduced()`` config (4 layers, d 128, 4 heads, 2 KV
heads, head dim 32), with the JAX-initialised weights carried across by
``models.model.params_from_numpy``.

JAX runs ``Runtime(attn_impl="flash", block_q=64, block_k=64)`` on prompts
longer than 256 tokens, so its prefill takes ``flash_attention_jax``; the
port's prefill takes ``kernels.flash_attention`` (the plain version on the
CPU). Two precisions:

* float32 weights on both sides test the algorithm: logits within
  atol 1e-5 / rtol 1e-5 (logits of size ~1; float32 sums in another order
  through 4 layers);
* bfloat16 weights, the serving precision, within atol and rtol 3e-2 (the
  bf16 kernel tolerance of ``tests/test_kernels.py``): the two frameworks
  round bf16 intermediates at other places, which can flip an argmax whose
  top-2 margin is below that, so tokens are compared in float32.
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

ARCH = "phi4-mini-3.8b"
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config(ARCH).reduced()
    return JM.init_params(cfg, jax.random.key(0))


def _flat(jax_params):
    """The JAX parameters as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]}


def _setup(jax_params, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    cfg_t = get_config(ARCH).reduced()
    flat = _flat(jax_params)
    if dtype == "float32":
        pj = jax.tree.map(lambda a: a.astype(jnp.float32), jax_params)
        pt = TM.params_from_numpy(cfg_t, flat, device="cpu").float()
    else:
        pj = jax_params
        pt = TM.params_from_numpy(cfg_t, flat, device="cpu")
    return jax_get_config(ARCH).reduced(), pj, cfg_t, pt


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, dtype):
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 320)
    lj, _, _ = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, caches, _ = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 320, cfg_t.vocab_size)
    assert caches is None
    _close(lj, lt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, dtype):
    """Prefill of 320 tokens (cache padded to 324) and three decode steps:
    logits, the cache contents and lengths."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 323, seed=2)
    S = 320
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX, pad_to=S + 4)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + 4)
    _close(lj, lt, dtype)
    for key in ("k", "v"):
        assert tuple(ct["blocks"][key].shape) == cj["blocks"][key].shape
        _close(cj["blocks"][key], ct["blocks"][key], dtype)
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [S, S]
    for t in range(S, 323):
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        _close(lj, lt, dtype)
    assert ct["len"].tolist() == [323, 323]
    _close(cj["blocks"]["k"][:, :, :323], ct["blocks"]["k"][:, :, :323], dtype)


def test_prefill_decode_matches_forward(jax_params):
    """The port's mirror of ``tests/test_model_consistency.py``: prefill
    plus step-by-step decode reproduces the teacher-forced forward logits
    (bf16 weights, the same bounds as the JAX test)."""
    _, _, cfg, p = _setup(jax_params, "bfloat16")
    B, S, n_dec = 1, 33, 3
    toks = torch.as_tensor(_tokens(cfg, B, S, seed=3)).long()
    logits_full, _, _ = TM.forward(cfg, p, {"tokens": toks})
    Sp = S - n_dec
    logits_pre, cache = TM.prefill(cfg, p, {"tokens": toks[:, :Sp]}, pad_to=S)
    errs = [float((logits_pre - logits_full[:, :Sp]).abs().max())]
    agree = []
    for t in range(Sp, S):
        logits_t, cache = TM.decode_step(cfg, p, cache, toks[:, t:t + 1])
        ref = logits_full[:, t:t + 1]
        errs.append(float((logits_t - ref).abs().max()))
        agree.append(bool((logits_t[:, 0].argmax(-1) == ref[:, 0].argmax(-1)).all()))
    assert max(errs) < 0.35, errs
    assert all(agree)


def test_engine_greedy_tokens_match_jax(jax_params):
    """Three prompts of 300 / 261 / 288 tokens, right-padded to 512, four
    greedy tokens each (float32 weights: see the module docstring)."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (300, 261, 288)]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=4), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 4 for t in got)


def test_engine_sampling_is_seeded(jax_params):
    """Temperature sampling draws from a generator seeded by
    ``ServeConfig.seed``: equal seeds give equal tokens; EOS stops a slot."""
    _, _, cfg, p = _setup(jax_params, "bfloat16")
    prompts = [[1, 2, 3], list(range(10, 30))]
    run = lambda seed, eos=-1: Engine(cfg, p, scfg=ServeConfig(
        max_new_tokens=6, temperature=1.0, seed=seed, eos_id=eos), device="cpu").generate(prompts)
    a, b = run(7), run(7)
    assert a == b and all(len(t) == 6 for t in a)
    assert all(0 <= x < cfg.vocab_size for t in a for x in t)
    stopped = run(7, eos=a[0][1])
    assert stopped[0] == a[0][:2]


def test_params_from_numpy_checks_every_leaf(jax_params):
    """A missing, an unknown or a misshapen leaf is refused."""
    cfg = get_config(ARCH).reduced()
    flat = _flat(jax_params)
    missing = dict(flat)
    del missing["blocks.attn.wq"]
    with pytest.raises(KeyError, match="blocks.attn.wq"):
        TM.params_from_numpy(cfg, missing, device="cpu")
    with pytest.raises(KeyError, match="blocks.extra"):
        TM.params_from_numpy(cfg, {**flat, "blocks.extra": flat["blocks.attn.wq"]},
                             device="cpu")
    with pytest.raises(ValueError, match="blocks.attn.wo"):
        TM.params_from_numpy(cfg, {**flat, "blocks.attn.wo": flat["blocks.attn.wo"][1:]},
                             device="cpu")


def test_engine_decodes_after_every_token_but_the_last(jax_params, monkeypatch):
    """``max_new_tokens`` tokens take one prefill and ``max_new_tokens - 1``
    decode steps: the last token's logits would be thrown away."""
    _, _, cfg, p = _setup(jax_params, "bfloat16")
    prompts = [[1, 2, 3], list(range(10, 30))]
    eng = Engine(cfg, p, scfg=ServeConfig(max_new_tokens=5), device="cpu")
    want = eng.generate(prompts)
    calls = []
    decode_step = TM.decode_step
    monkeypatch.setattr(TM, "decode_step", lambda *a: calls.append(1) or decode_step(*a))
    assert eng.generate(prompts) == want
    assert len(calls) == 4 and all(len(t) == 5 for t in want)
