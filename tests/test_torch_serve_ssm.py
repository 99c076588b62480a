"""The port's ``ssm`` (Mamba-2) and ``hybrid`` (Zamba2) serving paths
against the JAX package, on ``mamba2-130m``'s and ``zamba2-7b``'s
``reduced()`` configs, the 7-layer hybrid (one superblock of 3 SSM
layers and the shared attention block twice, then one trailing layer) and
the 2-layer hybrid (fewer layers than one superblock: its ``superblocks``
parameters and caches are zero-size leaves, and the shared attention block
never runs), with the JAX-initialised weights carried across by
``models.model.params_from_numpy``.

Prompts are at most 256 tokens, so JAX's prefill attention is its plain
reference; the port's prefill takes ``kernels.flash_attention`` and its
SSM layers ``kernels.ssd`` (the plain versions on the CPU). Two
precisions, as ``tests/test_torch_serve.py``:

* float32 weights on both sides: logits and caches within atol 1e-5 /
  rtol 1e-5 (float32 sums in another order);
* bfloat16 weights: logits within atol and rtol 3e-2 (the frameworks
  round bf16 intermediates at other places), tokens compared in float32.
  The caches' bf16 leaves (K/V, conv prefixes) hold values up to ~4, where
  one bf16 ulp is 1/32: they are compared at rtol 3e-2 and an atol of two
  ulps at the leaf's largest magnitude (at least 3e-2), since an input one
  ulp apart can move a small entry by that much.

The engine right-pads a batch's prompts and prefills the pads, as the JAX
engine does; the SSM state absorbs them, so the ragged-prompt test holds
the port to the reference's tokens, not to per-prompt generation.
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

RT_JAX = default_runtime().with_(remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
ARCHS = {"mamba2": ("mamba2-130m", {}), "zamba2": ("zamba2-7b", {}),
         "zamba2_7l": ("zamba2-7b", {"n_layers": 7}),
         "zamba2_2l": ("zamba2-7b", {"n_layers": 2})}  # no superblock: zero-size leaves


def _cfg(get, case):
    arch, kw = ARCHS[case]
    return get(arch).reduced().replace(**kw)


_PARAMS = {}


def _jax_params(case):
    if case not in _PARAMS:
        _PARAMS[case] = JM.init_params(_cfg(jax_get_config, case), jax.random.key(0))
    return _PARAMS[case]


def _flat(tree):
    """A JAX tree as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _setup(case, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    pj = _jax_params(case)
    cfg_t = _cfg(get_config, case)
    pt = TM.params_from_numpy(cfg_t, _flat(pj), device="cpu")
    if dtype == "float32":
        pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
        pt = pt.float()
    return _cfg(jax_get_config, case), pj, cfg_t, pt


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)), **TOL[dtype])


def _leaves(tree, prefix=""):
    """A port cache tree as {path: tensor}, paths as in ``_flat``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close_cache(cj, ct, dtype):
    want, got = _flat(cj), _leaves(ct)
    assert set(want) == set(got)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "len":
            continue
        tol = dict(TOL[dtype])
        if got[k].dtype == torch.bfloat16 and want[k].size:  # two ulps at the leaf's scale
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want[k]).max())) - 7)
            tol["atol"] = max(tol["atol"], 2 * ulp)
        np.testing.assert_allclose(got[k].to(torch.float32).numpy(), want[k], **tol,
                                   err_msg=k)
    assert got["len"].tolist() == want["len"].tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ARCHS))
def test_forward_matches_jax(case, dtype):
    """80 tokens: two 32-step chunks and a ragged tail."""
    cfg_j, pj, cfg_t, pt = _setup(case, dtype)
    toks = _tokens(cfg_j, 2, 80)
    lj, _, _ = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, caches, _ = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 80, cfg_t.vocab_size)
    assert caches is None
    _close(lj, lt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ARCHS))
def test_prefill_and_decode_match_jax(case, dtype):
    """Prefill of 70 tokens (KV caches padded to 74; SSM states and conv
    prefixes unpadded), then three decode steps: logits and every cache
    leaf."""
    cfg_j, pj, cfg_t, pt = _setup(case, dtype)
    toks = _tokens(cfg_j, 2, 73, seed=2)
    S = 70
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX, pad_to=S + 4)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + 4)
    _close(lj, lt, dtype)
    _close_cache(cj, ct, dtype)
    for t in range(S, 73):
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        _close(lj, lt, dtype)
    _close_cache(cj, ct, dtype)
    assert ct["len"].tolist() == [73, 73]


@pytest.mark.parametrize("case", list(ARCHS))
def test_prefill_decode_matches_forward(case):
    """The port's mirror of ``tests/test_model_consistency.py``: prefill
    plus step-by-step decode reproduces the teacher-forced forward logits
    (bf16 weights, the same bounds as the JAX test)."""
    _, _, cfg, p = _setup(case, "bfloat16")
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


@pytest.mark.parametrize("case", list(ARCHS))
def test_engine_greedy_tokens_match_jax(case):
    """Three prompts of 40 / 29 / 35 tokens, right-padded to 64, five greedy
    tokens each (float32 weights). The shorter prompts' SSM states absorb
    their pads in both engines."""
    cfg_j, pj, cfg_t, pt = _setup(case, "float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (40, 29, 35)]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=5)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=5), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 5 for t in got)


@pytest.mark.parametrize("case", list(ARCHS))
def test_init_cache_matches_jax_schema(case):
    """``init_cache`` has the JAX cache schema's tree, shapes and dtypes, and
    ``pad_cache`` grows only the KV leaves."""
    cfg_j, cfg_t = _cfg(jax_get_config, case), _cfg(get_config, case)
    want = {".".join(str(k.key) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                JM.cache_structs(cfg_j, 2, 16))[0]}
    got = _leaves(TM.init_cache(cfg_t, 2, 16, device="cpu"))
    assert set(got) == set(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype), k
    grown = _leaves(TM.pad_cache(cfg_t, TM.init_cache(cfg_t, 2, 16, device="cpu"), 5))
    for k, t in got.items():
        kv = k.rsplit(".", 1)[-1] in ("k", "v")
        want_shape = t.shape[:-3] + (t.shape[-3] + 5,) + t.shape[-2:] if kv else t.shape
        assert grown[k].shape == want_shape, k


@pytest.mark.parametrize("case", ["mamba2", "zamba2_7l", "zamba2_2l"])
def test_params_from_numpy_checks_every_leaf(case):
    """A missing, an unknown or a misshapen leaf is refused, at every
    stacking depth (blocks, superblocks, trailing, the unstacked shared
    block), the zero-size leaves of a model with no superblock too."""
    cfg = _cfg(get_config, case)
    flat = _flat(_jax_params(case))
    keys = (["blocks.mixer.wz"] if case == "mamba2" else
            ["superblocks.mixer.wz", "trailing.mixer.A_log", "shared_attn.attn.wq"])
    for key in keys:
        missing = {k: v for k, v in flat.items() if k != key}
        with pytest.raises(KeyError, match=key):
            TM.params_from_numpy(cfg, missing, device="cpu")
        with pytest.raises(ValueError, match=key):
            TM.params_from_numpy(cfg, {**flat, key: flat[key][..., :1]}, device="cpu")
    extra = keys[0].rsplit(".", 1)[0] + ".extra"
    with pytest.raises(KeyError, match=extra):
        TM.params_from_numpy(cfg, {**flat, extra: flat[keys[0]]}, device="cpu")
