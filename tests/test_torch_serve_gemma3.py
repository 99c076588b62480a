"""The port's local:global serving path (Gemma 3) against the JAX package.

``gemma3-4b`` ``reduced()`` (8 layers: 2 superblocks of 3 local layers and
one global layer, window 64; d 128, 4 heads, 2 KV heads of 32) and the
same with 10 layers (2 trailing local layers), with the JAX-initialised
weights carried across by ``models.model.params_from_numpy``. JAX runs
``Runtime(attn_impl="flash", block_q=64, block_k=64)``, so a prompt over
256 tokens takes its blocked ``flash_attention_jax`` (the window's block
pairs); the port's prefill takes ``kernels.flash_attention`` (the plain
version on the CPU). Padded lengths below (48, 32), equal to (64) and
above (96, 128, 320, 512) the window: the prefill builds each local
layer's window-sized ring from the last 64 positions (zeros where the
prompt is shorter) and decode writes slot ``pos % 64`` and wraps it.

Tolerances as ``tests/test_torch_serve.py``: float32 weights within atol
and rtol 1e-5 (the algorithm), bfloat16 within 3e-2 (the two frameworks
round bf16 intermediates at other places); greedy tokens compared in
float32. The caches are compared leaf for leaf, every layer in float32
and the first superblock's 4 layers in bf16: below it the two
frameworks' bf16 roundings drift apart with depth (up to 0.043 at layer
10 on keys of size ~2, a few bf16 ulps), while the logits stay within
3e-2. The plain windowed
attention is held against the JAX package's ``attention_ref`` and
``flash_attention_jax`` in both dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models.attention import attention_ref as jattention_ref
from repro.models.attention import flash_attention_jax
from repro.runtime import default_runtime
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.models import model as TM
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ARCH = "gemma3-4b"
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(j, t, dtype):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)), **TOL[dtype])


# ----------------------------------------------------------------------
# plain windowed attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,causal", [
    (33, 48, True), (64, 64, True), (100, 48, True), (192, 64, True),
    (256, 48, True), (300, 64, True), (128, 48, False)])
def test_windowed_attention_matches_jax(S, window, causal, dtype):
    """The port's plain version (``ops.flash_attention`` on CPU tensors)
    against ``attention_ref`` and the blocked ``flash_attention_jax``
    (64-row blocks; it takes ``attention_ref`` where 64 does not divide
    S), GQA 4 / 2 heads of 32."""
    rng = np.random.default_rng(S + window)
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((2, S, 4, 32), (2, S, 2, 32), (2, S, 2, 32))]
    jd, td = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrs)
    got = tflash.flash_attention(*(torch.as_tensor(a).to(td) for a in arrs),
                                 causal=causal, window=window)
    assert got.dtype == td and tuple(got.shape) == (2, S, 4, 32)
    _close(jattention_ref(jq, jk, jv, causal=causal, window=window), got, dtype)
    _close(flash_attention_jax(jq, jk, jv, causal=causal, window=window, block_q=64,
                               block_k=64), got, dtype)


def test_window_needs_aligned_q_and_k():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="aligned"):
        tflash.flash_attention(q, torch.zeros((1, 16, 2, 32)), torch.zeros((1, 16, 2, 32)),
                               window=4)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=[8, 10], ids=["8_layers", "10_layers"])
def jax_params(request):
    """(layers, the JAX package's parameters of the reduced config)."""
    cfg = jax_get_config(ARCH).reduced().replace(n_layers=request.param)
    return request.param, JM.init_params(cfg, jax.random.key(0))


def _flat(params):
    """The JAX parameters as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _setup(jax_params, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    n_layers, params = jax_params
    cfg_t = get_config(ARCH).reduced().replace(n_layers=n_layers)
    cfg_j = jax_get_config(ARCH).reduced().replace(n_layers=n_layers)
    pt = TM.params_from_numpy(cfg_t, _flat(params), device="cpu")
    if dtype == "float32":
        return cfg_j, jax.tree.map(lambda a: a.astype(jnp.float32), params), cfg_t, pt.float()
    return cfg_j, params, cfg_t, pt


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict of caches."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_schema_and_params_mirror_jax(jax_params):
    """Superblocks of ``local`` [n_super, per - 1] and ``global`` blocks,
    then ``trailing``: every leaf's stacked shape equals the JAX pytree's,
    and the parameter count equals JAX's, here and for the whole model
    (3.88e9)."""
    n_layers, params = jax_params
    cfg = get_config(ARCH).reduced().replace(n_layers=n_layers)
    flat = _flat(params)
    assert flat["superblocks.local.attn.wq"].shape == (2, 3, 128, 4, 32)
    assert flat["superblocks.global.attn.wq"].shape == (2, 128, 4, 32)
    assert ("trailing.attn.wq" in flat) == (n_layers == 10)
    pt = TM.params_from_numpy(cfg, flat, device="cpu")
    np.testing.assert_array_equal(pt["superblocks"][1]["local"][2]["attn"]["wk"].float().numpy(),
                                  flat["superblocks.local.attn.wk"][1, 2])
    assert TM.count_params(cfg) == JM.count_params(
        jax_get_config(ARCH).reduced().replace(n_layers=n_layers))
    assert TM.count_params(get_config(ARCH)) == JM.count_params(jax_get_config(ARCH))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, dtype):
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 320)
    lj, _, _ = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, caches, aux = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 320, cfg_t.vocab_size)
    assert caches is None and aux is None
    _close(lj, lt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [48, 64, 96, 320])
def test_prefill_and_decode_match_jax(jax_params, S, dtype):
    """Prefill of S tokens (below, equal to and above the 64-token window;
    320 takes JAX's flash path), the cache padded by 4, then three decode
    steps: logits, every cache leaf (local and trailing rings of 64 slots,
    global caches of S + 4; in bf16 the first superblock's) and lengths."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, S + 3, seed=S)
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX, pad_to=S + 4)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + 4)
    _close(lj, lt, dtype)

    def caches_close():
        want = dict(_leaves(jax.tree.map(np.asarray, cj)))
        got = dict(_leaves(ct))
        assert got.keys() == want.keys()
        for key, leaf in got.items():
            assert tuple(leaf.shape) == want[key].shape, key
            if key == "len":
                assert leaf.tolist() == want[key].tolist()
            elif dtype == "float32":
                _close(want[key], leaf, dtype)
            elif key.startswith("superblocks"):
                _close(want[key][:1], leaf[:1], dtype)
        return got

    got = caches_close()
    assert tuple(got["superblocks.local.k"].shape) == (2, 3, 2, 64, 2, 32)
    assert tuple(got["superblocks.global.k"].shape) == (2, 2, S + 4, 2, 32)
    for t in range(S, S + 3):
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        _close(lj, lt, dtype)
    assert caches_close()["len"].tolist() == [S + 3, S + 3]


def test_prefill_decode_matches_forward(jax_params):
    """The port's mirror of ``tests/test_model_consistency.py`` on the
    local:global model: prefill of 60 tokens plus 40 decode steps (the
    ring wraps at 64) reproduces the teacher-forced forward logits, in
    float32 within 1e-4 and with equal argmax."""
    _, _, cfg, p = _setup(jax_params, "float32")
    toks = torch.as_tensor(_tokens(cfg, 1, 100, seed=3)).long()
    full, _, _ = TM.forward(cfg, p, {"tokens": toks})
    logits, cache = TM.prefill(cfg, p, {"tokens": toks[:, :60]}, pad_to=100)
    torch.testing.assert_close(logits, full[:, :60], atol=1e-4, rtol=1e-4)
    for t in range(60, 100):
        lt, cache = TM.decode_step(cfg, p, cache, toks[:, t:t + 1])
        torch.testing.assert_close(lt[:, 0], full[:, t], atol=1e-4, rtol=1e-4)
        assert bool((lt[:, 0].argmax(-1) == full[:, t].argmax(-1)).all())


@pytest.mark.parametrize("lens", [(20, 9, 30), (40, 64, 23), (100, 70, 90),
                                  (300, 261, 288)],
                         ids=["pad32", "pad64", "pad128", "pad512"])
def test_engine_greedy_tokens_match_jax(jax_params, lens):
    """Three prompts right-padded below, to, and above the window (512:
    JAX's flash path), 6 greedy tokens each (float32 weights). Above the
    window the prefill ring keeps the last 64 padded positions, pads among
    them for the shorter prompts, as the JAX engine does (ROADMAP Queue
    3); the tokens are equal all the same."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in lens]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=6)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=6), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 6 for t in got)


def test_init_cache_mirrors_jax(jax_params):
    """``init_cache`` holds JAX's schema: rings of ``min(window, S)``
    slots, global caches of S; zeros (JAX draws random values, which
    decode masks)."""
    n_layers, _ = jax_params
    cfg_t = get_config(ARCH).reduced().replace(n_layers=n_layers)
    cfg_j = jax_get_config(ARCH).reduced().replace(n_layers=n_layers)
    for S in (40, 200):
        want = dict(_leaves(jax.tree.map(np.asarray, JM.init_cache(cfg_j, 2, S))))
        got = dict(_leaves(TM.init_cache(cfg_t, 2, S, device="cpu")))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(not v.any() for v in got.values())


# ----------------------------------------------------------------------
# fewer layers than one superblock
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [48, 96])
def test_no_superblock_matches_jax(S, dtype):
    """3 layers, below one period of 4: no superblock, three trailing local
    layers. The JAX parameters' zero-size ``superblocks`` leaves load;
    forward, a prefill of S tokens (below and above the window; cache
    padded by 4) and three decode steps equal JAX's, logits and every cache
    leaf (the zero-size ``superblocks`` ones of the JAX prefill's shapes:
    rings of 64 slots, global caches of S + 4), as do five greedy tokens of
    the engine (float32)."""
    cfg_j = jax_get_config(ARCH).reduced().replace(n_layers=3)
    cfg_t = get_config(ARCH).reduced().replace(n_layers=3)
    flat = _flat(JM.init_params(cfg_j, jax.random.key(0)))
    assert flat["superblocks.local.attn.wq"].shape == (0, 3, 128, 4, 32)
    assert TM.count_params(cfg_t) == JM.count_params(cfg_j)
    _, pj, _, pt = _setup((3, JM.init_params(cfg_j, jax.random.key(0))), dtype)
    assert len(pt["superblocks"]) == 0 and len(pt["trailing"]) == 3
    toks = _tokens(cfg_j, 2, S + 3, seed=S)
    lj, _, _ = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, _, _ = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    _close(lj, lt, dtype)
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX, pad_to=S + 4)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + 4)
    _close(lj, lt, dtype)
    for t in range(S, S + 3):
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        _close(lj, lt, dtype)
    want = dict(_leaves(jax.tree.map(np.asarray, cj)))
    got = dict(_leaves(ct))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert tuple(got["superblocks.local.k"].shape) == (0, 3, 2, 64, 2, 32)
    assert tuple(got["superblocks.global.k"].shape) == (0, 2, S + 4, 2, 32)
    n = 1 if dtype == "bfloat16" else None  # in bf16 the first layer's (module docstring)
    for key, leaf in got.items():
        if key.startswith("trailing"):
            _close(want[key][:n], leaf[:n], dtype)
    assert got["len"].tolist() == [S + 3, S + 3]
    if dtype == "float32":
        rng = np.random.default_rng(S)
        prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (S, S - 9, 30)]
        want_t = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=5)).generate(prompts)
        got_t = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=5),
                       device="cpu").generate(prompts)
        assert got_t == want_t
