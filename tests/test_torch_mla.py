"""The port's MLA attention (DeepSeek-V2) against the JAX package.

Two models, ``reduced()``, with the JAX-initialised weights carried across
by ``models.model.params_from_numpy``: ``deepseek-v2-236b`` (one dense
layer, then 3 MoE layers of 4 experts, top-2, one shared expert) and a
dense model with MLA (``phi4-mini-3.8b`` with ``attn_kind="mla"``, 4
layers); both d 128, 4 heads, q_lora 64, kv_lora 32, head dims 32 without
and 16 with the rotary embedding, values 32. JAX runs
``Runtime(attn_impl="flash", block_q=64, block_k=64)``, so a prompt over
256 tokens takes its blocked ``flash_attention_jax``; the port's prefill
takes ``kernels.flash_attention`` (the plain version on the CPU) at D = 48,
Dv = 32. Decode on both sides writes the token's compressed row into the
``ckv`` / ``krope`` cache, absorbs ``wk_b`` into the query and attends over
``[ckv | krope]`` as one KV head, scaled by ``(dn + dr) ** -0.5``.

Tolerances as ``tests/test_torch_serve.py``: float32 weights within atol
and rtol 1e-5 (float32 sums in another order), bfloat16 within 3e-2 (the
two frameworks round bf16 intermediates at other places); greedy tokens
compared in float32. DeepSeek-V2's MoE layers add the routing rule
(``routing_rule``): float32 routes every token alike in every layer; bf16
compares logits at the positions routed alike; the bf16 caches are
compared at the first layer, which no routing reaches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.spec import init_tree
from repro.runtime import default_runtime
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.spec import DTYPES, build_tree
from repro_torch.serve import Engine, ServeConfig
from routing_rule import agreed, record_jax_routing
from torch_routing import record_routing

torch.set_num_threads(1)

ARCHS = ["deepseek-v2-236b", "phi4-mini-3.8b-mla"]
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(get, arch):
    """The reduced config of ``arch``; ``<arch>-mla`` is that model with MLA."""
    if arch.endswith("-mla"):
        return get(arch.removesuffix("-mla")).replace(attn_kind="mla").reduced()
    return get(arch).reduced()


def _flat(tree):
    """A JAX tree as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(j, t, dtype, where=None, tol=None):
    """``t`` against ``j`` (leading axes [B, S] or [B]) within ``tol``
    (``TOL[dtype]`` by default); only at the positions in ``where`` (flat
    over the leading axes) when given."""
    got = t.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(j).astype(jnp.float32))
    assert got.shape == want.shape
    if where is not None:
        got = got.reshape(where.size, -1)[where]
        want = want.reshape(where.size, -1)[where]
    np.testing.assert_allclose(got, want, **(tol or TOL[dtype]))


# ----------------------------------------------------------------------
# the attention sub-layer alone
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [40, 320])
def test_mla_attn_matches_jax(S, dtype):
    """``mla_attn`` on DeepSeek-V2's reduced widths: a prefill of S tokens
    (320 takes JAX's blocked flash path) and three decode steps into the
    cache padded by 3; the outputs and the ``ckv`` / ``krope`` caches."""
    cfg_j, cfg_t = _cfg(jax_get_config, ARCHS[0]), _cfg(get_config, ARCHS[0])
    flat = _flat(init_tree(JT.mla_schema(cfg_j), jax.random.key(3)))
    pj = {k: jnp.asarray(v, JDT[dtype] if v.ndim > 1 else jnp.float32) for k, v in flat.items()}
    pt = build_tree(TT.mla_schema(cfg_t), lambda path, s: torch.tensor(flat[path]).to(
        TDT[dtype] if s.dtype == "bfloat16" else DTYPES[s.dtype]))
    x = np.random.default_rng(S).standard_normal((2, S + 3, cfg_t.d_model), np.float32)
    xj, xt = jnp.asarray(x, JDT[dtype]), torch.as_tensor(x).to(TDT[dtype])
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    ctx_j = JT.Ctx(cfg=cfg_j, rt=RT_JAX, mode="prefill", pos=jnp.asarray(pos))
    ctx_t = TT.Ctx(cfg=cfg_t, mode="prefill", pos=torch.as_tensor(pos))
    oj, cj = JT.mla_attn(pj, xj[:, :S], None, ctx_j)
    ot, ct = TT.mla_attn(pt, xt[:, :S], None, ctx_t)
    assert ot.dtype == TDT[dtype] and set(ct) == {"ckv", "krope"}
    assert tuple(ct["ckv"].shape) == (2, S, cfg_t.kv_lora_rank)
    assert tuple(ct["krope"].shape) == (2, S, cfg_t.qk_rope_head_dim)
    _close(oj, ot, dtype)
    for key in ct:
        _close(cj[key], ct[key], dtype)
    cj = {k: jnp.pad(v, ((0, 0), (0, 3), (0, 0))) for k, v in cj.items()}
    ct = {k: F.pad(v, (0, 0, 0, 3)) for k, v in ct.items()}
    for t in range(S, S + 3):
        posB = np.full((2,), t, np.int32)
        oj, cj = JT.mla_attn(pj, xj[:, t:t + 1], cj, JT.Ctx(
            cfg=cfg_j, rt=RT_JAX, mode="decode", pos=jnp.asarray(posB)))
        ot, ct = TT.mla_attn(pt, xt[:, t:t + 1], ct, TT.Ctx(
            cfg=cfg_t, mode="decode", pos=torch.as_tensor(posB)))
        _close(oj, ot, dtype)
    for key in ct:
        _close(cj[key], ct[key], dtype)


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def jax_params(request):
    """(arch, the JAX package's parameters of its reduced config)."""
    return request.param, JM.init_params(_cfg(jax_get_config, request.param),
                                         jax.random.key(0))


@pytest.fixture
def jax_routing(monkeypatch):
    return record_jax_routing(monkeypatch)


@pytest.fixture
def port_routing(monkeypatch):
    return record_routing(monkeypatch)


def _setup(jax_params, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    arch, params = jax_params
    cfg_t = _cfg(get_config, arch)
    pt = TM.params_from_numpy(cfg_t, _flat(params), device="cpu")
    if dtype == "float32":
        params, pt = jax.tree.map(lambda a: a.astype(jnp.float32), params), pt.float()
    return _cfg(jax_get_config, arch), params, cfg_t, pt


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _moe_layers(cfg):
    return cfg.n_layers - cfg.first_k_dense if cfg.family == "moe" else 0


def _stacks(cfg):
    return ["dense_blocks", "blocks"] if cfg.first_k_dense else ["blocks"]


def test_schema_mirrors_jax(jax_params):
    """Every parameter leaf (MLA's bare float32 ``q_norm`` / ``kv_norm``
    scales among them) has the JAX pytree's stacked shape and the schema's
    dtype; a missing, an unknown or a misshapen MLA leaf is refused."""
    arch, params = jax_params
    cfg = _cfg(get_config, arch)
    flat = _flat(params)
    pt = TM.params_from_numpy(cfg, flat, device="cpu")
    attn = pt["blocks"][0]["attn"]
    assert attn["q_norm"].dtype == torch.float32 and attn["wq_b"].dtype == torch.bfloat16
    assert tuple(attn["wq_b"].shape) == (64, 4, 48)
    np.testing.assert_array_equal(pt["blocks"][1]["attn"]["wkv_a"].float().numpy(),
                                  flat["blocks.attn.wkv_a"][1])
    if cfg.first_k_dense:
        assert flat["dense_blocks.attn.kv_norm"].shape == (1, cfg.kv_lora_rank)
    with pytest.raises(KeyError, match="blocks.attn.q_norm"):
        TM.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                   if k != "blocks.attn.q_norm"}, device="cpu")
    with pytest.raises(KeyError, match="blocks.attn.wq"):
        TM.params_from_numpy(cfg, {**flat, "blocks.attn.wq": flat["blocks.attn.wq_a"]},
                             device="cpu")
    with pytest.raises(ValueError, match="blocks.attn.wk_b"):
        TM.params_from_numpy(cfg, {**flat, "blocks.attn.wk_b": flat["blocks.attn.wk_b"][:1]},
                             device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, jax_routing, port_routing, dtype):
    """320 tokens (JAX's flash path): logits, under the routing rule."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 320)
    lj, _, _ = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, caches, _ = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    assert lt.dtype == torch.float32 and caches is None
    agree = agreed(port_routing, jax_routing, _moe_layers(cfg_t), dtype)
    _close(lj, lt, dtype, None if agree is None else agree[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, jax_routing, port_routing, dtype):
    """Prefill of 300 tokens (the compressed caches padded to 305), then 4
    decode steps: logits at every step under the routing rule, the ``ckv``
    / ``krope`` leaves after the prefill and after the last step, and the
    lengths. In bf16 only the first layer's leaves: below it the two
    frameworks' bf16 roundings drift apart with depth (up to 0.051 at the
    dense model's fourth layer, on entries of size ~4: under two bf16 ulps),
    while the logits stay within 3e-2."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    S, n = 300, 4
    toks = _tokens(cfg_j, 2, S + n, seed=2)
    L = _moe_layers(cfg_t)
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX,
                        pad_to=S + n + 1)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + n + 1)
    agree = agreed(port_routing, jax_routing, L, dtype)
    _close(lj, lt, dtype, None if agree is None else agree[0])

    def caches_close():
        assert set(ct) == set(cj) == {"len", *_stacks(cfg_t)}
        for stack in _stacks(cfg_t):
            assert set(ct[stack]) == {"ckv", "krope"}
            for key, leaf in ct[stack].items():
                assert tuple(leaf.shape) == cj[stack][key].shape
                if dtype == "float32":
                    _close(cj[stack][key], leaf, dtype)
                elif stack == _stacks(cfg_t)[0]:
                    _close(cj[stack][key][:1], leaf[:1], dtype)

    caches_close()
    assert tuple(ct["blocks"]["ckv"].shape) == (cfg_t.n_layers - cfg_t.first_k_dense, 2,
                                                S + n + 1, cfg_t.kv_lora_rank)
    for t in range(S, S + n):
        port_routing.clear()
        jax_routing.clear()
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        agree = agreed(port_routing, jax_routing, L, dtype)
        _close(lj, lt, dtype, None if agree is None else agree[0])
    caches_close()
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [S + n, S + n]


def test_engine_greedy_tokens_match_jax(jax_params):
    """Three prompts of 300 / 261 / 288 tokens, right-padded to 512, four
    greedy tokens each (float32 weights)."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, "float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (300, 261, 288)]
    want = JEngine(cfg_j, pj, scfg=JServeConfig(max_new_tokens=4)).generate(prompts)
    got = Engine(cfg_t, pt, scfg=ServeConfig(max_new_tokens=4), device="cpu").generate(prompts)
    assert got == want
    assert all(len(t) == 4 for t in got)


def test_cache_schema_and_pad_cache_mirror_jax(jax_params):
    """``init_cache`` has JAX's cache tree, shapes and dtypes (``ckv`` [L, B,
    S, kv_lora], ``krope`` [L, B, S, rope dim], bf16); ``pad_cache`` grows
    both along the sequence dim (-2) as JAX's does, values kept."""
    arch, _ = jax_params
    cfg_j, cfg_t = _cfg(jax_get_config, arch), _cfg(get_config, arch)
    want = {".".join(str(k.key) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(JM.cache_structs(cfg_j, 2, 16))[0]}
    got = {f"{stack}.{k}" if k else stack: v
           for stack, tree in TM.init_cache(cfg_t, 2, 16, device="cpu").items()
           for k, v in (tree.items() if isinstance(tree, dict) else [("", tree)])}
    assert set(got) == set(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype), k
    rng = np.random.default_rng(5)
    filled = {stack: {k: rng.standard_normal(want[f"{stack}.{k}"].shape, np.float32)
                      for k in ("ckv", "krope")} for stack in _stacks(cfg_t)}
    grown_j = JM.pad_cache(cfg_j, jax.tree.map(jnp.asarray, filled), 7)
    grown_t = TM.pad_cache(cfg_t, {s: {k: torch.as_tensor(v) for k, v in t.items()}
                                   for s, t in filled.items()}, 7)
    for stack, tree in grown_t.items():
        for k, v in tree.items():
            assert v.shape[-2] == 16 + 7
            np.testing.assert_array_equal(v.numpy(), np.asarray(grown_j[stack][k]))
