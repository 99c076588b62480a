"""The port's dense GQA and MoE serving paths against the JAX package, on
the ``reduced()`` configs (4 layers, d 128, 4 heads, 2 KV heads, head dim
32) of ``phi4-mini-3.8b``, ``llama4-scout-17b-a16e`` (4 MoE layers of 4
experts, top-1, one shared expert), ``granite-8b`` and
``mistral-large-123b``, with the JAX-initialised weights carried across by
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

The float32 KV cache of ``llama4-scout-17b-a16e`` is held within atol
1e-4 (``CACHE_TOL``; its logits within 1e-5): inside its layer scan the
JAX package computes the rotary angles at ``rope_theta`` 500 000 ~1e-7 off
(relative) its own eager ``apply_rope``, which the port equals to 1e-8,
so the keys differ by up to 4.7e-5 at position 316 (keys up to ~4.5);
and each MoE layer's float32 sums (grouped products and the weighted
combine, in another order) reach the next layer's keys and values, up to
2.1e-5.

A MoE model adds a routing rule (``routing_rule``). Rounding may send a token whose top-1 /
top-2 router margin is tiny to another expert, and that token's output
then differs by far more than 3e-2; no seed is chosen to avoid such a
token. In float32 every MoE layer's routing (top-k expert ids, recorded on
both sides) must be equal for every token, and the summed MoE aux
(``lb_loss``, ``router_z``, ``dropped_frac``) within 1e-5. In bf16 the
test counts the layer decisions whose router margin (the k-th probability
less the next) is below ``MARGIN_BOUND``, compares logits only at
positions routed alike in every layer, asserts that every position routed
differently had a margin below ``MARGIN_BOUND`` in the first layer where
it differs, and that at most ``MAX_FLIP_SHARE`` of the positions did.
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
from routing_rule import agreed, record_jax_routing
from torch_routing import record_routing

torch.set_num_threads(1)

ARCHS = ["phi4-mini-3.8b", "llama4-scout-17b-a16e", "granite-8b", "mistral-large-123b"]
RT_JAX = default_runtime().with_(attn_impl="flash", block_q=64, block_k=64, remat=False)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
CACHE_TOL = {"llama4-scout-17b-a16e": dict(atol=1e-4, rtol=1e-5)}  # float32 KV cache


@pytest.fixture(scope="module", params=ARCHS)
def jax_params(request):
    """(arch, the JAX package's parameters of its reduced config)."""
    cfg = jax_get_config(request.param).reduced()
    return request.param, JM.init_params(cfg, jax.random.key(0))


@pytest.fixture
def jax_routing(monkeypatch):
    """Each JAX MoE layer's top-k expert ids, in call order
    (``routing_rule.record_jax_routing``)."""
    return record_jax_routing(monkeypatch)


@pytest.fixture
def port_routing(monkeypatch):
    """Each of the port's MoE layers' ``(top_e, margin)``, in call order
    (``torch_routing.record_routing``)."""
    return record_routing(monkeypatch)


def _aux_close(aux_j, aux_t, dtype):
    """The summed MoE aux: float32 within 1e-5, bf16 within 3e-2."""
    if aux_j is None:
        assert aux_t is None
        return
    tol = 1e-5 if dtype == "float32" else 3e-2
    for key in ("lb_loss", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), atol=tol, rtol=tol,
                                   err_msg=key)


def _flat(jax_params):
    """The JAX parameters as float32 numpy leaves keyed by pytree path."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]}


def _setup(jax_params, dtype):
    """(JAX cfg, JAX params, port cfg, port params) in ``dtype``."""
    arch, params = jax_params
    cfg_t = get_config(arch).reduced()
    flat = _flat(params)
    if dtype == "float32":
        pj = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        pt = TM.params_from_numpy(cfg_t, flat, device="cpu").float()
    else:
        pj = params
        pt = TM.params_from_numpy(cfg_t, flat, device="cpu")
    return jax_get_config(arch).reduced(), pj, cfg_t, pt


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(j, t, dtype, where=None, tol=None):
    """``t`` against ``j`` (leading axes [B, S] or [B]) within ``tol``
    (``TOL[dtype]`` by default); only the positions in ``where`` (flat over
    the leading axes) when given."""
    got = t.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(j).astype(jnp.float32))
    if where is not None:
        got = got.reshape(where.size, -1)[where]
        want = want.reshape(where.size, -1)[where]
    np.testing.assert_allclose(got, want, **(tol or TOL[dtype]))


def _moe_layers(cfg):
    return cfg.n_layers - cfg.first_k_dense if cfg.family == "moe" else 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, jax_routing, port_routing, dtype):
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 320)
    lj, _, aux_j = JM.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)}, RT_JAX, mode="train")
    lt, caches, aux_t = TM.forward(cfg_t, pt, {"tokens": torch.as_tensor(toks).long()})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 320, cfg_t.vocab_size)
    assert caches is None
    agree = agreed(port_routing, jax_routing, _moe_layers(cfg_t), dtype)
    _close(lj, lt, dtype, None if agree is None else agree[0])
    _aux_close(aux_j, aux_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, jax_routing, port_routing, dtype):
    """Prefill of 320 tokens (cache padded to 324) and three decode steps:
    logits, the cache contents and lengths (a MoE model's cache as a dense
    model's). In bf16 a MoE model's logits are compared at the positions
    routed alike (the routing rule) and its cache at the first layer, which
    no routing reaches: from the second layer on, attention mixes in the
    positions routed differently, and those layers reach the logits."""
    cfg_j, pj, cfg_t, pt = _setup(jax_params, dtype)
    toks = _tokens(cfg_j, 2, 323, seed=2)
    S = 320
    L = _moe_layers(cfg_t)
    lj, cj = JM.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks[:, :S])}, RT_JAX, pad_to=S + 4)
    lt, ct = TM.prefill(cfg_t, pt, {"tokens": torch.as_tensor(toks[:, :S]).long()},
                        pad_to=S + 4)
    agree = agreed(port_routing, jax_routing, L, dtype)
    where = None if agree is None else agree[0]
    _close(lj, lt, dtype, where)
    tol = CACHE_TOL.get(jax_params[0]) if dtype == "float32" else None
    for key in ("k", "v"):
        assert tuple(ct["blocks"][key].shape) == cj["blocks"][key].shape
        layers = 1 if L and dtype == "bfloat16" else cfg_t.n_layers
        _close(cj["blocks"][key][:layers], ct["blocks"][key][:layers], dtype, tol=tol)
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [S, S]
    for t in range(S, 323):
        port_routing.clear()
        jax_routing.clear()
        lj, cj = JM.decode_step(cfg_j, pj, cj, jnp.asarray(toks[:, t:t + 1]), RT_JAX)
        lt, ct = TM.decode_step(cfg_t, pt, ct, torch.as_tensor(toks[:, t:t + 1]).long())
        agree = agreed(port_routing, jax_routing, L, dtype)
        _close(lj, lt, dtype, None if agree is None else agree[0])
    assert ct["len"].tolist() == [323, 323]
    if dtype == "float32" or not L:
        _close(cj["blocks"]["k"][:, :, :323], ct["blocks"]["k"][:, :, :323], dtype, tol=tol)


def test_prefill_decode_matches_forward(jax_params, port_routing):
    """The port's mirror of ``tests/test_model_consistency.py``: prefill
    plus step-by-step decode reproduces the teacher-forced forward logits
    (bf16 weights, the same bounds as the JAX test). A MoE model's decode
    step is held to the forward at each position routed alike in every
    layer (the routing rule); one of the three decoded positions may route
    differently."""
    _, _, cfg, p = _setup(jax_params, "bfloat16")
    B, S, n_dec = 1, 33, 3
    L = _moe_layers(cfg)
    toks = torch.as_tensor(_tokens(cfg, B, S, seed=3)).long()
    logits_full, _, _ = TM.forward(cfg, p, {"tokens": toks})
    full_routing = list(port_routing)
    Sp = S - n_dec
    logits_pre, cache = TM.prefill(cfg, p, {"tokens": toks[:, :Sp]}, pad_to=S)
    errs = [float((logits_pre - logits_full[:, :Sp]).abs().max())]
    agree = []
    for t in range(Sp, S):
        port_routing.clear()
        logits_t, cache = TM.decode_step(cfg, p, cache, toks[:, t:t + 1])
        same = all(bool((np.sort(e.numpy(), -1) == np.sort(f[t:t + 1].numpy(), -1)).all())
                   for (e, _), (f, _) in zip(port_routing, full_routing))
        if not same:
            continue
        ref = logits_full[:, t:t + 1]
        errs.append(float((logits_t - ref).abs().max()))
        agree.append(bool((logits_t[:, 0].argmax(-1) == ref[:, 0].argmax(-1)).all()))
    assert len(agree) >= (n_dec - 1 if L else n_dec)
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
    """A missing, an unknown or a misshapen leaf is refused (for a MoE
    model also a misshapen expert stack)."""
    arch, params = jax_params
    cfg = get_config(arch).reduced()
    flat = _flat(params)
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
    if cfg.family == "moe":
        with pytest.raises(ValueError, match="blocks.moe.w2"):
            TM.params_from_numpy(cfg, {**flat, "blocks.moe.w2": flat["blocks.moe.w2"][:, 1:]},
                                 device="cpu")
        assert flat["blocks.moe.router"].shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)
        pt = TM.params_from_numpy(cfg, flat, device="cpu")
        assert pt["blocks"][0]["moe"]["router"].dtype == torch.float32
        assert pt["blocks"][0]["moe"]["w1"].dtype == torch.bfloat16


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
