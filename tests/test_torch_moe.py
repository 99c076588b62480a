"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``moe_block`` (gather dispatch, ``default_runtime()``: one
device, so ``_moe_local`` with one shard), and the port's mirror of
``tests/test_moe.py``.

Inputs come from JAX's ``init_tree`` (parameters) and numpy (x), carried
across as numpy arrays. The MoE blocks of ``llama4-scout-17b-a16e`` (top-1,
one shared expert) and ``deepseek-v2-236b`` (top-2, its MoE block alone;
its MLA attention: ``tests/test_torch_mla.py``) ``reduced()``: d 128, 4
experts of 128.

* float32: the routing (top-k expert ids) equal for every token; the
  output within atol / rtol 1e-5 (sums of 128-term products in another
  order); ``lb_loss``, ``router_z`` and ``dropped_frac`` within 1e-6; at
  ``capacity_factor`` 0.25 (rows past the capacity dropped)
  ``dropped_frac`` exactly equal.
* bfloat16 (the serving precision; the router stays float32): the
  routing rule of ``tests/test_torch_serve.py`` — outputs are compared,
  within 3e-2, only on tokens routed alike; a token routed differently
  must have a router margin below ``MARGIN_BOUND``, and at most
  ``MAX_FLIP_SHARE`` of the tokens may.

``count_params`` equals the JAX package's for every architecture the port
admits, full and reduced, with and without ``active_only``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.moe import moe_block as jmoe_block
from repro.models.moe import moe_schema as jmoe_schema
from repro.models.spec import init_tree
from repro.runtime import default_runtime
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from torch_routing import route

torch.set_num_threads(1)

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]
MAX_FLIP_SHARE = 0.05  # tokens that may route differently in bf16
MARGIN_BOUND = 1e-2  # router margins reported as near-ties in bf16
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = np.asarray(v.astype(jnp.float32))
    return out


def _to_torch(flat, dtype):
    """The flat numpy leaves as the port's parameter dict: the router in
    float32, the rest in ``dtype``."""
    p = {}
    for key, arr in flat.items():
        node = p
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        t = torch.as_tensor(np.array(arr))
        node[leaf] = t if leaf == "router" else t.to(DT[dtype])
    return p


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, JAX params in float32, their numpy leaves, x [2, 16, d])."""
    cfg = jget(request.param).reduced()
    p = init_tree(jmoe_schema(cfg), jax.random.key(0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32) * 0.3
    return request.param, p, _flat(p), x


def _jax_routing(p, x, k):
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    _, e = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1), k)
    return np.sort(np.asarray(e), axis=-1)


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_block_matches_jax_float32(case, cf):
    arch, pj, flat, x = case
    cfg_j, cfg_t = jget(arch).reduced(), get_config(arch).reduced()
    out_j, aux_j = jmoe_block(pj, jnp.asarray(x), cfg=cfg_j,
                              rt=default_runtime().with_(moe_capacity_factor=cf))
    pt = _to_torch(flat, "float32")
    out_t, aux_t = TMOE.moe_block(pt, torch.as_tensor(x), cfg=cfg_t, capacity_factor=cf)
    top_e, _ = route(pt, torch.as_tensor(x), cfg_t.moe_top_k)
    np.testing.assert_array_equal(np.sort(top_e.numpy(), axis=-1),
                                  _jax_routing(pj, x, cfg_t.moe_top_k))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == x.shape
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    for key in ("lb_loss", "router_z", "dropped_frac"):
        assert abs(float(aux_t[key]) - float(aux_j[key])) <= 1e-6, key
    if cf < 1:
        assert float(aux_t["dropped_frac"]) > 0
        assert float(aux_t["dropped_frac"]) == float(aux_j["dropped_frac"])
    else:
        assert float(aux_t["dropped_frac"]) == 0.0


def test_moe_block_matches_jax_bfloat16(case):
    """bf16 weights and input, the router in float32 (as the schema says):
    the routing rule (module docstring)."""
    arch, pj, flat, x = case
    cfg_j, cfg_t = jget(arch).reduced(), get_config(arch).reduced()
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj)
    pb["router"] = pj["router"]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out_j, aux_j = jmoe_block(pb, xb, cfg=cfg_j, rt=default_runtime())
    xt = torch.as_tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    pt = _to_torch(flat, "bfloat16")
    out_t, _ = TMOE.moe_block(pt, xt, cfg=cfg_t)
    assert out_t.dtype == torch.bfloat16
    k = cfg_t.moe_top_k
    top_e, margin = route(pt, xt, k)
    jax_e = _jax_routing(pb, np.asarray(xb.astype(jnp.float32)), k)
    agree = (np.sort(top_e.numpy(), axis=-1) == jax_e).all(-1)
    near = int((margin.numpy() < MARGIN_BOUND).sum())
    assert (margin.numpy()[~agree] < MARGIN_BOUND).all()
    assert 1 - agree.mean() <= MAX_FLIP_SHARE, (
        f"{(~agree).sum()} of {agree.size} tokens routed differently; "
        f"{near} below a margin of {MARGIN_BOUND}")
    got = out_t.to(torch.float32).numpy().reshape(-1, x.shape[-1])[agree]
    want = np.asarray(out_j.astype(jnp.float32)).reshape(-1, x.shape[-1])[agree]
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


# ----------------------------------------------------------------------
# the port's mirror of tests/test_moe.py
# ----------------------------------------------------------------------
def _brute_force(p, x, cfg):
    """Per-token dense expert evaluation with the same routing."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs = torch.softmax(xf.to(torch.float32) @ p["router"], -1)
    w, e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros((T, d), dtype=torch.float32)
    for t in range(cfg.moe_top_k):
        ei = e[:, t]
        h = (torch.nn.functional.silu(torch.einsum("td,tdf->tf", xf, p["w1"][ei]))
             * torch.einsum("td,tdf->tf", xf, p["w3"][ei]))
        out = out + w[:, t, None] * torch.einsum("tf,tfd->td", h, p["w2"][ei]).to(torch.float32)
    if "shared" in p:
        sh = p["shared"]
        hs = torch.nn.functional.silu(xf @ sh["w1"]) * (xf @ sh["w3"])
        out = out + (hs @ sh["w2"]).to(torch.float32)
    return out.reshape(B, S, d)


def test_moe_matches_brute_force(case):
    arch, _, flat, x = case
    cfg = get_config(arch).reduced()
    p = _to_torch(flat, "float32")
    xt = torch.as_tensor(x)
    out, aux = TMOE.moe_block(p, xt, cfg=cfg, capacity_factor=8.0)  # ample: no drops
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(out.numpy(), _brute_force(p, xt, cfg).numpy(),
                               atol=1e-4, rtol=1e-3)


def test_moe_capacity_drops_counted(case):
    """bf16, capacity factor 0.25: the rows past capacity are dropped and
    counted, the output stays finite; at T * k <= 8 rows nothing drops."""
    arch, _, flat, x = case
    cfg = get_config(arch).reduced()
    p = _to_torch(flat, "bfloat16")
    out, aux = TMOE.moe_block(p, torch.as_tensor(x).to(torch.bfloat16), cfg=cfg,
                              capacity_factor=0.25)
    T, k = x.shape[0] * x.shape[1], cfg.moe_top_k
    M = TMOE.capacity_rows(0.25, T, k, cfg.n_experts)
    assert float(aux["dropped_frac"]) == (T * k - M) / (T * k) > 0
    assert bool(torch.isfinite(out.to(torch.float32)).all())
    _, aux = TMOE.moe_block(p, torch.as_tensor(x[:1, :4]).to(torch.bfloat16), cfg=cfg,
                            capacity_factor=0.25)
    assert float(aux["dropped_frac"]) == 0.0


def test_moe_aux_losses_sane():
    arch = "llama4-scout-17b-a16e"
    cfg = get_config(arch).reduced()
    p = _to_torch(_flat(init_tree(jmoe_schema(jget(arch).reduced()), jax.random.key(0))),
                  "bfloat16")
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _, aux = TMOE.moe_block(p, torch.as_tensor(x).to(torch.bfloat16), cfg=cfg)
    # the Switch load-balance loss is ~1.0 for a balanced router at init
    assert 0.5 < float(aux["lb_loss"]) < 4.0
    assert float(aux["router_z"]) >= 0.0


def test_a2a_dispatch_is_refused(case):
    arch, _, flat, x = case
    with pytest.raises(NotImplementedError, match="item 12"):
        TMOE.moe_block(_to_torch(flat, "float32"), torch.as_tensor(x),
                       cfg=get_config(arch).reduced(), impl="a2a")


def _grouped_mm_plain(x, w, offs):
    """Rows ``offs[e - 1]:offs[e]`` of ``x`` [M, K] times ``w[e]`` [K, N]
    (``offs[-1] == M``), one product per expert, in ``x``'s dtype."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        out[start:end] = x[start:end] @ w[e]
        start = end
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_mm_call_matches_the_plain_loop(dtype):
    """The layer's grouped product (``torch._grouped_mm`` with end offsets)
    against the plain per-expert loop: empty groups included, the same
    products in the same dtype (bf16 at 16-byte-aligned strides, as the
    card needs)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((40, 128), np.float32)).to(DT[dtype])
    w = torch.as_tensor(rng.standard_normal((4, 128, 64), np.float32)).to(DT[dtype])
    offs = torch.tensor([0, 17, 17, 40], dtype=torch.int32)
    got = torch._grouped_mm(x, w, offs=offs)
    want = _grouped_mm_plain(x, w, offs)
    assert got.dtype == want.dtype == DT[dtype]
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               want.to(torch.float32).numpy(), **tol)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "phi4-mini-3.8b", "granite-8b",
                                  "mistral-large-123b", "mamba2-130m", "zamba2-7b",
                                  "deepseek-v2-236b", "qwen2-vl-72b",
                                  "seamless-m4t-medium"])
def test_count_params_equal_jax(arch, reduced):
    """Every architecture the port admits; ``active_only`` counts a MoE
    model's routed experts at top-k of E."""
    cfg_t, cfg_j = get_config(arch), jget(arch)
    if reduced:
        cfg_t, cfg_j = cfg_t.reduced(), cfg_j.reduced()
    for active in (False, True):
        assert TM.count_params(cfg_t, active_only=active) == \
            JM.count_params(cfg_j, active_only=active)
    assert cfg_t.n_params() == cfg_j.n_params()
    assert cfg_t.n_active_params() == cfg_j.n_active_params()
    if cfg_t.family == "moe":
        assert cfg_t.n_active_params() < cfg_t.n_params()
