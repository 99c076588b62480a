"""The port's int8 KV cache (JAX's ``cache_quant``) against the JAX
package's, on the CPU: ``_quant_i8``, ``cache_schema(..., quant=True)`` and
eight decode steps from an empty int8 cache on ``phi4-mini-3.8b`` and
``granite-8b`` ``reduced()``, with JAX's weights carried across.

Tolerances: logits as ``tests/test_torch_serve.py`` (float32 atol / rtol
1e-5, bf16 3e-2); in float32 the cached int8 values within 1 (a key a
float32 rounding away from a half rounds the other way) and the scales
within rtol 1e-6; in bf16 the keys themselves may differ by one bf16
rounding (2^-8 relative), which moves a code ``127 x / max|x|`` by up to
0.5 and its scale by 2^-8: the int8 values within 2 (in float32, 99% of
them equal), the scales within rtol 1e-2. The JAX scales of
unwritten slots are not compared (decode masks them, and JAX initialises
them at random).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro.runtime import default_runtime
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.runtime import Runtime, default_runtime as tdefault_runtime

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def test_quant_i8_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    x[1, 1, :4] = [127.0, -63.5, 0.5, -0.5]  # ties round half to even
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jq, js = JT._quant_i8(jnp.asarray(x, dt_j))
        tq, ts = TT._quant_i8(torch.as_tensor(x).to(dt_t))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma3-4b", "zamba2-7b",
                                  "llama4-scout-17b-a16e", "seamless-m4t-medium",
                                  "deepseek-v2-236b"])
def test_cache_schema_quant_matches_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = {jax.tree_util.keystr(p): (tuple(s.shape), s.dtype)
            for p, s in jax.tree_util.tree_flatten_with_path(
                JM.cache_schema(jcfg, 2, 64, quant=True),
                is_leaf=lambda s: hasattr(s, "axes"))[0]}
    want = {k: (shape, str(dt)) for k, (shape, dt) in want.items()}
    got = {}

    def walk(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}[{k!r}]")
            else:
                got[f"{path}[{k!r}]"] = (tuple(v.shape), v.dtype)

    walk(TM.cache_schema(cfg, 2, 64, quant=True))
    assert got == want
    cache = TM.init_cache(cfg, 2, 64, device="cpu", quant=True)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), cache))
    assert leaves and all(not np.any(a) for a in leaves)


def _jax_cache(cfg, B, S):
    """JAX's int8 cache of ``cache_schema(..., quant=True)``, all zeros."""
    return jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                        JM.cache_schema(cfg, B, S, quant=True),
                        is_leaf=lambda s: hasattr(s, "axes"))


@pytest.mark.parametrize("arch,dtype", [("phi4-mini-3.8b", "float32"),
                                        ("granite-8b", "bfloat16")])
def test_int8_decode_matches_jax(arch, dtype):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.key(1))
    flat = {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = TM.params_from_numpy(cfg, flat, device="cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = tp.float()
    B, S, steps = 2, 16, 8
    jcache, tcache = _jax_cache(jcfg, B, S), TM.init_cache(cfg, B, S, device="cpu", quant=True)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (steps, B, 1))
    rt = default_runtime().with_(cache_quant=True)
    assert Runtime(cache_quant=True).cache_quant and not tdefault_runtime().cache_quant
    with torch.no_grad():
        for i in range(steps):
            jl, jcache = JM.decode_step(jcfg, jp, jcache, jnp.asarray(toks[i], jnp.int32), rt)
            tl, tcache = TM.decode_step(cfg, tp, tcache, torch.as_tensor(toks[i]))
            np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                       **TOL[dtype], err_msg=f"step {i}")
    assert int(tcache["len"][0]) == steps
    for kind in ("k", "v"):
        got = tcache["blocks"][kind][:, :, :steps].to(torch.int32).numpy()
        want = np.asarray(jcache["blocks"][kind][:, :, :steps]).astype(np.int32)
        assert np.abs(got - want).max() <= (1 if dtype == "float32" else 2)
        if dtype == "float32":
            assert (got == want).mean() > 0.99
        np.testing.assert_allclose(tcache["blocks"][kind + "_scale"][:, :, :steps].numpy(),
                                   np.asarray(jcache["blocks"][kind + "_scale"][:, :, :steps]),
                                   rtol=1e-6 if dtype == "float32" else 1e-2)
        assert tcache["blocks"][kind].dtype == torch.int8
