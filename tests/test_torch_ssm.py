"""The port's Mamba-2 SSD scan and mixer against the JAX package.

* the plain chunked scan (``kernels.ssd.ref.ssd_chunked_ref``, the CPU
  path of ``kernels.ssd.ops.ssd_chunked``) against ``repro.models.ssm.
  ssd_chunked`` at the shapes of ``tests/test_ssm.py``, chunks 8 / 16 / 64,
  a ragged S and a carried ``state_init``: y and the final state within
  atol 1e-5 / rtol 1e-5 (the same float32 algorithm, sums in another
  order);
* the sequential recurrence ``ssd_ref`` against the JAX oracle, same bound;
* ``ops.ssd`` against the Pallas ``ssd`` in interpret mode at the
  ``test_ssd_sweep`` shapes and tolerances of ``tests/test_kernels.py``
  (float32 1e-3; bfloat16 atol 0.15 / rtol 0.1: y rounded to bf16 on both
  sides);
* ``mamba2_block`` (prefill, with and without an entering cache) and
  ``mamba2_decode_step`` against JAX: float32 within 1e-5, bfloat16 within
  3e-2 (one bf16 rounding of outputs of size ~1, where the frameworks
  round intermediates at other places).

Inputs are made with numpy from a seed and handed to both packages; on the
CPU the port runs its plain versions, which the CUDA kernel is held against
on the card (``tests/test_torch_cuda_model_kernels.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd import ssd as jssd
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.models import ssm as JS
from repro.models.spec import init_tree
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, P, N):
    """x, dt (post-softplus), Bv, Cv, A_log, D as float32 numpy arrays, the
    distributions of ``tests/test_ssm.py``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bv = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    Cv = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    A_log = rng.standard_normal(H).astype(np.float32) * 0.2
    D = np.ones(H, np.float32)
    return x, dt, Bv, Cv, A_log, D


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(j, t, dtype="float32", **tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               **(tol or TOL[dtype]))


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("S", [64, 50])
def test_ssd_chunked_matches_jax(chunk, S):
    """S = 50 leaves a ragged last chunk at every chunk size."""
    x, dt, Bv, Cv, A_log, D = _inputs(chunk + S, 2, S, 3, 8, 4)
    yj, sj = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A_log, Bv, Cv, D)), chunk)
    yt, st = ssd_chunked_ref(*_t(x, dt, A_log, Bv, Cv, D), chunk)
    assert yt.dtype == st.dtype == torch.float32
    assert tuple(yt.shape) == (2, S, 3, 8) and tuple(st.shape) == (2, 3, 8, 4)
    _close(yj, yt)
    _close(sj, st)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_carries_state_like_jax(chunk):
    """A second segment started from the first one's state (and from a
    random state) equals JAX's, and the two halves equal the whole."""
    x, dt, Bv, Cv, A_log, D = _inputs(3, 1, 64, 2, 8, 4)
    cut = 40
    head = [a[:, :cut] for a in (x, dt)] + [A_log] + [a[:, :cut] for a in (Bv, Cv)] + [D]
    tail = [a[:, cut:] for a in (x, dt)] + [A_log] + [a[:, cut:] for a in (Bv, Cv)] + [D]
    y1, s1 = ssd_chunked_ref(*_t(*head), chunk)
    s0 = np.random.default_rng(4).standard_normal((1, 2, 8, 4)).astype(np.float32)
    for init in (s1.numpy(), s0):
        yj, sj = JS.ssd_chunked(*map(jnp.asarray, tail), chunk, state_init=jnp.asarray(init))
        yt, st = ssd_chunked_ref(*_t(*tail), chunk, state_init=torch.as_tensor(init))
        _close(yj, yt)
        _close(sj, st)
    yf, sf = ssd_chunked_ref(*_t(x, dt, A_log, Bv, Cv, D), chunk)
    y2, s2 = ssd_chunked_ref(*_t(*tail), chunk, state_init=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yf, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2, sf, atol=1e-5, rtol=1e-5)


def test_ssd_ref_matches_jax():
    x, dt, Bv, Cv, A_log, D = _inputs(5, 1, 32, 6, 8, 4)
    BH = 6
    args = (x[0].transpose(1, 0, 2), dt[0].T, np.broadcast_to(Bv, (BH, 32, 4)).copy(),
            np.broadcast_to(Cv, (BH, 32, 4)).copy(), A_log, D)
    _close(jssd_ref(*map(jnp.asarray, args)), ssd_ref(*_t(*args)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 128, 1, 32, 16, 64),
])
def test_ssd_matches_pallas(B, S, H, P, N, chunk, dtype):
    jd, td = DTYPES[dtype]
    x, dt, Bv, Cv, A_log, D = _inputs(S + H + P, B, S, H, P, N)
    want = jssd(*(jnp.asarray(a, jd) for a in (x, dt, Bv, Cv)), jnp.asarray(A_log),
                jnp.asarray(D), chunk=chunk, interpret=True)
    got = tssd.ssd(*(torch.as_tensor(a).to(td) for a in (x, dt, Bv, Cv)),
                   *_t(A_log, D), chunk=chunk)
    assert got.dtype == td and tuple(got.shape) == (B, S, H, P)
    tol = dict(atol=1e-3, rtol=1e-3) if dtype == "float32" else dict(atol=0.15, rtol=0.1)
    _close(want, got, **tol)


def test_ops_ssd_chunked_takes_the_plain_version_on_the_cpu():
    x, dt, Bv, Cv, A_log, D = _t(*_inputs(6, 1, 40, 2, 8, 4))
    y, s = tssd.ssd_chunked(x, dt, A_log, Bv, Cv, D, 16)
    yr, sr = ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, 16)
    assert torch.equal(y, yr) and torch.equal(s, sr)


# ---------------------------------------------------------------------------
# the mixer


def _mixer(dtype):
    """(port cfg, JAX params, port params) of one reduced mamba2-130m mixer,
    JAX-initialised, in ``dtype``."""
    cfg_j = jax_get_config("mamba2-130m").reduced()
    pj = init_tree(JS.ssm_schema(cfg_j), jax.random.key(0))
    pj = jax.tree.map(lambda a: a.astype(jnp.float32) if dtype == "float32" else a, pj)
    pt = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).to(
        torch.float32 if dtype == "float32" or v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in pj.items()}
    return cfg_j, pj, get_config("mamba2-130m").reduced(), pt


def _u(cfg, B, S, dtype, seed):
    jd, td = DTYPES[dtype]
    u = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32) * 0.3
    return jnp.asarray(u, jd), torch.as_tensor(u).to(td)


def _close_tree(j, t, dtype):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close_tree(j[k], t[k], dtype)
        return
    assert tuple(t.shape) == j.shape
    _close(j, t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(dtype):
    """Prefill of 45 tokens (two 32-step chunks, a ragged tail) building the
    cache, then a second prefill of 20 tokens continuing from that cache."""
    cfg_j, pj, cfg_t, pt = _mixer(dtype)
    uj, ut = _u(cfg_j, 2, 65, dtype, 1)
    oj, cj = JS.mamba2_block(pj, uj[:, :45], cfg=cfg_j, return_cache=True)
    ot, ct = TS.mamba2_block(pt, ut[:, :45], cfg=cfg_t, return_cache=True)
    assert ot.dtype == ut.dtype
    _close(oj, ot, dtype)
    _close_tree(cj, ct, dtype)
    assert ct["state"].dtype == torch.float32 and ct["conv"]["x"].dtype == ut.dtype
    oj2 = JS.mamba2_block(pj, uj[:, 45:], cfg=cfg_j, cache=cj)
    ot2 = TS.mamba2_block(pt, ut[:, 45:], cfg=cfg_t, cache=ct)
    _close(oj2, ot2, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_step_matches_jax(dtype):
    """Three decode steps from a 30-token prefill's cache (from zeros too):
    outputs and the cache, which the port updates in place."""
    cfg_j, pj, cfg_t, pt = _mixer(dtype)
    uj, ut = _u(cfg_j, 2, 33, dtype, 2)
    _, cj = JS.mamba2_block(pj, uj[:, :30], cfg=cfg_j, return_cache=True)
    _, ct = TS.mamba2_block(pt, ut[:, :30], cfg=cfg_t, return_cache=True)
    zj = JS.init_ssm_cache(cfg_j, 2, DTYPES[dtype][0])
    zt = TS.init_ssm_cache(cfg_t, 2, DTYPES[dtype][1])
    for t in range(30, 33):
        oj, cj = JS.mamba2_decode_step(pj, uj[:, t:t + 1], cj, cfg=cfg_j)
        state = ct["state"]
        ot, ct2 = TS.mamba2_decode_step(pt, ut[:, t:t + 1], ct, cfg=cfg_t)
        assert ct2 is ct and ct["state"] is state  # updated in place
        _close(oj, ot, dtype)
        _close_tree(cj, ct, dtype)
        oj, zj = JS.mamba2_decode_step(pj, uj[:, t:t + 1], zj, cfg=cfg_j)
        ot, zt = TS.mamba2_decode_step(pt, ut[:, t:t + 1], zt, cfg=cfg_t)
        _close(oj, ot, dtype)


def test_prefill_then_decode_matches_forward():
    """The port's mirror of ``tests/test_ssm.py``'s block test, same bounds."""
    _, _, cfg, p = _mixer("float32")
    _, u = _u(cfg, 1, 33, "float32", 3)
    full = TS.mamba2_block(p, u, cfg=cfg)
    out_pre, cache = TS.mamba2_block(p, u[:, :32], cfg=cfg, return_cache=True)
    out_dec, _ = TS.mamba2_decode_step(p, u[:, 32:], cache, cfg=cfg)
    torch.testing.assert_close(out_pre, full[:, :32], atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(out_dec, full[:, 32:], atol=2e-3, rtol=2e-2)
