"""The gradients of the port's attention and RMSNorm against the JAX
package's autodiff, on the CPU, and the routes of their ``ops`` entry
points when autograd records them.

The JAX package has no backward kernel: its training step differentiates
``attention_ref`` / ``flash_attention_jax`` (``repro/models/attention.py``)
and ``layers.rmsnorm`` by autodiff. On the CPU the port's entry points
(``kernels.*.ops``) run the plain versions, which autograd differentiates;
on a card they go through ``autograd.Function``s whose backward is a CUDA
kernel (held against the same plain autograd in
``test_torch_cuda_train.py`` and ``chip_smoke.py``). Inputs and output
gradients are numpy draws from a seed, rounded to bf16 alike on both
sides. Tolerances: float32 atol / rtol 2e-5 (scores and row sums in
another order; the gradients are of size ~1), bfloat16 3e-2 (the bf16
kernel tolerance of ``tests/test_kernels.py``: one rounding of the
gradient, the two frameworks rounding a float32 a ulp apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_ref as jattention_ref
from repro.models.attention import flash_attention_jax
from repro.models.layers import rmsnorm as jrmsnorm
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rmsnorm import ops as trms
from repro_torch.kernels.rmsnorm import rmsnorm as rkern

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _close(t, j, dtype, what=""):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)), err_msg=what,
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,impl", [
    (2, 64, 64, 4, 2, 32, True, "ref"),  # the reduced configs' D = 32
    (1, 128, 128, 6, 2, 64, True, "flash"),  # G = 3, JAX's blocked attention
    (1, 128, 128, 8, 1, 32, True, "flash"),  # G = 8
    (1, 65, 65, 4, 4, 64, True, "ref"),  # G = 1, a ragged tile
    (2, 48, 80, 4, 2, 64, False, "ref"),  # non-causal, Sq != Skv
])
def test_attention_grads_match_jax(B, Sq, Skv, H, KV, D, causal, impl, dtype):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D))]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype) for a in arrays)

    def jfn(q, k, v):
        if impl == "flash":
            return flash_attention_jax(q, k, v, causal=causal, block_q=64, block_k=64)
        return jattention_ref(q, k, v, causal=causal)

    jout, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jdo)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tflash.flash_attention(*leaves, causal=causal)
    out.backward(tdo)
    _close(out.detach(), jout, dtype, "out")
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, jg, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,causal,window,impl", [
    (1, 96, 96, 4, 2, 32, 32, True, 32, "flash"),  # a window, JAX's blocked attention
    (1, 96, 96, 4, 2, 32, 32, True, 32, "ref"),
    (1, 70, 70, 2, 1, 64, 64, False, 20, "ref"),  # a window, not causal
    (1, 128, 128, 4, 2, 256, 256, True, 48, "ref"),  # Gemma 3's D = 256 with a window
    (1, 80, 80, 4, 4, 192, 128, True, 0, "ref"),  # MLA's D = 192, Dv = 128
    (1, 64, 100, 2, 2, 192, 128, False, 0, "ref"),
])
def test_windowed_and_wide_attention_grads_match_jax(B, Sq, Skv, H, KV, D, Dv, causal, window,
                                                     impl, dtype):
    """The gradients the new backward instances compute (a sliding window;
    D = Dv = 256; D = 192 with Dv = 128), through the port's entry point on
    the CPU, against ``jax.vjp`` of the JAX attention."""
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv), (B, Sq, H, Dv))]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype) for a in arrays)

    def jfn(q, k, v):
        if impl == "flash":
            return flash_attention_jax(q, k, v, causal=causal, window=window, block_q=32,
                                       block_k=32)
        return jattention_ref(q, k, v, causal=causal, window=window)

    jout, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jdo)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tflash.flash_attention(*leaves, causal=causal, window=window)
    out.backward(tdo)
    _close(out.detach(), jout, dtype, "out")
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, jg, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 5, 3072), (1, 100)])
def test_rmsnorm_grads_match_jax(shape, dtype):
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    (jx, tx), (jdy, tdy) = _pair(x, dtype), _pair(dy, dtype)
    jout, vjp = jax.vjp(lambda x_, w_: jrmsnorm({"scale": w_}, x_, 1e-5), jx, jnp.asarray(w))
    jdx, jdw = vjp(jdy)
    xl, wl = tx.clone().requires_grad_(True), torch.as_tensor(w).requires_grad_(True)
    out = trms.rmsnorm(xl, wl, 1e-5)
    out.backward(tdy)
    _close(out.detach(), jout, dtype, "out")
    _close(xl.grad, jdx, dtype, "dx")
    assert xl.grad.dtype == xl.dtype and wl.grad.dtype == torch.float32
    # dw sums N rows in float32 on both sides: the float32 tolerance, scaled
    np.testing.assert_allclose(wl.grad.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-4 * np.sqrt(x.size / shape[-1]))


def test_cpu_route_is_the_plain_autograd():
    """On the CPU, a call that autograd records runs the plain version: no
    kernel is launched, and no ``autograd.Function`` stands in the graph."""
    before = {**fkern.LAUNCHES, **rkern.LAUNCHES}
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    out = tflash.flash_attention(q, q.detach(), q.detach())
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    x = torch.randn(3, 16, requires_grad=True)
    y = trms.rmsnorm(x, torch.ones(16))
    assert "RMSNormFn" not in type(y.grad_fn).__name__
    (out.sum() + y.sum()).backward()
    assert q.grad is not None and x.grad is not None
    assert {**fkern.LAUNCHES, **rkern.LAUNCHES} == before


def test_grad_route_on_the_card():
    """Where autograd records a call, the card takes the backward kernels (D
    = Dv in 32, 64, 112, 128 and 256, D = 192 with Dv = 128; the window is
    the kernels' argument); where they do not take the head dims it raises,
    naming the ROADMAP item; without a gradient it is the forward-only
    launch."""
    q = torch.zeros(1, 8, 2, 64)
    assert not tflash.grad_route(q, q, q)
    qg = q.clone().requires_grad_(True)
    assert tflash.grad_route(qg, q, q)
    with torch.no_grad():
        assert not tflash.grad_route(qg, q, q)
    for D, Dv in ((256, 256), (192, 128), (32, 32), (112, 112)):
        qd = torch.zeros(1, 8, 2, D, requires_grad=True)
        assert tflash.grad_route(qd, qd, torch.zeros(1, 8, 2, Dv))
    for D, Dv in ((48, 48), (128, 64), (256, 128), (192, 192)):
        qd = torch.zeros(1, 8, 2, D, requires_grad=True)
        with pytest.raises(NotImplementedError, match="item 12 step 7b"):
            tflash.grad_route(qd, qd, torch.zeros(1, 8, 2, Dv))


class _StandIn:
    """The CUDA wrappers replaced by the plain version, so that the
    ``autograd.Function``s' plumbing runs on the CPU: the forward returns
    the plain output (and the plain log-sum-exp), the backward the plain
    autograd's gradients; every call is recorded."""

    def __init__(self):
        self.calls = []

    def flash(self, q, k, v, *, causal=True, window=0, lse=False):
        from repro_torch.kernels.flash_attention.ref import attention_ref

        self.calls.append(("flash", lse, torch.is_grad_enabled(), window))
        out = attention_ref(q, k, v, causal=causal, window=window)
        return (out, torch.zeros(q.shape[0], q.shape[2], q.shape[1])) if lse else out

    def flash_bwd(self, q, k, v, out, dout, lse, *, causal=True, window=0):
        from repro_torch.kernels.flash_attention.ref import attention_ref

        self.calls.append(("flash_bwd", dout.is_contiguous(), window))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            return torch.autograd.grad(attention_ref(*leaves, causal=causal, window=window),
                                       leaves, dout)

    def rms(self, x2, w, eps, res2=None):
        from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

        self.calls.append(("rms", torch.is_grad_enabled()))
        return rmsnorm_ref(x2, w, eps)

    def rms_bwd(self, x2, w, dy2, eps):
        from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

        self.calls.append(("rms_bwd", dy2.is_contiguous()))
        xl, wl = (t.detach().requires_grad_(True) for t in (x2, w))
        with torch.enable_grad():
            return torch.autograd.grad(rmsnorm_ref(xl, wl, eps), (xl, wl), dy2)


def test_functions_carry_the_gradients(monkeypatch):
    """``FlashAttentionFn`` and ``RMSNormFn`` with stand-in kernels: the
    forward is launched with grad mode off and asks for the log-sum-exp, the
    window reaches both kernels, the backward gets a contiguous output
    gradient, and the gradients reaching the leaves equal the plain
    autograd's."""
    s = _StandIn()
    monkeypatch.setattr(tflash, "flash_attention_cuda", s.flash)
    monkeypatch.setattr(tflash, "flash_attention_bwd_cuda", s.flash_bwd)
    monkeypatch.setattr(trms, "rmsnorm_cuda", s.rms)
    monkeypatch.setattr(trms, "rmsnorm_bwd_cuda", s.rms_bwd)
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 16, h, 32)), dtype=torch.float32)
               for h in (4, 2, 2))
    x = torch.as_tensor(rng.standard_normal((2, 16, 32)), dtype=torch.float32)
    w = torch.ones(32)

    def loss(fn_attn, fn_rms, leaves):
        qq, kk, vv, xx, ww = leaves
        o = fn_attn(qq, kk, vv)
        # a transposed output gradient reaches the backward
        return (o.transpose(1, 2) ** 2).sum() + (fn_rms(xx, ww, 1e-5) ** 3).sum()

    got = [t.clone().requires_grad_(True) for t in (q, k, v, x, w)]
    loss(lambda *a: tflash.FlashAttentionFn.apply(*a, True, 6),
         lambda x_, w_, e: trms.RMSNormFn.apply(x_.reshape(-1, 32), w_, e).reshape(x_.shape),
         got).backward()
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    want = [t.clone().requires_grad_(True) for t in (q, k, v, x, w)]
    loss(lambda *a: attention_ref(*a, window=6), rmsnorm_ref, want).backward()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)
    assert ("flash", True, False, 6) in s.calls and ("rms", False) in s.calls
    assert ("flash_bwd", True, 6) in s.calls and ("rms_bwd", True) in s.calls


def test_wrappers_refuse_a_gradient():
    """A kernel launched through ``ctypes`` outside an ``autograd.Function``
    would cut the graph silently: every wrapper refuses a gradient before it
    looks at the device."""
    from repro_torch.kernels.kv_gather.kv_gather import kv_gather_cuda
    from repro_torch.kernels.ssd import ssd as skern

    g = torch.zeros((2, 64), requires_grad=True)
    calls = [
        lambda: rkern.rmsnorm_cuda(g, torch.ones(64), 1e-5, res2=g),
        lambda: rkern.rmsnorm_cuda(g, torch.ones(64), 1e-5),
        lambda: fkern.flash_attention_cuda(g.reshape(1, 2, 2, 32), g.reshape(1, 2, 2, 32),
                                           g.reshape(1, 2, 2, 32)),
        lambda: kv_gather_cuda(g.reshape(2, 1, 64), torch.zeros((1, 1), dtype=torch.int32)),
        lambda: skern.ssd_cuda(g.reshape(1, 2, 2, 32), g[0, :4].reshape(1, 2, 2), g, g,
                               g[0, :2], g[0, :2], 2),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="item 12 step 7b"):
            call()
    with torch.no_grad():  # grad mode off: the device check answers
        with pytest.raises(ValueError, match="CUDA"):
            calls[1]()
    assert build.wants_grad(g) and not build.wants_grad(g.detach(), None)
