"""The gradient of the SSD scan: the port's plain backward
(``kernels.ssd.ref.ssd_chunked_bwd_ref``, the backward kernels' passes in
PyTorch and their yardstick on the card) against ``jax.vjp`` of
``repro.models.ssm.ssd_chunked`` and against autograd of the plain forward
``ssd_chunked_ref``, and ``ops.SSDFn``'s plumbing with stand-in kernels.

Float32 on the CPU; each gradient within 1e-5 of its largest magnitude
(the same algorithm, sums in another order), but dA_log against the plain
forward's autograd within ``DA_LOG_REL``: it sums terms over every position
that cancel, and both float32 evaluations round it to about 1e-5 of its
largest value (against a float64 evaluation of the same cases, up to 8.5e-6
for the plain backward and 1.4e-5 for autograd). Cases: S a multiple of the
chunk (96) and ragged (100) at Q 32, with and without an entering state and
a cotangent of the final state, N 8 and 16, P 16, H 3. The kernels
themselves are held against ``ssd_chunked_bwd_ref`` on the card
(``tests/test_torch_cuda_train.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.kernels.ssd import ssd as skern
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref, ssd_chunked_ref

torch.set_num_threads(1)

REL = 1e-5  # of each gradient's largest magnitude
DA_LOG_REL = 5e-5  # dA_log against the plain forward's autograd (see above)
NAMES = ("dx", "ddt", "dA_log", "dBv", "dCv", "dD", "dstate_init")
CASES = [(S, N, init, fin) for S in (96, 100) for N in (8, 16)
         for init, fin in ((False, False), (True, True), (True, False), (False, True))]


def _inputs(seed, B, S, H, P, N, init, fin):
    """x, dt (post-softplus), A_log, Bv, Cv, D, state_init, dy, d_final as
    float32 numpy arrays (None where absent)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bv, Cv = f(B, S, H, P) * 0.5, f(B, S, N) * 0.5, f(B, S, N) * 0.5
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    A_log, D = f(H) * 0.2, 1 + 0.1 * f(H)
    s0 = f(B, H, P, N) * 0.5 if init else None
    dy = f(B, S, H, P)
    dfin = f(B, H, P, N) if fin else None
    return x, dt, A_log, Bv, Cv, D, s0, dy, dfin


def _close(got, want, name, rel=REL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=name)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("S,N,init,fin", CASES)
def test_bwd_ref_matches_jax_vjp(S, N, init, fin):
    x, dt, A_log, Bv, Cv, D, s0, dy, dfin = _inputs(S + N, 2, S, 3, 16, N, init, fin)
    Q = 32

    def f(x, dt, A_log, Bv, Cv, D, *s):
        return JS.ssd_chunked(x, dt, A_log, Bv, Cv, D, Q, state_init=s[0] if s else None)

    primals = [jnp.asarray(a) for a in (x, dt, A_log, Bv, Cv, D)] + (
        [jnp.asarray(s0)] if init else [])
    (y, fs), vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin) if fin else jnp.zeros_like(fs)))
    got = ssd_chunked_bwd_ref(*map(_t, (x, dt, A_log, Bv, Cv, D)), Q, _t(s0), _t(dy), _t(dfin))
    assert (got[6] is None) == (not init)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("S,N,init,fin", CASES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(S, N, init, fin):
    x, dt, A_log, Bv, Cv, D, s0, dy, dfin = _inputs(7 * S + N, 2, S, 3, 16, N, init, fin)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (x, dt, A_log, Bv, Cv, D)]
    if init:
        leaves.append(torch.as_tensor(s0).requires_grad_(True))
    y, fs = ssd_chunked_ref(*leaves[:6], 32, leaves[6] if init else None)
    loss = (y * _t(dy)).sum() + ((fs * _t(dfin)).sum() if fin else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ssd_chunked_bwd_ref(*map(_t, (x, dt, A_log, Bv, Cv, D)), 32, _t(s0), _t(dy), _t(dfin))
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name, DA_LOG_REL if name == "dA_log" else REL)


class _StandIn:
    """``ssd_cuda`` and ``ssd_bwd_cuda`` replaced by the plain versions, so
    that ``SSDFn``'s plumbing runs on the CPU; every call is recorded."""

    def __init__(self):
        self.calls = []

    def fwd(self, x, dt, Bv, Cv, A_log, D, chunk, state_init=None, *, states=False):
        self.calls.append(("ssd", states, torch.is_grad_enabled()))
        y, fs = ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk, state_init)
        self.state_init = state_init
        nC = -(-x.shape[1] // min(chunk, x.shape[1]))
        return y, fs, torch.zeros((x.shape[0], nC, *fs.shape[1:]))

    def bwd(self, x, dt, Bv, Cv, A_log, D, chunk, states, dy, d_final_state=None,
            want_dstate=False):
        self.calls.append(("ssd_bwd", dy.is_contiguous(), d_final_state is None, want_dstate))
        got = ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, chunk, self.state_init, dy,
                                  d_final_state)
        return (*got[:6], got[6] if want_dstate else None)


@pytest.mark.parametrize("use_final", [False, True])
def test_ssd_fn_carries_the_gradients(monkeypatch, use_final):
    """``SSDFn`` with stand-in kernels: the forward asks for the states with
    grad mode off, the backward gets a contiguous output gradient (and no
    final-state gradient where the final state is unused), and the gradients
    reaching the leaves, the entering state's included, equal the plain
    autograd's."""
    s = _StandIn()
    monkeypatch.setattr(tssd, "ssd_cuda", s.fwd)
    monkeypatch.setattr(tssd, "ssd_bwd_cuda", s.bwd)
    arrays = _inputs(3, 2, 100, 3, 16, 8, True, False)[:7]

    def loss(fn, leaves):
        y, fs = fn(*leaves[:6], 32, leaves[6])
        out = (y.transpose(1, 2) ** 2).sum()  # a transposed output gradient
        return out + (fs ** 3).sum() if use_final else out

    got = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    loss(tssd.SSDFn.apply, got).backward()
    want = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    loss(ssd_chunked_ref, want).backward()
    for name, a, b in zip(NAMES, got, want):
        _close(a.grad.numpy(), b.grad.numpy(), name, DA_LOG_REL if name == "dA_log" else REL)
    assert ("ssd", True, False) in s.calls
    assert ("ssd_bwd", True, not use_final, True) in s.calls


def test_cpu_route_is_the_plain_autograd():
    """On the CPU, ``ssd_chunked`` under autograd runs the plain version: no
    kernel is launched and no ``SSDFn`` stands in the graph; the kernel
    wrapper itself still refuses a gradient."""
    before = dict(skern.LAUNCHES)
    x, dt, A_log, Bv, Cv, D = (torch.as_tensor(a) for a in
                               _inputs(5, 1, 40, 2, 16, 8, False, False)[:6])
    xg = x.clone().requires_grad_(True)
    y, _ = tssd.ssd_chunked(xg, dt, A_log, Bv, Cv, D, 16)
    assert "SSDFn" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert xg.grad is not None and dict(skern.LAUNCHES) == before
    assert set(skern.LAUNCHES) == {"ssd", "ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_reduce"}
    with pytest.raises(NotImplementedError, match="item 12 step 7b"):
        skern.ssd_cuda(xg, dt, Bv, Cv, A_log, D, 16)
    with pytest.raises(ValueError, match="CUDA"):
        skern.ssd_bwd_cuda(x, dt, Bv, Cv, A_log, D, 16, None, y.detach())
    assert build.wants_grad(xg) and not build.wants_grad(x)
