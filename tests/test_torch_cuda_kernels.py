"""The CUDA router kernels against their plain PyTorch version, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``.
This file imports neither JAX nor ``repro``, so it runs where only PyTorch
is installed. The random snapshot and table builders here are shared with
the CPU parity tests in ``test_torch_noc_router.py``. Integer state, so the
tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.noc_router import noc_router as tkern
from repro_torch.kernels.noc_router import ref as tref
from repro_torch.kernels.noc_router.ref import F_DST, F_LAST, NF

P = 5


def _tables(rng, R, E):
    """Random routing/wiring tables; endpoint attachments are unique and
    ``port_ep`` is their inverse, as on every real topology."""
    route = rng.integers(0, P, (R, E)).astype(np.int32)
    # bias a third of the destinations to port 0 so heads contend for it
    route[:, : E // 3] = 0
    def links():
        t = np.stack([rng.integers(0, R, (R, P)), rng.integers(0, P, (R, P))],
                     -1).astype(np.int32)
        t[rng.random((R, P)) < 0.3] = -1
        return t
    slots = rng.permutation(R * P)[:E]
    ep_attach = np.stack([slots // P, slots % P], -1).astype(np.int32)
    port_ep = np.full((R, P), -1, np.int32)
    port_ep[ep_attach[:, 0], ep_attach[:, 1]] = np.arange(E)
    return dict(route=route, link_src=links(), link_dst=links(),
                port_ep=port_ep, ep_attach=ep_attach)


def _snapshot(rng, lead, R, E, din, dout):
    """Random consistent state of shape ``lead + [R, P, ...]``."""
    s = tuple(lead) + (R, P)

    def flits(d):
        f = rng.integers(-50, 50, s + (d, NF)).astype(np.int32)
        f[..., F_DST] = rng.integers(-2, E + 2, s + (d,))  # incl. clipped
        f[..., F_LAST] = rng.integers(0, 2, s + (d,))
        return f

    wh = rng.integers(-1, P, s).astype(np.int32)
    wh[rng.random(s) < 0.5] = -1
    return dict(
        in_buf=flits(din), in_cnt=rng.integers(0, din + 1, s).astype(np.int32),
        out_buf=flits(dout),
        out_cnt=rng.integers(0, dout + 1, s).astype(np.int32),
        rr_ptr=rng.integers(0, P, s).astype(np.int32), wh_lock=wh,
        ep_space=rng.random(tuple(lead) + (E,)) < 0.7)


@pytest.mark.gpu
@pytest.mark.parametrize("R,depth", [(32, 2), (32, 4), (1024, 2)])
def test_cuda_kernels_match_plain(R, depth):
    """The CUDA arb and apply kernels against the plain version on the
    card, bit for bit, and one launch of each per router cycle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(R + depth)
    E = 40 if R == 32 else 1056
    tb = {k: torch.as_tensor(v, device="cuda")
          for k, v in _tables(rng, R, E).items()}
    s = {k: torch.as_tensor(v, device="cuda")
         for k, v in _snapshot(rng, (3,), R, E, depth, depth).items()}
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
            s["wh_lock"], tb["route"], tb["link_src"], tb["link_dst"],
            tb["port_ep"], tb["ep_attach"], s["ep_space"])
    before = dict(tkern.LAUNCHES)
    got = tkern.router_cycle_cuda(*args)
    torch.cuda.synchronize()
    want = tref.router_cycle_reference(*args, fused=True)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"output {i} differs"
    assert tkern.LAUNCHES["arb"] == before["arb"] + 1
    assert tkern.LAUNCHES["apply"] == before["apply"] + 1
