"""Public SSD entry points, dispatched on the device: a CPU tensor runs the
plain version (``ref.ssd_chunked_ref``), a CUDA tensor the kernel
(``ssd.ssd_cuda``) or raises.

* ``ssd`` is the counterpart of the JAX package's ``repro.kernels.ssd.ops.
  ssd`` (``[B, S, H, P]`` layout, y in x's dtype);
* ``ssd_chunked`` is the counterpart of ``repro.models.ssm.ssd_chunked``
  (y and the final state in float32), the model's entry.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.kernels.ssd.ssd import ssd_cuda


def ssd_chunked(x, dt, A_log, Bv, Cv, D, chunk: int, state_init=None):
    """x [B, S, H, P]; dt [B, S, H] (post-softplus); Bv, Cv [B, S, N]; A_log,
    D [H]; state_init [B, H, P, N] or None. Returns (y [B, S, H, P] float32,
    final state [B, H, P, N] float32)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk, state_init)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    return ssd_cuda(x.contiguous(), f32(dt), Bv.to(x.dtype).contiguous(),
                    Cv.to(x.dtype).contiguous(), f32(A_log), f32(D), chunk,
                    None if state_init is None else f32(state_init))


def ssd(x, dt, Bv, Cv, A_log, D, chunk: int = 128):
    """x [B, S, H, P]; dt [B, S, H]; Bv, Cv [B, S, N] (shared across heads);
    A_log, D [H]. Returns y [B, S, H, P] in x's dtype."""
    return ssd_chunked(x, dt, A_log, Bv, Cv, D, chunk)[0].to(x.dtype)
