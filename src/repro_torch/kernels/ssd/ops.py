"""Public SSD entry points, dispatched on the device: a CPU tensor runs the
plain version (``ref.ssd_chunked_ref``), which autograd differentiates, a
CUDA tensor the kernel (``ssd.ssd_cuda``) or raises.

* ``ssd`` is the counterpart of the JAX package's ``repro.kernels.ssd.ops.
  ssd`` (``[B, S, H, P]`` layout, y in x's dtype);
* ``ssd_chunked`` is the counterpart of ``repro.models.ssm.ssd_chunked``
  (y and the final state in float32), the model's entry.

On a card, when autograd records the call (grad mode on and an input
requiring a gradient), ``ssd_chunked`` goes through ``SSDFn``: the forward
is the kernel's instance that also writes the state entering each chunk,
and the backward is the three backward kernels (``ssd.ssd_bwd_cuda``: in
bf16 on the tensor cores, dB and dC summed over a group of heads in a CTA;
in float32 on scalar FMAs). Otherwise the call is the forward-only launch
serving makes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import wants_grad
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.kernels.ssd.ssd import ssd_bwd_cuda, ssd_cuda


class SSDFn(torch.autograd.Function):
    """The SSD kernel with its backward kernels, for CUDA tensors already in
    the kernel's dtypes (``ssd_chunked`` converts them)."""

    @staticmethod
    def forward(ctx, x, dt, A_log, Bv, Cv, D, chunk, state_init):
        y, final, states = ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk, state_init, states=True)
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None
        ctx.save_for_backward(x, dt, A_log, Bv, Cv, D, states)
        ctx.chunk = chunk
        ctx.want_dstate = state_init is not None and ctx.needs_input_grad[7]
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A_log, Bv, Cv, D, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA_log, dB, dC, dD, ds0 = ssd_bwd_cuda(
            x, dt, Bv, Cv, A_log, D, ctx.chunk, states, dy.contiguous(),
            None if d_final is None else d_final.contiguous(), want_dstate=ctx.want_dstate)
        return dx, ddt, dA_log, dB, dC, dD, None, ds0


def ssd_chunked(x, dt, A_log, Bv, Cv, D, chunk: int, state_init=None):
    """x [B, S, H, P]; dt [B, S, H] (post-softplus); Bv, Cv [B, S, N]; A_log,
    D [H]; state_init [B, H, P, N] or None. Returns (y [B, S, H, P] float32,
    final state [B, H, P, N] float32)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, chunk, state_init)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    args = (x.contiguous(), f32(dt), f32(A_log), Bv.to(x.dtype).contiguous(),
            Cv.to(x.dtype).contiguous(), f32(D), chunk,
            None if state_init is None else f32(state_init))
    if wants_grad(*args[:6], args[7]):
        return SSDFn.apply(*args)
    x_, dt_, A_log_, Bv_, Cv_, D_, _, s0 = args
    return ssd_cuda(x_, dt_, Bv_, Cv_, A_log_, D_, chunk, s0)


def ssd(x, dt, Bv, Cv, A_log, D, chunk: int = 128):
    """x [B, S, H, P]; dt [B, S, H]; Bv, Cv [B, S, N] (shared across heads);
    A_log, D [H]. Returns y [B, S, H, P] in x's dtype."""
    return ssd_chunked(x, dt, A_log, Bv, Cv, D, chunk)[0].to(x.dtype)
