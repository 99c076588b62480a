"""Public RMSNorm entry points over any leading dims, dispatched on the
device: a CPU tensor runs the plain version (``ref``), a CUDA tensor the
kernel (``rmsnorm.rmsnorm_cuda``) or raises. The counterparts of the JAX
package's ``repro.kernels.rmsnorm.ops``."""
from __future__ import annotations

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda


def _on_cuda(x) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RMSNorm kernel for device {x.device}")
    return x.device.type == "cuda"


def rmsnorm(x, w, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` in float32, in ``x``'s dtype."""
    if not _on_cuda(x):
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    return rmsnorm_cuda(x.reshape(-1, d).contiguous(), w, eps).reshape(x.shape)


def rmsnorm_residual(x, res, w, eps: float = 1e-5):
    """``s = x + res`` in float32 -> ``(rmsnorm(s), s)`` in ``x``'s dtype."""
    if not _on_cuda(x):
        return rmsnorm_residual_ref(x, res, w, eps)
    d = x.shape[-1]
    out, s = rmsnorm_cuda(x.reshape(-1, d).contiguous(), w, eps,
                          res2=res.reshape(-1, d).contiguous())
    return out.reshape(x.shape), s.reshape(x.shape)
