"""CUDA RMSNorm for Hopper: build, ctypes binding and wrappers.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas
kernels ``_kernel`` (``src/repro/kernels/rmsnorm/rmsnorm.py:16``, plain)
and ``_kernel_res`` (``:24``, with the residual add). It is bound by bytes
and reads each row from device memory once: one warp per row (several
warps for a wide row, or for few rows), the row held in registers across
the float32 sum of squares, which reduces with warp shuffles, then scaled
from those registers. Rows, outputs and the float32 weight move as 16-byte
vectors when ``d`` is a multiple of ``16 / itemsize`` and every pointer,
the weight's too, is 16-byte aligned; otherwise element by element.

For training, ``rmsnorm_bwd_cuda`` launches the backward kernel
(``csrc/rmsnorm_bwd.cu``: 16-byte chunks, two groups of threads a CTA with
two rows in flight each and one barrier a row, dx from registers; rows too
wide to hold are read twice, the second time from L2; dw as at most 132
float32 partial rows, one a CTA, summed in a fixed order by a second kernel
over d / 32 CTAs; no atomics). The JAX package
differentiates ``layers.rmsnorm`` (``repro/models/layers.py:18``) by
autodiff; it has no backward kernel to replace.

The library is built by ``repro_torch.kernels.build`` at first use on a
CUDA tensor, into ``_build/`` beside this file; importing builds nothing.
``LAUNCHES`` counts the launches of each kernel (the backward's two
separately: ``rmsnorm_bwd`` for dx and dw's partials, ``rmsnorm_bwd_dw``
for their reduction).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, refuse_grad, stream

SOURCES = (Path(__file__).parent / "csrc" / "rmsnorm.cu",
           Path(__file__).parent / "csrc" / "rmsnorm_bwd.cu")
MAX_BWD_D = 32768  # the widest row the backward kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each variant, counted where the wrapper launches it
LAUNCHES = {"rmsnorm": 0, "rmsnorm_residual": 0, "rmsnorm_bwd": 0, "rmsnorm_bwd_dw": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [vp] * 5 + [ci] * 4 + [ctypes.c_float, vp]
    lib.rmsnorm_launch.restype = ci
    lib.rmsnorm_bwd_launch.argtypes = [vp] * 5 + [ci] * 3 + [ctypes.c_float, vp]
    lib.rmsnorm_bwd_launch.restype = ci
    lib.rmsnorm_dw_launch.argtypes = [vp] * 2 + [ci] * 2 + [vp]
    lib.rmsnorm_dw_launch.restype = ci
    lib.rmsnorm_bwd_blocks.argtypes = [ci]
    lib.rmsnorm_bwd_blocks.restype = ci


LIBRARY = CudaLibrary("rmsnorm", SOURCES, Path(__file__).parent / "_build", _declare)


def _rows(name, t, d, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {device}")
    if t.dim() != 2 or t.shape[1] != d or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [N, {d}] tensor, got {tuple(t.shape)}")


def rmsnorm_cuda(x2, w, eps: float, res2=None):
    """Launch the kernel on ``x2`` [N, d] (float32 or bfloat16, contiguous,
    on a CUDA device) with ``w`` [d] float32. Returns the normed rows, or,
    with ``res2``, ``(normed, x2 + res2)``; outputs are fresh tensors."""
    refuse_grad("rmsnorm_cuda" if res2 is None else "rmsnorm_residual", x2, w, res2)
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors, got {dev}")
    if x2.dtype not in DTYPES:
        raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16, got {x2.dtype}")
    if x2.dim() != 2:
        raise ValueError(f"x2 must be [N, d], got {tuple(x2.shape)}")
    N, d = x2.shape
    _rows("x", x2, d, x2.dtype, dev)
    if w.device != dev or w.dtype != torch.float32 or tuple(w.shape) != (d,):
        raise ValueError(f"w must be a float32 [{d}] tensor on {dev}")
    w = w.contiguous()
    out = torch.empty_like(x2)
    res_out = None
    if res2 is not None:
        _rows("res", res2, d, x2.dtype, dev)
        res_out = torch.empty_like(x2)
    if N == 0:
        return out if res2 is None else (out, res_out)
    if N >= 2**31:
        raise ValueError("too many rows for one launch")
    vec = 16 // x2.element_size()
    vector = d % vec == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (x2, res2, out, res_out, w))
    err = LIBRARY.load().rmsnorm_launch(
        ptr(x2), ptr(res2), ptr(w), ptr(out), ptr(res_out), N, d,
        DTYPES[x2.dtype], int(vector), float(eps), stream(dev))
    kind = "rmsnorm" if res2 is None else "rmsnorm_residual"
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    return out if res2 is None else (out, res_out)


def rmsnorm_bwd_cuda(x2, w, dy2, eps: float):
    """The gradients (dx [N, d] in x's dtype, dw [d] float32) of
    ``rmsnorm_cuda(x2, w, eps)`` for the output gradient ``dy2`` [N, d]
    (x's dtype): the backward kernel and its dw reduction on the current
    stream. Returns fresh tensors; the inputs are only read."""
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_bwd_cuda needs CUDA tensors, got {dev}")
    if x2.dtype not in DTYPES or x2.dim() != 2:
        raise TypeError(f"x2 must be a float32 or bfloat16 [N, d] tensor, got {x2.dtype} "
                        f"{tuple(x2.shape)}")
    N, d = x2.shape
    _rows("x", x2, d, x2.dtype, dev)
    _rows("dy", dy2, d, x2.dtype, dev)
    if dy2.shape[0] != N:
        raise ValueError(f"dy: {tuple(dy2.shape)} rows, expected {N}")
    if w.device != dev or w.dtype != torch.float32 or tuple(w.shape) != (d,):
        raise ValueError(f"w must be a float32 [{d}] tensor on {dev}")
    if d > MAX_BWD_D:
        raise ValueError(f"the RMSNorm backward takes d <= {MAX_BWD_D}, got {d}")
    dx = torch.empty_like(x2)
    dw = torch.zeros((d,), dtype=torch.float32, device=dev)
    if N == 0 or d == 0:
        return dx, dw
    if N >= 2**31:
        raise ValueError("too many rows for one launch")
    lib = LIBRARY.load()
    partial = torch.empty((lib.rmsnorm_bwd_blocks(N), d), dtype=torch.float32, device=dev)
    st = stream(dev)
    err = lib.rmsnorm_bwd_launch(ptr(x2), ptr(w.contiguous()), ptr(dy2), ptr(dx),
                                 ptr(partial), N, d, DTYPES[x2.dtype], float(eps), st)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA error {err}")
    LAUNCHES["rmsnorm_bwd"] += 1
    err = lib.rmsnorm_dw_launch(ptr(partial), ptr(dw), N, d, st)
    if err != 0:
        raise RuntimeError(f"rmsnorm dw kernel launch failed: CUDA error {err}")
    LAUNCHES["rmsnorm_bwd_dw"] += 1
    return dx, dw
