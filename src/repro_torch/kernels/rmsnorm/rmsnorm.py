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

The library is built by ``repro_torch.kernels.build`` at first use on a
CUDA tensor, into ``_build/`` beside this file; importing builds nothing.
``LAUNCHES`` counts the launches of each variant.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, stream

SOURCES = (Path(__file__).parent / "csrc" / "rmsnorm.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each variant, counted where the wrapper launches it
LAUNCHES = {"rmsnorm": 0, "rmsnorm_residual": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [vp] * 5 + [ci] * 4 + [ctypes.c_float, vp]
    lib.rmsnorm_launch.restype = ci


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
