"""CUDA flash attention for Hopper: build, ctypes binding and wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
kernel ``_kernel`` (``src/repro/kernels/flash_attention/flash_attention.py:23``,
launched by ``flash_attention_bhsd`` behind ``ops.flash_attention``). It
reads the ``[B, S, H, D]`` layout directly and indexes KV head
``h // (H // KV)``, so neither the transpose nor the GQA broadcast of the
JAX wrapper is materialised. bfloat16 runs on the tensor cores through
``wgmma`` (float32 accumulation; P rounded to bf16 in registers before
``P V``): 128 query rows a CTA (one warpgroup for both 64-row halves, or
one warpgroup each at D = Dv = 256; MLA's D = 192 with Dv = 128 as the
former), bf16 tiles in shared memory in the
128-byte-swizzled layout, fed by a two-stage ``cp.async`` ring; at the
serve paths' shapes it is bound by bytes. float32 keeps a kernel of scalar
float32 FMAs, since the tensor cores would compute in TF32. ``window > 0``
is the sliding-window mode of the JAX package's ``flash_attention_jax``
(``repro/models/attention.py:67, :134``): key tiles outside every row's
window are never loaded, the edge tiles are masked.

The library is built by ``repro_torch.kernels.build`` at first use on a
CUDA tensor, into ``_build/`` beside this file; importing builds nothing.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, stream

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# D and Dv the kernel is built for in any pair (112: Zamba2), and the (D, Dv)
# pairs built alone: Gemma 3's 256 and MLA's 192 (128 + 64 rotary) with 128
HEAD_DIMS = (32, 64, 112, 128)
PAIRS = ((256, 256), (192, 128))

# launches, counted where the wrapper launches the kernel
LAUNCHES = {"flash_attention": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [ci] * 10 + [ctypes.c_float, vp]
    lib.flash_attention_launch.restype = ci


LIBRARY = CudaLibrary("flash_attention", SOURCES, Path(__file__).parent / "_build",
                      _declare)


def admits(D: int, Dv: int) -> bool:
    """Whether the kernel is built for head dims (D, Dv)."""
    return (D in HEAD_DIMS and Dv in HEAD_DIMS) or (D, Dv) in PAIRS


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel on contiguous CUDA tensors q [B, Sq, H, D], k
    [B, Skv, KV, D], v [B, Skv, KV, Dv] (float32 or bfloat16, one dtype;
    bf16 tensors 16-byte aligned, as every fresh allocation is).
    Scores scale by ``D ** -0.5``; ``window > 0`` (Sq == Skv) masks keys
    with ``qpos - kpos >= window``. Returns a fresh [B, Sq, H, Dv] tensor;
    the inputs are only read."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, heads, head_dim]")
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Skv, KV, D) or tuple(v.shape[:3]) != (B, Skv, KV):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if not admits(D, Dv):
        raise ValueError(f"head dims must be in {HEAD_DIMS} or a pair of {PAIRS}, "
                         f"got D={D}, Dv={Dv}")
    if window < 0 or (window and Sq != Skv):
        raise ValueError(f"window {window}: must be >= 0, and > 0 only with Sq == Skv "
                         f"(got Sq={Sq}, Skv={Skv})")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds one launch's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: must be a contiguous {q.dtype} tensor on {dev}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernel copies 16-byte rows; the tensor "
                             "must start 16-byte aligned")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over zero keys")
    err = LIBRARY.load().flash_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), B, H, KV, Sq, Skv, D, Dv,
        DTYPES[q.dtype], int(causal), int(window), D ** -0.5, stream(dev))
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
