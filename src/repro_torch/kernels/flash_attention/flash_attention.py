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

For training the forward also writes each row's log-sum-exp (``lse=True``),
and ``flash_attention_bwd_cuda`` launches the two backward kernels
(``csrc/flash_attention_bwd.cu``: dQ, which also writes Delta = rowsum(dO
O), then dK / dV, which sums a KV head's group of query heads in one CTA;
no atomics; D = Dv in ``HEAD_DIMS`` or a pair of ``PAIRS``, with or without
a window). bfloat16 runs them on the tensor cores through the forward's two
``wgmma`` forms (``csrc/wgmma.cuh``, shared by both sources; P and dS
rounded to bf16 in registers before the products that take them; two
warpgroups a CTA at the pairs), float32 on scalar float32 FMAs. The JAX package
differentiates ``flash_attention_jax`` / ``attention_ref``
(``repro/models/attention.py:75, :34``) by autodiff; it has no backward
kernel to replace.

The libraries are built by ``repro_torch.kernels.build`` at first use on a
CUDA tensor, into ``_build/`` beside this file; importing builds nothing.
``LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, refuse_grad, stream

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)
BWD_SOURCES = (Path(__file__).parent / "csrc" / "flash_attention_bwd.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# D and Dv the kernel is built for in any pair (112: Zamba2), and the (D, Dv)
# pairs built alone: Gemma 3's 256 and MLA's 192 (128 + 64 rotary) with 128
HEAD_DIMS = (32, 64, 112, 128)
PAIRS = ((256, 256), (192, 128))

# launches, counted where the wrapper launches each kernel
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 5 + [ci] * 10 + [ctypes.c_float, vp]
    lib.flash_attention_launch.restype = ci


def _declare_bwd(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.flash_bwd_dq_launch, lib.flash_bwd_dkdv_launch):
        fn.argtypes = [vp] * 8 + [ci] * 10 + [ctypes.c_float, vp]
        fn.restype = ci


LIBRARY = CudaLibrary("flash_attention", SOURCES, Path(__file__).parent / "_build",
                      _declare)
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", BWD_SOURCES,
                          Path(__file__).parent / "_build", _declare_bwd)


def admits(D: int, Dv: int) -> bool:
    """Whether the kernel is built for head dims (D, Dv)."""
    return (D in HEAD_DIMS and Dv in HEAD_DIMS) or (D, Dv) in PAIRS


def admits_grad(D: int, Dv: int) -> bool:
    """Whether the backward kernels (and the forward's log-sum-exp) take head
    dims (D, Dv): D == Dv in ``HEAD_DIMS``, or a pair of ``PAIRS``; with or
    without a window."""
    return (D == Dv and D in HEAD_DIMS) or (D, Dv) in PAIRS


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         lse: bool = False):
    """Launch the kernel on contiguous CUDA tensors q [B, Sq, H, D], k
    [B, Skv, KV, D], v [B, Skv, KV, Dv] (float32 or bfloat16, one dtype;
    bf16 tensors 16-byte aligned, as every fresh allocation is).
    Scores scale by ``D ** -0.5``; ``window > 0`` (Sq == Skv) masks keys
    with ``qpos - kpos >= window``. Returns a fresh [B, Sq, H, Dv] tensor,
    or with ``lse`` also each row's float32 log-sum-exp [B, H, Sq] (+inf
    for a row that sees no key); the inputs are only read."""
    refuse_grad("flash_attention_cuda", q, k, v)
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
    if lse and not admits_grad(D, Dv):
        raise ValueError(f"the log-sum-exp is built only at the backward kernels' head dims "
                         f"(D == Dv in {HEAD_DIMS}, or a pair of {PAIRS}), got D={D}, Dv={Dv}")
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
    ls = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if lse else None
    if out.numel() == 0:
        return (out, ls) if lse else out
    if Skv == 0:
        raise ValueError("attention over zero keys")
    err = LIBRARY.load().flash_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(ls), B, H, KV, Sq, Skv, D, Dv,
        DTYPES[q.dtype], int(causal), int(window), D ** -0.5, stream(dev))
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return (out, ls) if lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention_cuda(q, k, v,
    causal=causal, window=window)`` for the output gradient ``dout``, from
    its output ``out`` and log-sum-exp ``lse`` [B, H, Sq]: the dQ kernel
    (which also writes Delta), then the dK / dV kernel, on the current
    stream. q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv], out and
    dout [B, Sq, H, Dv]; all contiguous CUDA tensors of q's dtype (lse
    float32; bf16 tensors 16-byte aligned, as every fresh allocation is);
    (D, Dv) as ``admits_grad`` takes them. Returns fresh tensors; the
    inputs are only read."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash-attention backward takes float32 or bfloat16, got {q.dtype}")
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if not admits_grad(D, Dv):
        raise ValueError(f"the backward kernels take D == Dv in {HEAD_DIMS} or a pair of "
                         f"{PAIRS}, got D={D}, Dv={Dv}")
    if window < 0 or (window and Sq != Skv):
        raise ValueError(f"window {window}: must be >= 0, and > 0 only with Sq == Skv "
                         f"(got Sq={Sq}, Skv={Skv})")
    shapes = {"k": (B, Skv, KV, D), "v": (B, Skv, KV, Dv), "out": (B, Sq, H, Dv),
              "dout": (B, Sq, H, Dv)}
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: must be a contiguous {q.dtype} tensor on {dev}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernels copy 16-byte rows; the tensor "
                             "must start 16-byte aligned")
    if (lse.device != dev or lse.dtype != torch.float32 or not lse.is_contiguous()
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"lse: must be a contiguous float32 [{B}, {H}, {Sq}] tensor on {dev}")
    if KV < 1 or H % KV or B * H > 65535:
        raise ValueError(f"{H} query heads over {KV} KV heads, B = {B}: not launchable")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    lib, st, dt = BWD_LIBRARY.load(), stream(dev), DTYPES[q.dtype]
    err = lib.flash_bwd_dq_launch(ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse),
                                  ptr(dq), ptr(delta), B, H, KV, Sq, Skv, D, Dv, dt,
                                  int(causal), int(window), D ** -0.5, st)
    if err != 0:
        raise RuntimeError(f"flash-attention dQ kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    err = lib.flash_bwd_dkdv_launch(ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta),
                                    ptr(dk), ptr(dv), B, H, KV, Sq, Skv, D, Dv, dt,
                                    int(causal), int(window), D ** -0.5, st)
    if err != 0:
        raise RuntimeError(f"flash-attention dK/dV kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd_dkdv"] += 1
    return dq, dk, dv
