"""CUDA paged KV gather for Hopper: build, ctypes binding and wrapper.

The kernel (``csrc/kv_gather.cu``) replaces the JAX package's Pallas
kernel ``_kernel`` (``src/repro/kernels/kv_gather/kv_gather.py:17``,
launched by ``kv_gather_paged``). It is bound by bytes: one CTA per
(sequence, page slot) reads its page id once and copies the page with
16-byte vector loads and stores (a narrower unit when the page bytes or a
pointer are not 16-byte aligned). It moves bytes, so one kernel serves
every dtype.

The library is built by ``repro_torch.kernels.build`` at first use on a
CUDA tensor, into ``_build/`` beside this file; importing builds nothing.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, refuse_grad, stream

SOURCES = (Path(__file__).parent / "csrc" / "kv_gather.cu",)
INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
UNITS = (16, 8, 4, 2, 1)  # bytes one thread moves per access, widest first

# launches of the kernel, counted where the wrapper launches it
LAUNCHES = {"kv_gather": 0}


def _declare(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kv_gather_launch.argtypes = [vp, vp, ci, vp, ll, ll, ll, ci, vp]
    lib.kv_gather_launch.restype = ci


LIBRARY = CudaLibrary("kv_gather", SOURCES, Path(__file__).parent / "_build", _declare)


def check_table(table, n_pages: int) -> None:
    """Raise ``ValueError`` unless ``table`` is a [B, max_pages] int32 or
    int64 tensor of ids in ``[0, n_pages)`` (one host sync on the card)."""
    if table.dtype not in INDEX_DTYPES:
        raise ValueError(f"the page table must be int32 or int64, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"the page table must be [B, max_pages], got {tuple(table.shape)}")
    if table.numel():
        lo, hi = (int(v) for v in torch.aminmax(table))
        if lo < 0 or hi >= n_pages:
            raise ValueError(f"page ids must lie in [0, {n_pages}), got [{lo}, {hi}]")


def kv_gather_cuda(pages, table):
    """Launch the kernel: ``pages`` [n_pages, page, KVD] (any dtype,
    contiguous) and ``table`` [B, max_pages] (int32 or int64) on one CUDA
    device. Returns a fresh [B, max_pages * page, KVD] tensor. The ids are
    not checked here (``ops.kv_gather`` does): the kernel writes zeros for
    an id out of range and never reads outside ``pages``."""
    refuse_grad("kv_gather_cuda", pages)
    dev = pages.device
    if dev.type != "cuda":
        raise ValueError(f"kv_gather_cuda needs CUDA tensors, got {dev}")
    if table.device != dev:
        raise ValueError(f"the page table is on {table.device}, the pages on {dev}")
    if table.dtype not in INDEX_DTYPES or table.dim() != 2:
        raise ValueError(f"the page table must be an int32 or int64 [B, max_pages] "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if pages.dim() != 3 or not pages.is_contiguous():
        raise ValueError(f"pages must be a contiguous [n_pages, page, KVD] tensor, "
                         f"got {tuple(pages.shape)}")
    n_pages, page, KVD = pages.shape
    B, mp = table.shape
    table = table.contiguous()
    out = torch.empty((B, mp * page, KVD), dtype=pages.dtype, device=dev)
    row_bytes = page * KVD * pages.element_size()
    n_rows = B * mp
    if n_rows == 0 or row_bytes == 0:
        return out
    if n_rows >= 2**31:
        raise ValueError("too many page slots for one launch")
    unit = next(u for u in UNITS if row_bytes % u == 0 and pages.data_ptr() % u == 0
                and out.data_ptr() % u == 0)
    err = LIBRARY.load().kv_gather_launch(
        ptr(pages), ptr(table), INDEX_DTYPES[table.dtype], ptr(out), n_pages,
        row_bytes, n_rows, unit, stream(dev))
    if err != 0:
        raise RuntimeError(f"kv_gather kernel launch failed: CUDA error {err}")
    LAUNCHES["kv_gather"] += 1
    return out
