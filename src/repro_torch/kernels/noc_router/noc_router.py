"""CUDA router cycle for Hopper: build, ctypes binding and wrappers.

One simulated cycle of the channel-batched fabric is two kernel launches
(``csrc/noc_router.cu``), the counterparts of the JAX package's Pallas
``_arb_kernel`` and ``_apply_kernel``:

1. **arb** — one thread per (channel, router): round-robin output
   arbitration from the cycle-start snapshot, written to scratch tensors
   (``arb_pop``, ``granted``, ``chosen``, ``rr_ptr'``, ``wh_lock'``,
   post-pop ``in_space``).
2. **apply** — one thread per (channel, router, port): link resolution
   against the fabric-wide snapshot plus the fused FIFO update of both
   sides, into freshly allocated output buffers (never in place).

The launch boundary is the arb -> link barrier: ``in_space`` of every
router must be visible before any link decision.

The library is built with ``nvcc`` for ``sm_90a`` at first use on a CUDA
tensor, keyed by a hash of the sources, into ``_build/`` beside this file;
importing the module builds nothing. It exposes a plain C interface loaded
with ``ctypes``. ``LAUNCHES`` counts the launches of each kernel, so a run
can show that it went through them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from repro_torch.kernels.noc_router.ref import NF, ArbDecisions, endpoint_deliveries

CSRC = Path(__file__).parent / "csrc"
SOURCES = (CSRC / "noc_router.cu",)
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_P = 16  # ports per router the arb kernel holds in registers

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"arb": 0, "apply": 0}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA router kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    """Where the built library for the current sources lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"noc_router_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)  # atomic: concurrent builders agree on the result
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed:\n{err.stdout}\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    """Build (if needed) and load the library; declare the C signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.noc_arb_launch.argtypes = [vp] * 12 + [ci] * 6 + [vp]
            lib.noc_arb_launch.restype = ci
            lib.noc_apply_launch.argtypes = [vp] * 16 + [ci] * 6 + [vp]
            lib.noc_apply_launch.restype = ci
            _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _dims(*bufs):
    """(C, R, P, D...) of a launch from its [C, R, P, D, NF] buffers."""
    for b in bufs:
        if b.dim() != 5 or b.shape[-1] != NF:
            raise ValueError(f"expected a [C, R, P, D, {NF}] flit buffer, "
                             f"got {tuple(b.shape)}")
        if b.numel() >= 2**31:
            raise ValueError("state too large for 32-bit thread indexing")
    C, R, P = bufs[0].shape[:3]
    if not 1 <= P <= MAX_P:
        raise ValueError(f"the CUDA arb kernel takes 1..{MAX_P} ports, got {P}")
    return (C, R, P, *(b.shape[3] for b in bufs))


def arb_cuda(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
             depth_out: int) -> ArbDecisions:
    """Launch the arb kernel on channel-batched state (CUDA tensors).

    The counterpart of ``ref.arb_decisions`` over ``[C, R, P, ...]``;
    outputs are fresh scratch tensors.
    """
    dev = in_buf.device
    if dev.type != "cuda":
        raise ValueError(f"arb_cuda needs CUDA tensors, got {dev}")
    C, R, P, Din = _dims(in_buf)
    Dout = int(depth_out)
    if route.dim() != 2:
        raise ValueError("route must be [R, E]")
    E = route.shape[1]
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    for name, t in (("in_cnt", in_cnt), ("out_cnt", out_cnt),
                    ("rr_ptr", rr_ptr), ("wh_lock", wh_lock)):
        _check(name, t, i32, (C, R, P), dev)
    _check("route", route, i32, (R, E), dev)
    out = ArbDecisions(
        arb_pop=torch.empty((C, R, P), dtype=b, device=dev),
        granted=torch.empty((C, R, P), dtype=b, device=dev),
        chosen=torch.empty((C, R, P, NF), dtype=i32, device=dev),
        rr_ptr=torch.empty((C, R, P), dtype=i32, device=dev),
        wh_lock=torch.empty((C, R, P), dtype=i32, device=dev),
        in_space=torch.empty((C, R, P), dtype=b, device=dev))
    lib = _load()
    err = lib.noc_arb_launch(
        _ptr(in_buf), _ptr(in_cnt), _ptr(out_cnt), _ptr(rr_ptr),
        _ptr(wh_lock), _ptr(route), _ptr(out.arb_pop), _ptr(out.granted),
        _ptr(out.chosen), _ptr(out.rr_ptr), _ptr(out.wh_lock),
        _ptr(out.in_space), C, R, P, Din, Dout, E, _stream(dev))
    if err != 0:
        raise RuntimeError(f"noc_arb_kernel launch failed: CUDA error {err}")
    LAUNCHES["arb"] += 1
    return out


def apply_cuda(in_buf, in_cnt, out_buf, out_cnt, arb: ArbDecisions,
               link_src, link_dst, port_ep, ep_space):
    """Launch the apply kernel: the counterpart of ``ref.apply_phase``
    (fused FIFO datapath). Returns fresh ``(in_buf', in_cnt', out_buf',
    out_cnt')``; the inputs stay the untouched cycle-start snapshot."""
    dev = in_buf.device
    if dev.type != "cuda":
        raise ValueError(f"apply_cuda needs CUDA tensors, got {dev}")
    C, R, P, Din, Dout = _dims(in_buf, out_buf)
    E = ep_space.shape[-1]
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    _check("out_buf", out_buf, i32, (C, R, P, Dout, NF), dev)
    _check("in_cnt", in_cnt, i32, (C, R, P), dev)
    _check("out_cnt", out_cnt, i32, (C, R, P), dev)
    for name in ("arb_pop", "granted", "in_space"):
        _check(name, getattr(arb, name), b, (C, R, P), dev)
    _check("chosen", arb.chosen, i32, (C, R, P, NF), dev)
    _check("link_src", link_src, i32, (R, P, 2), dev)
    _check("link_dst", link_dst, i32, (R, P, 2), dev)
    _check("port_ep", port_ep, i32, (R, P), dev)
    _check("ep_space", ep_space, b, (C, E), dev)
    new_in = torch.empty_like(in_buf)
    new_in_cnt = torch.empty_like(in_cnt)
    new_out = torch.empty_like(out_buf)
    new_out_cnt = torch.empty_like(out_cnt)
    lib = _load()
    err = lib.noc_apply_launch(
        _ptr(in_buf), _ptr(in_cnt), _ptr(out_buf), _ptr(out_cnt),
        _ptr(arb.arb_pop), _ptr(arb.granted), _ptr(arb.chosen),
        _ptr(arb.in_space), _ptr(link_src), _ptr(link_dst), _ptr(port_ep),
        _ptr(ep_space), _ptr(new_in), _ptr(new_in_cnt), _ptr(new_out),
        _ptr(new_out_cnt), C, R, P, Din, Dout, E, _stream(dev))
    if err != 0:
        raise RuntimeError(f"noc_apply_kernel launch failed: CUDA error {err}")
    LAUNCHES["apply"] += 1
    return new_in, new_in_cnt, new_out, new_out_cnt


def router_cycle_cuda(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                      route, link_src, link_dst, port_ep, ep_attach,
                      ep_space):
    """One fabric cycle of every channel on the CUDA kernels.

    Same contract as ``ref.router_cycle_reference(..., fused=True)`` over
    channel-batched state: returns ``(in_buf, in_cnt, out_buf, out_cnt,
    rr_ptr, wh_lock, ep_flit [C, E, NF], ep_valid [C, E])``. The endpoint
    deliveries are gathered from the cycle-start snapshot, which the apply
    kernel leaves untouched (its outputs are separate tensors).
    """
    arb = arb_cuda(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                   depth_out=out_buf.shape[-2])
    in2, in_cnt2, out2, out_cnt2 = apply_cuda(
        in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst, port_ep,
        ep_space)
    ep_flit, ep_valid = endpoint_deliveries(out_buf, out_cnt, ep_attach,
                                            ep_space)
    return (in2, in_cnt2, out2, out_cnt2, arb.rr_ptr, arb.wh_lock, ep_flit,
            ep_valid)
