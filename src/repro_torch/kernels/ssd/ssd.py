"""CUDA SSD chunked scan for Hopper: build, ctypes binding and wrapper.

The kernels (``csrc/ssd.cu``) replace the JAX package's Pallas kernel
``_kernel`` (``src/repro/kernels/ssd/ssd.py:21``, launched by ``ssd_bhqp``
behind ``ops.ssd``) and compute ``repro.models.ssm.ssd_chunked``'s
function, the state carried in and out. They read x [B, S, H, P] and the
head-shared B and C [B, S, N] in place (the JAX wrapper transposes x and
broadcasts B and C to every head) and handle any S, positions past S
counting as dt = 0. One kernel for each dtype:

* bfloat16 runs ``ssd_tc_kernel``: the four products (C·Bᵀ, M·x, C·S_prev
  and the state update) on the tensor cores through ``wgmma``, the operands
  made in float32 (M, S_prev, x·w) split into bf16 hi + lo. A CTA of two
  warpgroups owns (batch, head, 64 columns of P) and scans the chunks in
  order, the state in registers, the next chunk's copies under this
  chunk's products;
* float32 runs ``ssd_kernel``, scalar float32 FMAs (no serve path).

For training, ``states=True`` launches each kernel's second instance, which
also writes the state entering each chunk, and ``ssd_bwd_cuda`` launches
three backward kernels (``csrc/ssd_bwd.cu``; no atomics; P <= 64), one
design for each dtype:

* bfloat16 on the tensor cores through ``wgmma``: the reverse scan of the
  state's gradient G per (batch, head), G in the accumulators
  (``ssd_bwd_state_tc_kernel``); a pass per (batch, chunk, group of heads)
  (``ssd_bwd_chunk_tc_kernel``), whose dB and dC accumulators sum the
  group's heads (the heads share B and C), the operands made in float32
  split into bf16 hi + lo; the groups' partials summed in a fixed order
  (``ssd_bwd_reduce_kernel``). ``heads_per_cta`` sizes the group so that
  the grid is one wave;
* float32 on scalar FMAs: the same three steps with a CTA per (batch,
  chunk, head) and a partial per head.

The JAX package differentiates ``repro.models.ssm.ssd_chunked``
(``src/repro/models/ssm.py:82``) by autodiff; it has no backward kernel to
replace.

Every shape the wrapper admits goes to its dtype's kernel; a CUDA tensor
launches it or raises. The libraries are built by
``repro_torch.kernels.build`` at first use on a CUDA tensor, into
``_build/`` beside this file; importing builds nothing. ``LAUNCHES`` counts
the launches of each kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr, refuse_grad, stream

SOURCES = (Path(__file__).parent / "csrc" / "ssd.cu",)
BWD_SOURCES = (Path(__file__).parent / "csrc" / "ssd_bwd.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = MAX_STATE = 128  # the kernels' register tiles
MAX_BWD_P = 64  # P the backward kernels hold per CTA
P_TILES = (64, 32, 16)  # P columns per CTA the float32 kernel is built for
SMEM_LIMIT = 232_448  # shared memory one CTA may opt in to on an H100

# launches, counted where the wrapper launches each kernel (the forward's
# STATES instance counts as "ssd")
LAUNCHES = {"ssd": 0, "ssd_bwd_state": 0, "ssd_bwd_chunk": 0, "ssd_bwd_reduce": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [vp] * 10 + [ci] * 8 + [vp]
    lib.ssd_launch.restype = ci
    lib.ssd_smem_bytes.argtypes = [ci] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_tc_smem_bytes.argtypes = [ci]
    lib.ssd_tc_smem_bytes.restype = ctypes.c_size_t


def _declare_bwd(lib):
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.ssd_bwd_state_launch.argtypes = [vp] * 9 + [ci] * 7 + [vp]
    lib.ssd_bwd_chunk_launch.argtypes = [vp] * 16 + [ci] * 8 + [vp]
    lib.ssd_bwd_reduce_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    for fn in (lib.ssd_bwd_state_launch, lib.ssd_bwd_chunk_launch, lib.ssd_bwd_reduce_launch,
               lib.ssd_bwd_max_group):
        fn.restype = ci
    lib.ssd_bwd_max_group.argtypes = []
    for fn in (lib.ssd_bwd_state_smem_bytes, lib.ssd_bwd_chunk_smem_bytes,
               lib.ssd_bwd_tc_smem_bytes):
        fn.argtypes = [ci] * 2
        fn.restype = sz


LIBRARY = CudaLibrary("ssd", SOURCES, Path(__file__).parent / "_build", _declare)
BWD_LIBRARY = CudaLibrary("ssd_bwd", BWD_SOURCES, Path(__file__).parent / "_build",
                          _declare_bwd)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {list(shape)} tensor, "
                         f"got {list(t.shape)}")


def _check_inputs(x, dt, Bv, Cv, A_log, D, chunk, state_init):
    """The checks shared by the forward and the backward; returns (B, S, H,
    P, N, Q)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the SSD kernels need CUDA tensors, got {dev}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the SSD kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or Bv.dim() != 3:
        raise ValueError("x must be [B, S, H, P] and Bv, Cv [B, S, N]")
    B, S, H, P = x.shape
    N = Bv.shape[2]
    _check("x", x, (B, S, H, P), x.dtype, dev)
    _check("dt", dt, (B, S, H), torch.float32, dev)
    _check("Bv", Bv, (B, S, N), x.dtype, dev)
    _check("Cv", Cv, (B, S, N), x.dtype, dev)
    _check("A_log", A_log, (H,), torch.float32, dev)
    _check("D", D, (H,), torch.float32, dev)
    if state_init is not None:
        _check("state_init", state_init, (B, H, P, N), torch.float32, dev)
    Q = min(chunk, S)
    if not (1 <= N <= MAX_STATE and 1 <= Q <= MAX_CHUNK):
        raise ValueError(f"the SSD kernel takes N <= {MAX_STATE} and chunks of at "
                         f"most {MAX_CHUNK} steps, got N={N}, chunk={chunk}")
    if B * S * H * P == 0:
        raise ValueError(f"empty input {list(x.shape)}")
    if B * H >= 2**31:
        raise ValueError(f"B * H = {B * H} exceeds one launch's grid")
    return B, S, H, P, N, Q


def ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk: int, state_init=None, *, states: bool = False):
    """Launch the kernel on contiguous CUDA tensors: x [B, S, H, P] (float32
    or bfloat16), dt [B, S, H] float32 (post-softplus), Bv and Cv [B, S, N]
    in x's dtype, A_log and D [H] float32, state_init [B, H, P, N] float32
    or None (zeros); chunks of ``min(chunk, S)`` steps. Returns fresh
    (y [B, S, H, P] float32, final state [B, H, P, N] float32), and with
    ``states`` also the state entering each chunk [B, nC, H, P, N] float32
    (the backward's input); the inputs are only read."""
    refuse_grad("ssd_cuda", x, dt, Bv, Cv, A_log, D, state_init)
    B, S, H, P, N, Q = _check_inputs(x, dt, Bv, Cv, A_log, D, chunk, state_init)
    lib = LIBRARY.load()
    sts = (torch.empty((B, -(-S // Q), H, P, N), dtype=torch.float32, device=x.device)
           if states else None)
    if x.dtype == torch.bfloat16:
        return _launch(lib, x, dt, Bv, Cv, A_log, D, Q, state_init, 0, sts)
    fits = [pt for pt in P_TILES if lib.ssd_smem_bytes(Q, N, pt) <= SMEM_LIMIT]
    # the narrowest tile that covers P, else the widest that fits
    PT = min((pt for pt in fits if pt >= P), default=fits[0] if fits else None)
    if PT is None:
        raise ValueError(f"no P tile fits shared memory at chunk {Q}, N={N}")
    return _launch(lib, x, dt, Bv, Cv, A_log, D, Q, state_init, PT, sts)


def _launch(lib, x, dt, Bv, Cv, A_log, D, Q, state_init, p_tile, states=None):
    """One launch on checked tensors; ``p_tile``: the float32 kernel's P
    columns per CTA (the bf16 kernel's are fixed); ``states`` (or None): the
    [B, nC, H, P, N] float32 tensor the STATES instance fills."""
    B, S, H, P = x.shape
    N = Bv.shape[2]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = lib.ssd_launch(ptr(x), ptr(dt), ptr(Bv), ptr(Cv), ptr(A_log), ptr(D),
                         ptr(state_init), ptr(y), ptr(state), ptr(states), B, S, H, P, N, Q,
                         p_tile, DTYPES[x.dtype], stream(x.device))
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd"] += 1
    return (y, state) if states is None else (y, state, states)


def heads_per_cta(B: int, nC: int, H: int, sms: int, most: int) -> int:
    """Heads of a group in the bf16 chunk pass: the fewest that keep the
    grid of (batch, chunk, group) CTAs within one wave of ``sms`` (one CTA
    an SM), at most ``most`` and H."""
    return max(1, min(H, most, -(-B * nC * H // sms)))


def ssd_bwd_launches(x, dt, Bv, Cv, A_log, D, chunk: int, states, dy, d_final_state=None,
                     want_dstate: bool = False):
    """``ssd_bwd_cuda``'s checks and buffers, without launching: returns
    (launches, outputs), ``launches`` the kernels in order as (name, fn),
    each ``fn()`` launching one kernel on the stream current at the call
    (and counting it in ``LAUNCHES[name]``), ``outputs`` what
    ``ssd_bwd_cuda`` returns once every launch has run. A kernel may be
    launched alone once the launches before it have run (its inputs are
    then in place)."""
    B, S, H, P, N, Q = _check_inputs(x, dt, Bv, Cv, A_log, D, chunk, None)
    if P > MAX_BWD_P:
        raise ValueError(f"the SSD backward kernels take P <= {MAX_BWD_P}, got P={P}")
    dev, nC = x.device, -(-S // Q)
    _check("states", states, (B, nC, H, P, N), torch.float32, dev)
    _check("dy", dy, (B, S, H, P), torch.float32, dev)
    if d_final_state is not None:
        _check("d_final_state", d_final_state, (B, H, P, N), torch.float32, dev)
    lib, code = BWD_LIBRARY.load(), DTYPES[x.dtype]
    f32 = dict(dtype=torch.float32, device=dev)
    if x.dtype == torch.bfloat16:  # the tensor-core kernels: dB, dC partials per head group
        GH = heads_per_cta(B, nC, H, torch.cuda.get_device_properties(dev).multi_processor_count,
                           lib.ssd_bwd_max_group())
        NP = -(-H // GH)
        gout = torch.empty((B, nC, H, P, N), dtype=torch.bfloat16, device=dev)
        gs = torch.empty((B, nC, H, 2), **f32)
    else:  # the scalar kernels: partials per head
        if lib.ssd_bwd_chunk_smem_bytes(Q, P) > SMEM_LIMIT:
            raise ValueError(f"the SSD backward's chunk pass does not fit shared memory at "
                             f"chunk {Q}, P={P}")
        GH, NP = 1, H
        gout, gs = torch.empty((B, nC, H, P, N), **f32), None
    ds0 = torch.empty((B, H, P, N), **f32) if want_dstate else None
    dx, ddt = torch.empty_like(x), torch.empty((B, S, H), **f32)
    dBp, dCp = (torch.empty((B, nC, NP, Q, N), **f32) for _ in range(2))
    dDp, dAp = (torch.empty((B, nC, H), **f32) for _ in range(2))
    dB, dC = torch.empty_like(Bv), torch.empty_like(Cv)
    dD, dA_log = torch.empty((H,), **f32), torch.empty((H,), **f32)

    def state():
        _launched("ssd_bwd_state", lib.ssd_bwd_state_launch(
            ptr(dy), ptr(dt), ptr(Cv), ptr(A_log), ptr(d_final_state), ptr(states), ptr(gout),
            ptr(gs), ptr(ds0), B, S, H, P, N, Q, code, stream(dev)))

    def chunk_pass():
        _launched("ssd_bwd_chunk", lib.ssd_bwd_chunk_launch(
            ptr(x), ptr(dt), ptr(Bv), ptr(Cv), ptr(A_log), ptr(D), ptr(states), ptr(gout),
            ptr(gs), ptr(dy), ptr(dx), ptr(ddt), ptr(dBp), ptr(dCp), ptr(dDp), ptr(dAp),
            B, S, H, P, N, Q, GH, code, stream(dev)))

    def reduce():
        _launched("ssd_bwd_reduce", lib.ssd_bwd_reduce_launch(
            ptr(dBp), ptr(dCp), ptr(dDp), ptr(dAp), ptr(dB), ptr(dC), ptr(dD), ptr(dA_log),
            B, S, H, NP, N, Q, code, stream(dev)))

    launches = [("ssd_bwd_state", state), ("ssd_bwd_chunk", chunk_pass),
                ("ssd_bwd_reduce", reduce)]
    return launches, (dx, ddt, dA_log, dB, dC, dD, ds0)


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"SSD backward kernel {name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def ssd_bwd_cuda(x, dt, Bv, Cv, A_log, D, chunk: int, states, dy, d_final_state=None,
                 want_dstate: bool = False):
    """The gradients of ``ssd_cuda(x, dt, Bv, Cv, A_log, D, chunk,
    state_init)`` for the cotangents ``dy`` [B, S, H, P] float32 of y and
    ``d_final_state`` [B, H, P, N] float32 (None: zero) of the final state,
    from the forward's inputs and ``states`` [B, nC, H, P, N] (its
    ``states=True`` output): the reverse scan, the pass per chunk (per
    group of heads in bf16) and the reduction, on the current stream.
    Tensors as ``ssd_cuda``'s, P <= 64.
    Returns fresh (dx in x's dtype, ddt float32, dA_log float32, dBv and
    dCv in x's dtype, dD float32, d state_init float32 or None unless
    ``want_dstate``); the inputs are only read."""
    launches, out = ssd_bwd_launches(x, dt, Bv, Cv, A_log, D, chunk, states, dy,
                                     d_final_state, want_dstate)
    for _, launch in launches:
        launch()
    return out
