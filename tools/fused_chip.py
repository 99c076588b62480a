"""The router kernels alone on the card: variants, agreement and times.

    PYTHONPATH=src python tools/fused_chip.py [--check-only] [--sections] [--shapes NAME ...]
    python tools/fused_chip.py --path-time [--cell NAME ...] [--root CHECKOUT]
    python tools/fused_chip.py --arb-times [--root CHECKOUT]
    python tools/fused_chip.py --apply-times [--apply-sections] [--root CHECKOUT]

Needs a CUDA device and ``nvcc``. It

1. compiles the router kernels with ``chip_smoke.py``'s ``nvcc`` flags plus
   ``-Xptxas -v`` and prints their registers, spills and static shared
   memory as one JSON line ``{"ptxas": {...}}``;
2. times a cluster barrier: a probe kernel (built here from the source
   below, not part of the port) runs 4 096 barriers per launch at every
   cluster size, one CTA per SM; and the probe's launch with no barrier in
   a CUDA graph, the floor of a window's time. It prints
   ``{"barrier_us": {...}, "launch_us": {...}}``;
3. at the four fused shapes of ``chip_smoke.py`` (the 8x4 mesh and the
   32x32 mesh at ``n_vcs=1``, the 8x4 and 32x32 tori at ``n_vcs=2``; 3
   channels, depth 2, random consistent state on the real tables and
   random egress queues, N = 4) holds every variant of the window against
   the plain ``router_cycles_scan`` (bit for bit) and, unless
   ``--check-only``, times it (CUDA graph of 20 windows, median of 7):
   each cluster size that fits and one or two router groups per warp
   (``slots_per_thread``), beside the global-memory kernel and the
   per-cycle arb + apply pair on the same state, and the default plan's time at N = 1, 4 and 16 (its fixed and
   per-cycle cost). One line per shape: ``[fused_variants] {...}``.

The default plan (``fused_plan``) is marked in each line. Timing launches
are not counted in ``LAUNCHES``.

With ``--sections`` it also builds a copy of ``noc_router.cu`` whose
cluster kernel reads ``clock64`` at the phase boundaries (the edits are
anchored on source lines; move them with the kernel) and prints, at each
shape, the SM cycles that thread 0 of each CTA spends per window of 16 in
the prologue, in arbitration, from the barrier's arrival to its wait (the
local reads between), in the remote reads, in the writes, and in the
epilogue, averaged over the CTAs: ``[fused_sections] {...}``.

``--path-time`` measures only main paths of ``chip_smoke.py``, each
``--cell`` in turn (``CELLS``; default ``scale_32x32_torus``): the cell's
first cycles from a fresh state (host ms per cycle), then its profiled
(super-)steps under ``torch.profiler``: the device time per cycle, the
fused kernel's and the rest's, and by kernel (the per-cycle arbitration
kernels, the apply kernel, the fused window, the rest):
``[path_device_time] {...}``. ``--arb-times`` prints ``ptxas -v`` of the
router library and times the per-cycle arbitration kernels at the shapes
of ``chip_smoke.py``'s ``kernels`` line on simulator states, beside an
empty kernel's launch at the same grid: ``[arb_times] {...}``.
``--apply-times`` does the same for the apply kernel on those states (fed
the arbitration kernel's decisions), beside an empty kernel at the
lane-per-slot grid: ``[apply_times] {...}``; with ``--apply-sections`` it
also builds a copy of the apply kernel with ``clock64`` reads at its
phase boundaries (edits anchored on source lines, one set for the kernel
of a thread per slot and one for a lane per slot, whichever the source
has) and prints the SM cycles a live thread spends in each, averaged:
``[apply_sections] {...}``. ``--root`` runs any of these on another
checkout (its ``src`` and ``chip_smoke.py``), such as a parent commit
unpacked with ``git archive``, to compare two commits in turns within one
call.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
ROOT = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
        if "--root" in sys.argv else HERE)
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

SHAPES = {  # name: (builder, nx, ny, n_vcs)
    "mesh_8x4": ("mesh", 4, 8, 1),
    "torus_8x4": ("torus", 4, 8, 2),
    "mesh_32x32": ("mesh", 32, 32, 1),
    "torus_32x32": ("torus", 32, 32, 2),
}

BARRIER_PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe(int n, int* sink) {
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) sink[0] = n;
}
extern "C" int probe_prepare(int smem) {
  cudaError_t e = cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}
extern "C" int probe_launch(int clusters, int cluster, int threads, int smem,
                            int n, int* sink, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, probe, n, sink);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""


def barrier_times(threads=704, n=4096, clusters=3):
    """Microseconds per cluster barrier at each cluster size: ``clusters``
    clusters (one per channel) of ``threads`` threads, one CTA per SM (the
    fused window's shape), timed with CUDA events over ``n`` barriers; and
    the launch of the same kernel with no barrier, in a CUDA graph like
    the windows (``launch_us``): the floor of any window's time."""
    import ctypes

    import torch

    import chip_smoke as CS
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc

    with tempfile.TemporaryDirectory() as tmp:  # the loaded library outlives it
        src, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        src.write_text(BARRIER_PROBE)
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    lib.probe_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    smem = 120_000  # one CTA per SM
    if lib.probe_prepare(smem):
        raise RuntimeError("barrier probe: attributes refused")
    out, floor = {}, {}
    for cl in (1, 2, 4, 8, 16):
        args = (clusters, cl, threads, smem)

        def launch(m):
            err = lib.probe_launch(*args, m, sink.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"barrier probe at cluster {cl}: CUDA error {err}")

        for m in (16, n):  # warm-up, then the timed launch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(m)
            b.record()
            b.synchronize()
        out[cl] = a.elapsed_time(b) * 1e3 / n
        floor[cl] = CS.graph_ms(lambda: launch(0), reps=20) * 1e3
    return {"barrier_us": out, "launch_us": floor}


# (anchor line in noc_router.cu, the code inserted after it)
SECTION_EDITS = (
    ("#include <string.h>",
     "__device__ unsigned long long g_sections[4096 * 8];\n"
     "extern \"C\" int sections_read(unsigned long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_sections, sizeof(g_sections));\n"
     "}\n"
     "extern \"C\" int sections_clear() {\n"
     "  static unsigned long long zero[4096 * 8];\n"
     "  return (int)cudaMemcpyToSymbol(g_sections, zero, sizeof(zero));\n"
     "}"),
    ("  extern __shared__ __align__(16) unsigned char smem[];",
     "  long long sec_t = clock64(), sec[8] = {0, 0, 0, 0, 0, 0, 0, 0};"),
    ("  cluster_sync(ctas);  // every CTA's state is in before any remote read",
     "  sec[0] += clock64() - sec_t; sec_t = clock64();"),
    ("    const int nxt = cur ^ 1;",
     "    sec[1] += clock64() - sec_t; sec_t = clock64();"),
    ("      if (k == 0) cluster_wait(ctas);",
     "      if (k == 0) { sec[2] += clock64() - sec_t; sec_t = clock64(); }"),
    ("      __syncwarp();  // the router's lanes have read each other's heads",
     "      if (k == 0) { sec[3] += clock64() - sec_t; sec_t = clock64(); }"),
    ("    __syncwarp();  // the next arbitration reads the router's other slots",
     "    sec[4] += clock64() - sec_t; sec_t = clock64();"),
    ("  cp_async_wait_all();  // no copy into shared memory outlives the block",
     "  sec[5] += clock64() - sec_t;\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 4096)\n"
     "    for (int j = 0; j < 6; ++j) atomicAdd(&g_sections[blockIdx.x * 8 + j], (unsigned long long)sec[j]);"),
)
SECTION_NAMES = ("prologue", "arbitration", "arrive_to_wait", "remote_reads",
                 "writes", "epilogue")


def sections_library(edits=SECTION_EDITS):
    """The router library built from a copy of its source instrumented by
    ``edits`` (the first defines ``g_sections`` and its accessors)."""
    import ctypes

    from repro_torch.kernels.build import NVCC_FLAGS, nvcc
    from repro_torch.kernels.noc_router import noc_router as K

    src = K.SOURCES[0].read_text()
    for anchor, code in edits:
        if src.count(anchor + "\n") != 1:
            raise RuntimeError(f"section anchor not found once: {anchor!r}")
        src = src.replace(anchor + "\n", anchor + "\n" + code + "\n")
    with tempfile.TemporaryDirectory() as tmp:  # the loaded library outlives it
        tmp = Path(tmp)
        (tmp / "noc_router.cu").write_text(src)
        run = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp / "lib.so"),
                              str(tmp / "noc_router.cu")], capture_output=True,
                             text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed:\n{run.stdout}\n{run.stderr}")
        lib = ctypes.CDLL(str(tmp / "lib.so"))
    K._declare(lib)
    lib.sections_read.argtypes = [ctypes.c_void_p]
    return lib


def run_sections(name, lib, n_cycles=16):
    """SM cycles per phase of one window at a shape (the default plan),
    averaged over the CTAs, thread 0 of each."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.core.noc.engine import make_tables
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh, build_torus
    from repro_torch.kernels.noc_router import noc_router as K

    kind, nx, ny, V = SHAPES[name]
    dev = torch.device("cuda")
    topo = (build_mesh if kind == "mesh" else build_torus)(nx=nx, ny=ny)
    tables = make_tables(topo, n_vcs=V, device=dev)
    rng = np.random.default_rng(sum(map(ord, name)))
    Q, cycle0 = NocParams().egress_depth, 1000
    snap = CS.to_device(CS.random_snapshot(rng, tables, 3, 2), dev)
    egress = CS.to_device(CS.random_egress(rng, 3, topo.n_endpoints, Q, cycle0,
                                           n_cycles), dev)
    args = CS.fused_args(snap, egress, tables, snap["ep_space"], cycle0, n_cycles)
    vc = dict(vc_out=tables.vc_out, n_vcs=V)
    saved_lib, saved = K.LIBRARY.lib, dict(K.LAUNCHES)
    K.LIBRARY.lib = lib
    K._PLACED.clear()
    try:
        K.router_cycles_fused_cuda(*args, **vc)  # warm-up
        torch.cuda.synchronize()
        lib.sections_clear()
        K.router_cycles_fused_cuda(*args, **vc)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * (4096 * 8))()
        lib.sections_read(ctypes.cast(out, ctypes.c_void_p))
    finally:
        K.LIBRARY.lib = saved_lib
        K._PLACED.clear()
        K.LAUNCHES.update(saved)
    plan = K.fused_plan(int(tables.route.shape[0]), int(tables.port_ep.shape[1]), 2, 2, V)
    blocks = 3 * plan.cluster
    per = np.array(out[:blocks * 8], dtype=np.float64).reshape(blocks, 8)[:, :6].mean(0)
    CS.phase("fused_sections", shape=name, n_cycles=n_cycles, cluster=plan.cluster,
             threads=plan.threads, cycles=dict(zip(SECTION_NAMES, per.tolist())))


# --path-time cells: name -> (nx, ny, NocParams fields, cycles before the
# profile, profiled steps)
CELLS = {
    "main_8x4": (4, 8, dict(), 400, 20),
    "torus_vc_8x4": (4, 8, dict(n_vcs=2), 400, 20),
    "allreduce_infabric_8x4": (4, 8, dict(collective_offload=True), 400, 20),
    "scale_32x32_torus": (32, 32, dict(n_vcs=2, fused_cycles=4), 200, 10),
}
KERNEL_GROUPS = (("noc_arb", "arb"), ("noc_apply", "apply"), ("noc_fused", "fused"))


def cell_sim(nx, ny, **params):
    """A simulator built as ``chip_smoke.py`` builds its main paths: the
    torus with virtual channels, else the mesh; with collective offload the
    in-fabric all-reduce (16 kB, 2 streams), else uniform 8 kB DMA reads
    (plus narrow requests below 32x32)."""
    import chip_smoke as CS
    from repro_torch.core.noc import collective_traffic as CT
    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc import traffic as TT
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh, build_torus

    p = NocParams(**params)
    topo = (build_torus if p.n_vcs > 1 else build_mesh)(nx=nx, ny=ny)
    if p.collective_offload:
        sched = CT.all_reduce(topo, data_kb=16, streams=2, algo="infabric")
        return TS.build_sim(topo, p, CT.to_workload(topo, sched), groups=sched.meta["groups"])
    wl = CS.mesh_workload(TT, topo, transfer_kb=8, narrow_rate=0.0 if nx == 32 else 0.05)
    return TS.build_sim(topo, p, wl)


def path_device_time(name):
    """A main path on the checkout at ROOT: host ms per cycle over the
    cell's first cycles, then device us per cycle over its profiled
    (super-)steps, split by kernel: the per-cycle arbitration kernels
    (``noc_arb*``), ``noc_apply``, the fused window (``noc_fused*``) and the
    rest."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.core.noc import sim as TS
    from repro_torch.kernels.noc_router import noc_router as K

    K.LIBRARY.build()
    nx, ny, params, cycles, steps = CELLS[name]
    sim = cell_sim(nx, ny, **params)
    st, dt, _ = CS.run_counted(TS, sim, cycles)
    cyc, s = int(st.cycle), st
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            s, _, k = sim._advance(s, cyc)
            cyc += k
        torch.cuda.synchronize()
    n = cyc - int(st.cycle)
    us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            group = next((g for key, g in KERNEL_GROUPS if key in e.name), "other")
            us[group] += e.time_range.elapsed_us()
    CS.phase("path_device_time", cell=name, package=str(Path(K.__file__).parents[2]),
             gpu_ms_per_cycle=dt / cycles * 1e3, device_us_per_cycle=sum(us.values()) / n,
             fused_us_per_cycle=us["fused"] / n,
             other_us_per_cycle=(sum(us.values()) - us["fused"]) / n,
             by_kernel_us_per_cycle={g: us[g] / n for _, g in (*KERNEL_GROUPS, ("", "other"))})


# the per-cycle kernels' states: (name, nx, NocParams fields, cycles run)
CYCLE_STATES = (
    ("mesh_8x4", 4, dict(), 400), ("mesh_32x32", 32, dict(), 100),
    ("torus_vc_8x4", 4, dict(n_vcs=2), 400), ("torus_vc_32x32", 32, dict(n_vcs=2), 100),
    ("offload_8x4", 4, dict(collective_offload=True), 400),
    ("offload_32x32", 32, dict(collective_offload=True), 100),
    ("offload_vc_8x4", 4, dict(collective_offload=True, n_vcs=2), 400))


def cycle_calls():
    """(name, cycles, arb, apply, n_vcs) at each of ``CYCLE_STATES`` on the
    checkout at ROOT: the state its main path reaches, ``arb()`` one launch
    of its arbitration kernel, ``apply`` the apply kernel's arguments (that
    kernel's decisions, every endpoint with ingress space) and the VCs."""
    import torch

    import chip_smoke as CS
    from repro_torch.core.noc import sim as TS
    from repro_torch.kernels.noc_router import noc_router as K

    for name, nx, params, cycles in CYCLE_STATES:
        sim = cell_sim(nx, 8 if nx == 4 else nx, **params)
        st, _, _ = CS.run_counted(TS, sim, cycles)
        f, tb = st.fabric, sim.tables
        args = (f.in_buf, f.in_cnt, f.out_cnt, f.rr_ptr, f.wh_lock, tb.route)
        kw = dict(depth_out=f.out_buf.shape[-2], vc_out=tb.vc_out, n_vcs=sim.params.n_vcs)
        if sim.params.collective_offload:
            kw.update(fork_out=tb.fork_out, red_parent=tb.red_parent, red_need=tb.red_need,
                      red_acc=f.red_acc, red_got=f.red_got, n_endpoints=tb.route.shape[1])
            arb = lambda args=args, kw=kw: K.arb_offload_cuda(*args, **kw)[0]
        else:
            arb = lambda args=args, kw=kw: K.arb_cuda(*args, **kw)
        dec = arb()
        ep_space = torch.ones(tb.route.shape[1], dtype=torch.bool,  # as chip_smoke.py's
                              device=f.in_cnt.device).expand(f.in_cnt.shape[0], -1).contiguous()
        app = (f.in_buf, f.in_cnt, f.out_buf, f.out_cnt, dec, tb.link_src, tb.link_dst,
               tb.port_ep, ep_space)
        yield name, cycles, arb, app, sim.params.n_vcs


def chip_smoke_here():
    """This checkout's ``chip_smoke.py`` (its launch-floor probe), whatever
    ROOT is."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here


def kernel_times(which):
    """The per-cycle arbitration kernels (``which`` "arb") or the apply
    kernel ("apply") of the checkout at ROOT at the shapes of
    ``chip_smoke.py``'s ``kernels`` line, on the states its main paths
    reach (8x4 and 32x32 mesh and torus after 400 and 100 cycles; the
    in-fabric all-reduce on the 8x4 mesh and torus at cycle 400 and on the
    32x32 mesh at cycle 100): device ms per launch (CUDA graph of 50,
    median of 7) beside an empty kernel's at the lane-per-slot grid, timed
    by this checkout's ``chip_smoke.py``. One ``[arb_times]`` or
    ``[apply_times]`` line."""
    import chip_smoke as CS
    from repro_torch.kernels.noc_router import noc_router as K

    here = chip_smoke_here()
    out = {}
    saved = dict(K.LAUNCHES)
    for name, cycles, arb, app, V in cycle_calls():
        fn = arb if which == "arb" else lambda app=app, V=V: K.apply_cuda(*app, n_vcs=V)
        C, R, P = app[1].shape
        out[name] = {"cycle": cycles, "ms": CS.graph_ms(fn),
                     "launch_floor_ms": here.launch_floor_ms(here.arb_blocks(C, R, P))}
    K.LAUNCHES.update(saved)
    CS.phase(f"{which}_times", package=str(Path(K.__file__).parents[2]), **out)


# clock64 edits of the apply kernel, (anchor line, code inserted after it):
# a thread per slot (apply_slot) and a lane per slot (noc_apply_kernel).
# Each live thread sums its sections into g_sections[0..4] (warp sums, one
# atomic each) and counts itself into g_sections[7].
_SEC_OPEN = "long long sec_t = clock64(), sec[5] = {0, 0, 0, 0, 0}; unsigned sec_sink = 0;"


def _sec(j, sink=""):
    return (f"{{ {sink} const long long sec_c = clock64(); sec[{j}] = sec_c - sec_t; "
            "sec_t = sec_c; }")


_SEC_CLOSE = (
    _sec(4) + "\n"
    "{ const unsigned m = __activemask(); const bool lead = (threadIdx.x & 31) == __ffs(m) - 1;\n"
    "  for (int j = 0; j < 5; ++j) {\n"
    "    const unsigned x = __reduce_add_sync(m, (unsigned)sec[j]);\n"
    "    if (lead) atomicAdd(&g_sections[j], (unsigned long long)x); }\n"
    "  if (lead) atomicAdd(&g_sections[7], (unsigned long long)__popc(m));\n"
    "  if (sec_sink == 0x7fffffffu) g_sections[6] = 1; }")
APPLY_SECTION_EDITS = {
    "thread": (
        SECTION_EDITS[0],
        ("  size_t group = chan + (size_t)r * P + pp * V;  // my slots of port pp", _SEC_OPEN),
        ("  int src_r = link_src[lp * 2], src_p = link_src[lp * 2 + 1];",
         _sec(0, "sec_sink += src_r + src_p;")),
        ("  bool accept = src_r >= 0 && lowest_vc_wins(out_cnt, in_space, up, group, v);",
         _sec(1, "sec_sink += accept;")),
        ("                              out_buf + (up + v) * Dout * NF, Din);", _sec(2)),
        ("                 ep_space[(size_t)c * E + clampi(pe, 0, E - 1)];",
         _sec(3, "sec_sink += sent_link + sent_ep;")),
        ("                               chosen + t * NF, Dout);", _SEC_CLOSE),
    ),
    "lane": (
        SECTION_EDITS[0],
        ("  extern __shared__ __align__(16) int apply_smem[];", _SEC_OPEN),
        ("  old_out.load(s_out, out_buf + slot0 * fout, ns * fout, lane);",
         _sec(0, "sec_sink += src_r + src_p + dst_r + dst_p + pe + icnt + ocnt + pop_in"
                 " + grant + space + ch[0] + ch[6];")),
        ("    if (pe >= 0) ep_ok = ep_space[(size_t)(s.cr / R) * E + clampi(pe, 0, E - 1)];",
         _sec(1, "sec_sink += up_cnt + dn_space + flit[0] + flit[6] + ep_ok;")),
        ("  const bool sent = ((out_elig >> (lane - v)) & upto) == me || (ocnt > 0 && ep_ok);",
         _sec(2, "sec_sink += accept + sent;")),
        ("  __syncwarp();  // the warp's rows are final", _sec(3)),
        ("  warp_store<DOUT * NF>(new_out_buf + slot0 * fout, s_out, ns * fout, lane);",
         "if (s.live) {\n" + _SEC_CLOSE + "\n}"),
    ),
}
APPLY_SECTION_NAMES = {
    "thread": ("tables", "input_chain", "input_fifo", "output_chain", "output_fifo"),
    "lane": ("own_and_old_row_loads", "remote_loads", "ballots", "rows_to_smem_and_fifo",
             "coalesced_stores"),
}


def apply_sections():
    """SM cycles a live thread of the apply kernel (of the checkout at
    ROOT) spends in each section, averaged over the threads of one launch
    at each of ``CYCLE_STATES`` after a warm-up: one ``[apply_sections]``
    line."""
    import ctypes

    import torch

    import chip_smoke as CS
    from repro_torch.kernels.noc_router import noc_router as K

    src = K.SOURCES[0].read_text()
    shape = "thread" if "  if (t >= C * R * P) return;\n" in src else "lane"
    lib = sections_library(APPLY_SECTION_EDITS[shape])
    out = {}
    saved_lib, saved = K.LIBRARY.lib, dict(K.LAUNCHES)
    K.LIBRARY.lib = lib
    try:
        for name, _, _, app, V in cycle_calls():
            K.apply_cuda(*app, n_vcs=V)  # warm-up
            torch.cuda.synchronize()
            lib.sections_clear()
            K.apply_cuda(*app, n_vcs=V)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (4096 * 8))()
            lib.sections_read(ctypes.cast(buf, ctypes.c_void_p))
            n = max(1, buf[7])
            out[name] = {"threads": buf[7], "cycles": dict(zip(
                APPLY_SECTION_NAMES[shape], (buf[j] / n for j in range(5))))}
    finally:
        K.LIBRARY.lib = saved_lib
        K.LAUNCHES.update(saved)
    CS.phase("apply_sections", package=str(Path(K.__file__).parents[2]), shape=shape, **out)



def variants(R, P, V):
    """(label, plan) of every variant of the window at R routers of P slots."""
    from repro_torch.kernels.noc_router import noc_router as K

    out = []
    for cl in K.CLUSTER_SIZES:
        for k in (1, 2):
            try:
                plan = K.fused_plan(R, P, 2, 2, V, cluster=cl, slots_per_thread=k)
            except ValueError:
                continue
            out.append((f"{cl}/{k}", plan))
    out.append(("global", K.global_plan(R)))
    return out


def run_shape(name, check_only):
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.core.noc.engine import make_tables
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh, build_torus
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    kind, nx, ny, V = SHAPES[name]
    dev = torch.device("cuda")
    topo = (build_mesh if kind == "mesh" else build_torus)(nx=nx, ny=ny)
    tables = make_tables(topo, n_vcs=V, device=dev)
    rng = np.random.default_rng(sum(map(ord, name)))
    N, Q, cycle0 = 4, NocParams().egress_depth, 1000
    snap = CS.to_device(CS.random_snapshot(rng, tables, 3, 2), dev)
    egress = CS.to_device(CS.random_egress(rng, 3, topo.n_endpoints, Q, cycle0, N), dev)
    args = CS.fused_args(snap, egress, tables, snap["ep_space"], cycle0, N)
    vc = dict(vc_out=tables.vc_out, n_vcs=V)
    R, P = int(tables.route.shape[0]), int(tables.port_ep.shape[1])
    default = K.fused_plan(R, P, 2, 2, V)
    want = ref.router_cycles_scan(*args, **vc)
    saved = dict(K.LAUNCHES)
    rows = {}
    for label, plan in variants(R, P, V):
        got = K.router_cycles_fused_cuda(*args, **vc, plan=plan)
        err = CS.max_abs_err(want, got)
        row = {"max_abs_err": err, "cluster": plan.cluster,
               "smem_bytes": plan.smem_bytes, "threads": plan.threads,
               "default": plan == default}
        if not check_only:
            row["ms"] = CS.graph_ms(
                lambda: K.router_cycles_fused_cuda(*args, **vc, plan=plan), reps=20)
        rows[label] = row
    line = {"shape": name, "R": R, "P": P, "n_vcs": V, "n_cycles": N,
            "variants": rows}
    if not check_only:
        # the default plan's fixed and per-cycle cost: windows of 1, 4, 16
        by_n = {}
        for n in (1, 4, 16):
            eg_n = CS.to_device(CS.random_egress(rng, 3, topo.n_endpoints, Q,
                                                 cycle0, n), dev)
            args_n = CS.fused_args(snap, eg_n, tables, snap["ep_space"], cycle0, n)
            by_n[n] = CS.graph_ms(
                lambda: K.router_cycles_fused_cuda(*args_n, **vc), reps=20)
        line["default_ms_by_n_cycles"] = by_n
        st = SimpleNamespace(**{k: snap[k] for k in CS.STATE})
        pair = CS.time_kernels(st, tables, snap["ep_space"])
        line["per_cycle_pair_ms"] = pair["arb"]["ms"] + pair["apply"]["ms"]
    K.LAUNCHES.update(saved)
    CS.phase("fused_variants", **line)
    bad = {k: r["max_abs_err"] for k, r in rows.items() if r["max_abs_err"]}
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_chip: no CUDA device available", file=sys.stderr)
        return 1
    # ROOT's package and smoke script first: importing model_kernels_chip
    # puts this checkout at the front of sys.path
    import chip_smoke  # noqa: F401
    from repro_torch.kernels.noc_router import noc_router as K
    from model_kernels_chip import ptxas_report

    if "--path-time" in sys.argv:
        cells = [a for i, a in enumerate(sys.argv) if i and sys.argv[i - 1] == "--cell"]
        for name in cells or ["scale_32x32_torus"]:
            path_device_time(name)
        return 0
    for which in ("arb", "apply"):
        if f"--{which}-times" in sys.argv:
            print(json.dumps({"ptxas": ptxas_report(K.LIBRARY), "sources": str(K.SOURCES[0])}),
                  flush=True)
            kernel_times(which)
            if which == "apply" and "--apply-sections" in sys.argv:
                apply_sections()
            return 0

    check_only = "--check-only" in sys.argv
    names = list(SHAPES)
    if "--shapes" in sys.argv:
        names = [a for a in sys.argv[sys.argv.index("--shapes") + 1:]
                 if not a.startswith("--")]
    print(json.dumps({"ptxas": ptxas_report(K.LIBRARY)}), flush=True)
    if not check_only:
        print(json.dumps(barrier_times()), flush=True)
    bad = {}
    for name in names:
        bad.update({f"{name}:{k}": v for k, v in run_shape(name, check_only).items()})
    if "--sections" in sys.argv:
        lib = sections_library()
        for name in names:
            run_sections(name, lib)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    if bad:
        print(f"fused_chip: variants disagree with plain: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
