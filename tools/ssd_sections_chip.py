"""Where the bf16 SSD kernel's time goes, section by section, on the card.

    PYTHONPATH=src python tools/ssd_sections_chip.py

Needs a CUDA device and ``nvcc``. Builds a copy of
``src/repro_torch/kernels/ssd/csrc/ssd.cu`` into ``chiprun_out/`` with a
``clock64()`` read after each section of ``ssd_tc_kernel``'s chunk loop
(the copy's edits are anchored on lines of the source and fail loudly when
the source moves), runs it at both serve paths' shapes (Mamba-2 and
Zamba2, ``chip_smoke.ssd_inputs``) and prints, per warpgroup, the mean
cycles per warp that each section takes over a launch, as one JSON line
``{"ssd_sections": ...}``. A section's count includes the stalls of its
first instructions, so the waits on tensor-core groups land on the
section that waits. The instrumented kernel is a measurement aid only.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SECTIONS = ("copies", "cumsum_and_S_prev", "state_A_fragments", "wait_CB_or_state",
            "decay", "wait_Mx_and_CB", "wait_Mx_and_CS", "write_y_and_barrier")


def instrumented_source() -> str:
    """ssd.cu with per-warp section counters (TICK(k) adds the cycles since
    the previous tick to section k)."""
    src = (ROOT / "src/repro_torch/kernels/ssd/csrc/ssd.cu").read_text()

    def rep(old, new, count=1):
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"anchor moved in ssd.cu: {old!r}")
        src = src.replace(old, new)

    rep("namespace tc {", "__device__ long long g_ticks[1 << 21];\n"
        "#define TICK(k) { long long t_ = clock64(); ticks_[k] += t_ - tprev_; tprev_ = t_; }\n"
        "namespace tc {")
    rep("  stage(0, 0);\n", "  long long ticks_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tprev_ = clock64();\n"
        "  stage(0, 0);\n")
    rep("chunk c has landed\n    __syncthreads();\n",
        "chunk c has landed\n    __syncthreads();\n    TICK(0)\n")
    rep("visible to the tensor cores\n    __syncthreads();\n",
        "visible to the tensor cores\n    __syncthreads();\n    TICK(1)\n")
    rep("      fence_regs(st);\n      fence_regs(xa_hi);\n      fence_regs(xa_lo);\n      wgmma_fence();\n",
        "      TICK(2)\n      fence_regs(st);\n      fence_regs(xa_hi);\n      fence_regs(xa_lo);\n"
        "      wgmma_fence();\n")
    parts = src.split("      wgmma_wait<0>();\n")
    if len(parts) != 6:
        raise RuntimeError("ssd.cu: expected five wgmma waits in the chunk loop")
    tags = (3, 6, 3, 5, 6)  # the first warpgroup's two waits, then the second's three
    src = parts[0] + "".join(f"      wgmma_wait<0>();\n      TICK({t})\n" + p
                             for t, p in zip(tags, parts[1:]))
    src = src.replace(", row, gc);\n      fence_regs(mhi);", ", row, gc);\n      TICK(4)\n      fence_regs(mhi);")
    rep("    __syncthreads();  // every warp is done with this stage, S_prev and the decays\n  }\n",
        "    TICK(7)\n    __syncthreads();  // every warp is done with this stage, S_prev and the decays\n"
        "    TICK(7)\n  }\n  if (lane == 0) for (int k = 0; k < 8; ++k)\n"
        "    g_ticks[((size_t)blockIdx.x * (THREADS / 32) + warp) * 8 + k] = ticks_[k];\n")
    return src + ('\nextern "C" int ssd_ticks(void* host, size_t bytes) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_ticks, bytes);\n}\n')


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_sections_chip: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc
    from repro_torch.kernels.ssd import ssd as SK

    out = ROOT / "chiprun_out" / "ssd_sections"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "ssd_sections.cu", out / "ssd_sections.so"
    cu.write_text(instrumented_source())
    subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    SK._declare(lib)
    lib.ssd_ticks.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    res = {}
    for key, (B, H, N) in {"mamba2": (4, 24, 128), "zamba2": (4, 112, 64)}.items():
        x, dt, Bv, Cv, A_log, D, s0 = CS.ssd_inputs(rng, B, 512, H, 64, N, torch.bfloat16, dev)
        for _ in range(3):
            SK._launch(lib, x, dt, Bv, Cv, A_log, D, 128, s0, 0)
        torch.cuda.synchronize()
        ticks = np.zeros(B * H * 8 * 8, np.int64)  # CTAs x warps x sections
        if lib.ssd_ticks(ticks.ctypes.data, ticks.nbytes) != 0:
            raise RuntimeError("reading the section counters failed")
        per_wg = ticks.reshape(B * H, 2, 4, 8).mean(axis=(0, 2))
        res[key] = {f"warpgroup{g}": dict(zip(SECTIONS, map(float, per_wg[g])))
                    for g in range(2)}
        res[key]["cycles_per_warp"] = float(ticks.reshape(-1, 8).sum(-1).mean())
    print(json.dumps({"ssd_sections": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
