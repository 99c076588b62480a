"""The model kernels alone on the card: resources, agreement and times.

    PYTHONPATH=src python tools/model_kernels_chip.py [--skip-times] [--train-only]

Needs a CUDA device and ``nvcc``. For each model kernel package
(flash attention and its backward, RMSNorm with its backward, SSD) it

1. compiles the package's sources with ``chip_smoke.py``'s ``nvcc`` flags
   plus ``-Xptxas -v`` and prints, for each kernel instantiation, its
   registers, spill stores and loads, and static shared memory, as one
   JSON line ``{"ptxas": {...}}`` (and the bf16 SSD kernel's dynamic
   shared memory at N <= 64 and N <= 128);
2. runs ``chip_smoke.compare_model_kernels`` (every kernel against its
   plain version, at the serve paths' shapes and the edge cases) and
   ``chip_smoke.compare_train_kernels`` (the backward kernels against the
   plain versions' autograd) and, unless ``--skip-times``,
   ``chip_smoke.time_model_kernels`` and ``time_train_kernels`` (kernel,
   plain and one PyTorch call, with the bound), printing their phase lines;
   ``--train-only`` runs the backward kernels' phases alone.

It is the quick check of a model-kernel change; ``chip_smoke.py`` runs the
same two phases inside the whole run.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_FUNC = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def demangle(names):
    """Readable names for mangled kernel symbols (``cu++filt``)."""
    from repro_torch.kernels.build import nvcc

    filt = Path(nvcc()).parent / "cu++filt"
    out = subprocess.run([str(filt), *names], capture_output=True, text=True, check=True)
    return dict(zip(names, out.stdout.split("\n")))


def ptxas_report(lib):
    """{kernel: {registers, stack, spill_stores, spill_loads, smem_static}} of one
    package's library, from ``ptxas -v``. The build lands where the
    package's own loader looks for it, so the kernels are compiled once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc

    lib.build_dir.mkdir(parents=True, exist_ok=True)
    run = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib.path()),
                          *map(str, lib.sources)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{run.stdout}\n{run.stderr}")
    rows, cur = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        if m := _FUNC.search(line):
            cur = m.group(1)
            rows[cur] = {}
        elif cur is not None:
            if m := _USED.search(line):
                rows[cur]["registers"] = int(m.group(1))
                if s := _SMEM.search(line):
                    rows[cur]["smem_static"] = int(s.group(1))
            if m := _SPILL.search(line):
                rows[cur]["stack"] = int(m.group(1))
                rows[cur]["spill_stores"] = int(m.group(2))
                rows[cur]["spill_loads"] = int(m.group(3))
    names = demangle(list(rows))
    out = {names[k]: v for k, v in rows.items()}
    warnings = [line for line in (run.stdout + run.stderr).splitlines()
                if "warning" in line.lower() or "performance" in line.lower()]
    if warnings:
        out["warnings"] = warnings
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("model_kernels_chip: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as CS

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.ssd import ssd as SK

    libs = (FK.LIBRARY, FK.BWD_LIBRARY, RK.LIBRARY, SK.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, together
        reports = {lib.name: r for lib, r in zip(libs, pool.map(ptxas_report, libs))}
    # the bf16 SSD kernel's shared memory is dynamic: its size by state width
    reports["ssd"]["bf16_dynamic_smem"] = {
        f"N<={n}": SK.LIBRARY.load().ssd_tc_smem_bytes(n) for n in (64, 128)}
    print(json.dumps({"ptxas": reports}))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if "--train-only" not in sys.argv:
        CS.compare_model_kernels(dev)
    CS.compare_train_kernels(dev)
    if "--skip-times" not in sys.argv:
        if "--train-only" not in sys.argv:
            CS.time_model_kernels(dev)
        CS.time_train_kernels(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
