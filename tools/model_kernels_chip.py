"""The model kernels alone on the card: resources, agreement and times.

    PYTHONPATH=src python tools/model_kernels_chip.py [--skip-times] [--train-only] [OTHER_ROOT]

Needs a CUDA device and ``nvcc``. For each model kernel package
(flash attention and its backward, RMSNorm with its backward, SSD and its
backward) it

1. compiles the package's sources with ``chip_smoke.py``'s ``nvcc`` flags
   plus ``-Xptxas -v`` and prints, for each kernel instantiation, its
   registers, spill stores and loads, and static shared memory, as one
   JSON line ``{"ptxas": {...}}`` (and the bf16 SSD kernels' dynamic
   shared memory, the forward's and the backward's, at N <= 64 and N <=
   128);
2. runs ``chip_smoke.compare_model_kernels`` (every kernel against its
   plain version, at the serve paths' shapes and the edge cases) and
   ``chip_smoke.compare_train_kernels`` and ``compare_train_ssd`` (the
   backward kernels against the plain versions' autograd, the SSD scan's
   against its plain backward) and, unless ``--skip-times``,
   ``chip_smoke.time_model_kernels`` and ``time_train_kernels`` (kernel,
   plain and one PyTorch call, with the bound), printing their phase lines;
   ``--train-only`` runs the backward kernels' phases alone;
3. with ``OTHER_ROOT``, another checkout (for example the parent commit,
   unpacked by ``git archive`` into the ignored ``_proof/``), also compiles
   that tree's serving libraries (flash attention's and SSD's forward) and
   its flash backward with ``ptxas -v``, checks that every instance the two
   trees both have (by name, a flag the other tree lacks left out when it
   is off) has the same figures and that no forward instance of the other
   tree is missing here, launches both trees' SSD forward on the same
   inputs and checks the output and the final state bit-equal, and prints
   one JSON line ``{"serving_vs_other": ...}`` with the instances compared,
   those only one tree has, and the flash backward's float32 instances at
   D = Dv beside a tree's from before they took Dv (reported, not held).

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


def other_library(lib, root: Path):
    """``lib`` built from ``root``'s copy of its sources into ``root``'s own
    build directory; only SSD's forward launcher is declared, with a states
    pointer where that tree's launcher takes one (the trees since the
    ``STATES`` flag; ``has_states`` on the result says which)."""
    import ctypes

    from repro_torch.kernels.build import CudaLibrary

    here = lambda p: p.resolve().relative_to(ROOT)  # noqa: E731
    sources = tuple(root / here(s) for s in lib.sources)
    has_states = "void* states" in sources[0].read_text()

    def declare(so):
        if hasattr(so, "ssd_launch"):
            vp, ci = ctypes.c_void_p, ctypes.c_int
            so.ssd_launch.argtypes = [vp] * (10 if has_states else 9) + [ci] * 8 + [vp]
            so.ssd_launch.restype = ci

    out = CudaLibrary(lib.name, sources, root / here(lib.build_dir), declare)
    out.has_states = has_states
    return out


def instance_rows(name, rows):
    """One library's ptxas rows keyed by instance name without its parameter
    list; for ``ssd`` and ``flash_attention_bwd``, an instance without its
    last flag (SSD's ``STATES``, the backward's ``WINDOW``) is named as the
    tree before the flag names it."""
    out = {}
    for k, v in rows.items():
        if k in ("warnings", "bf16_dynamic_smem"):
            continue
        key = k[: k.index(">(") + 1] if ">(" in k else k
        if name in ("ssd", "flash_attention_bwd"):
            key = re.sub(r",\s*\(bool\)0>", ">", key)
        out[key] = v
    return out


def f32_renamed(mine, theirs):
    """The float32 backward instances at D = Dv of this tree (``<float, D,
    D>``) beside the other tree's of the same D (``<float, D>``, a tree
    before the kernels took Dv apart from D): ``{name: [this, other]}``.
    Their code changed with the template, so their figures are reported,
    not held equal."""
    out = {}
    for k, v in mine.items():
        old = re.sub(r"<float, \(int\)(\d+), \(int\)\1>", r"<float, (int)\1>", k)
        if old != k and old in theirs:
            out[old] = [v, theirs[old]]
    return out


def serving_vs_other(reports, other_reports, other_ssd, dev):
    """This tree's kernel instances against the other tree's: every instance
    both have with equal ptxas figures, and the SSD forward's outputs
    bit-equal at Mamba-2's and Zamba2's serving shapes (bf16), with an
    entering state, and at a float32 sweep shape."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.build import ptr, stream
    from repro_torch.kernels.ssd import ssd as SK

    compared, apart = {}, {}
    for name, rows in other_reports.items():
        mine, theirs = instance_rows(name, reports[name]), instance_rows(name, rows)
        both = sorted(set(mine) & set(theirs))
        lost = sorted(set(theirs) - set(mine))
        CS.check(name == "flash_attention_bwd" or not lost,
                 f"{name}: instances of the other tree missing here: {lost}")
        differ = {k: (mine[k], theirs[k]) for k in both if mine[k] != theirs[k]}
        CS.check(both and not differ, f"{name}: ptxas figures differ from the other tree's: "
                                      f"{differ}")
        compared[name] = both
        apart[name] = {"here_only": sorted(set(mine) - set(theirs)), "there_only": lost}
        if name == "flash_attention_bwd":  # reported beside, not held: see f32_renamed
            apart[name]["float32_d_eq_dv"] = f32_renamed(mine, theirs)
    so = other_ssd.load()
    rng = np.random.default_rng(46)
    same = []
    for B, S, H, P, N, dtype, init in ((4, 512, 24, 64, 128, torch.bfloat16, False),
                                       (4, 512, 112, 64, 64, torch.bfloat16, False),
                                       (2, 200, 24, 64, 128, torch.bfloat16, True),
                                       (2, 128, 3, 16, 8, torch.float32, False)):
        x, dt, Bv, Cv, A_log, D, s0 = CS.ssd_inputs(rng, B, S, H, P, N, dtype, dev, init)
        y, st = SK.ssd_cuda(x, dt, Bv, Cv, A_log, D, 128, s0)
        y2, st2 = torch.empty_like(y), torch.empty_like(st)
        pt = 0 if dtype == torch.bfloat16 else 16
        states = [ptr(None)] if other_ssd.has_states else []  # the serving launch: none
        err = so.ssd_launch(ptr(x), ptr(dt), ptr(Bv), ptr(Cv), ptr(A_log), ptr(D), ptr(s0),
                            ptr(y2), ptr(st2), *states, B, S, H, P, N, min(128, S), pt,
                            SK.DTYPES[dtype], stream(dev))
        torch.cuda.synchronize()
        CS.check(err == 0, f"the other tree's SSD launch failed: {err}")
        same.append(bool(torch.equal(y, y2) and torch.equal(st, st2)))
    CS.check(all(same), f"serving outputs differ from the other tree's: {same}")
    print(json.dumps({"serving_vs_other": {
        "ptxas_equal": compared, "not_compared": apart, "ssd_outputs_bit_equal": same}}),
        flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("model_kernels_chip: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as CS

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.ssd import ssd as SK

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    other = Path(args[0]).resolve() if args else None
    libs = (FK.LIBRARY, FK.BWD_LIBRARY, RK.LIBRARY, SK.LIBRARY, SK.BWD_LIBRARY)
    theirs = () if other is None else (other_library(FK.LIBRARY, other),
                                       other_library(SK.LIBRARY, other),
                                       other_library(FK.BWD_LIBRARY, other))
    with ThreadPoolExecutor(len(libs) + len(theirs)) as pool:  # one nvcc per source, together
        done = list(pool.map(ptxas_report, libs + theirs))
    reports = {lib.name: r for lib, r in zip(libs, done)}
    other_reports = {lib.name: r for lib, r in zip(theirs, done[len(libs):])}
    # the bf16 SSD kernel's shared memory is dynamic: its size by state width
    reports["ssd"]["bf16_dynamic_smem"] = {
        f"N<={n}": SK.LIBRARY.load().ssd_tc_smem_bytes(n) for n in (64, 128)}
    reports["ssd_bwd"]["bf16_dynamic_smem"] = {
        f"{k} N<={n}": SK.BWD_LIBRARY.load().ssd_bwd_tc_smem_bytes(n, chunk)
        for k, chunk in (("state", 0), ("chunk", 1)) for n in (64, 128)}
    print(json.dumps({"ptxas": reports} | ({"ptxas_other": other_reports} if theirs else {})))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if theirs:
        serving_vs_other(reports, other_reports, theirs[1], dev)
    if "--train-only" not in sys.argv:
        CS.compare_model_kernels(dev)
    CS.compare_train_kernels(dev)
    CS.compare_train_ssd(dev)
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
