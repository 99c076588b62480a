"""The bf16 flash-attention forward, or the backward kernels, of two trees
in turns on the card.

    PYTHONPATH=src python tools/flash_turns_chip.py BASE_ROOT [--rounds N] [--backward | --ssd | --train]

``BASE_ROOT`` is another checkout of this repo (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Needs a CUDA device and ``nvcc``. The script builds both trees'
``csrc/flash_attention.cu`` (together, one ``nvcc`` each) and times the
serving launch, with no log-sum-exp, at the serve paths' D = 128 shapes
(B 4, S 512, causal: Phi-4-mini's 24 / 8 heads, Llama-4-Scout's 40 / 8,
Qwen2-VL's 64 / 8) by CUDA-graph replay (``chip_smoke.graph_ms``), in turns
base, this, this, base, ``N`` times (default 3). The host's and the card's
speed drift within a call, so only turns of one call compare. It also
times this tree's training launch, which writes the log-sum-exp, at the
same shapes, checks that both trees' outputs are equal bit for bit, and
prints one JSON line per shape and the card's name and power limit.

``--backward`` instead times both trees' backward kernels in turns (base,
this, this, base, ``N`` times), each tree's own library built from its own
sources: flash attention's dQ and dK / dV launches at Phi-4-mini's training
shape (B 4, S 512, 24 / 8 heads, D 128, causal; the output and log-sum-exp
from this tree's forward, the same for both) in bf16, beside cuDNN SDPA's
backward through autograd on the same inputs, and in float32, RMSNorm's backward (dx
and dw's two launches) at N 2048, d 3072, bf16, beside ``F.rms_norm``'s
backward, and the SSD scan's backward (each tree's ``ssd_bwd_cuda``, its
own module loaded from its own ``ssd.py``) at Mamba-2's and Zamba2's
training shapes (B 4 x 512, Q 128, P 64, bf16; H 24, N 128 and H 112, N
64; the forward's states from this tree's ``STATES`` launch) beside the
plain backward ``ssd_chunked_bwd_ref``, and this tree's kernels each alone.
Each tree's gradients are held against the other's within
``chip_smoke.ATTN_GRAD_TOL`` (bf16 and float32) / ``RMS_GRAD_TOL`` /
``SSD_GRAD_REL`` (bf16).
One JSON line per kernel and shape, then the card's name and power limit.
``--ssd`` runs the SSD scan's part of ``--backward`` alone.

``--train`` instead runs ``chip_smoke.train_mamba2_130m`` and
``train_zamba2_7b`` of both trees in turns (base, this, this, base, ``N``
times; default 1), each turn a process of its own started in that tree
(the two trees' packages share names), and prints one JSON line per cell
with each turn's ms a step, forward / backward / update split, device ms
and busy share of one profiled step, and the SSD backward's kernels among
that step's six longest (device us); then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REL = Path("src/repro_torch/kernels/flash_attention")
SHAPES = (("phi4_mini", 24, 8), ("llama4_scout", 40, 8), ("qwen2_vl", 64, 8))
B, S, D = 4, 512, 128


def library(root: Path, name: str):
    """(the tree's flash-attention library, whether its launch takes an
    ``lse`` pointer), built into the tree's own ``_build/``."""
    from repro_torch.kernels.build import CudaLibrary

    src = root / REL / "csrc" / "flash_attention.cu"
    has_lse = "void* lse" in src.read_text()

    def declare(lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = lib.flash_attention_launch
        fn.argtypes = [vp] * (5 if has_lse else 4) + [ci] * 10 + [ctypes.c_float, vp]
        fn.restype = ci

    return CudaLibrary(name, (src,), root / REL / "_build", declare), has_lse


def launcher(lib, has_lse, q, k, v, o, lse=None):
    """A call of ``lib``'s bf16 launch on (q, k, v) into ``o`` on the
    current stream; with ``lse``, the training launch that also writes it
    (a launch that takes the pointer gets NULL without it)."""
    from repro_torch.kernels.build import ptr, stream

    _, _, H, _ = q.shape
    KV = k.shape[2]
    fn = lib.load().flash_attention_launch

    def call():
        head = [ptr(q), ptr(k), ptr(v), ptr(o)] + ([ptr(lse)] if has_lse else [])
        err = fn(*head, B, H, KV, S, S, D, D, 1, 1, 0, D ** -0.5, stream(q.device))
        if err:
            raise RuntimeError(f"flash-attention launch failed: CUDA error {err}")

    if lse is not None and not has_lse:
        raise ValueError("this tree's launch writes no log-sum-exp")
    return call


def bwd_libraries(root: Path, tag: str):
    """(the tree's flash-attention backward library, its RMSNorm library),
    built into the tree's own ``_build/``. The flash library's ``dims(D)``
    gives the head-dim, dtype, causal and window arguments of its launches:
    a tree whose launches take Dv and a window gets them, an
    older one not."""
    from repro_torch.kernels.build import CudaLibrary

    src = root / REL / "csrc" / "flash_attention_bwd.cu"
    windowed = "int causal, int window, float scale" in src.read_text()

    def declare_flash(lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.flash_bwd_dq_launch, lib.flash_bwd_dkdv_launch):
            fn.argtypes = [vp] * 8 + [ci] * (10 if windowed else 8) + [ctypes.c_float, vp]
            fn.restype = ci

    def declare_rms(lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_bwd_launch.argtypes = [vp] * 5 + [ci] * 3 + [ctypes.c_float, vp]
        lib.rmsnorm_bwd_launch.restype = ci
        lib.rmsnorm_dw_launch.argtypes = [vp] * 2 + [ci] * 2 + [vp]
        lib.rmsnorm_dw_launch.restype = ci
        lib.rmsnorm_bwd_blocks.argtypes = [ci]
        lib.rmsnorm_bwd_blocks.restype = ci

    rms = Path("src/repro_torch/kernels/rmsnorm")
    flash = CudaLibrary(f"flash_attention_bwd_{tag}", (src,), root / REL / "_build",
                        declare_flash)
    # D (Dv = D), dtype (1 bf16, 0 float32), causal, no window
    flash.dims = lambda D, dt: (D, D, dt, 1, 0) if windowed else (D, dt, 1)
    return (flash,
            CudaLibrary(f"rmsnorm_{tag}", (root / rms / "csrc" / "rmsnorm.cu",
                                           root / rms / "csrc" / "rmsnorm_bwd.cu"),
                        root / rms / "_build", declare_rms))


def checked(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def flash_turns(libs, dtype, gen, rounds: int) -> None:
    """Both trees' flash backward pair in turns at Phi-4-mini's training
    shape in ``dtype``, this tree's two kernels alone, and (bf16) cuDNN
    SDPA's backward; one JSON line."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels.build import ptr, stream
    from repro_torch.kernels.flash_attention import flash_attention as FK

    dev, H, KV = gen.device, 24, 8
    bf16 = dtype == torch.bfloat16
    q, dout = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype) for _ in range(2))
    o, lse = FK.flash_attention_cuda(q, k, v, lse=True)
    grads, runs, parts = {}, {}, {}
    for who, (flib, _) in libs.items():
        fl, dims = flib.load(), flib.dims(D, int(bf16))
        grads[who] = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                      torch.empty((B, H, S), dtype=torch.float32, device=dev))

        def dq_call(fl=fl, g=grads[who], dims=dims):
            checked(fl.flash_bwd_dq_launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(lse),
                                           ptr(g[0]), ptr(g[3]), B, H, KV, S, S, *dims,
                                           D ** -0.5, stream(dev)), "dQ")

        def dkdv_call(fl=fl, g=grads[who], dims=dims):
            checked(fl.flash_bwd_dkdv_launch(ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse),
                                             ptr(g[3]), ptr(g[1]), ptr(g[2]), B, H, KV, S, S,
                                             *dims, D ** -0.5, stream(dev)), "dK / dV")

        def call(dq_call=dq_call, dkdv_call=dkdv_call):
            dq_call()
            dkdv_call()
        runs[who], parts[who] = call, (dq_call, dkdv_call)
    turns = {"base": [], "this": []}
    for _ in range(rounds):
        for who in ("base", "this", "this", "base"):
            turns[who].append(CS.graph_ms(runs[who], reps=10))
    # this tree's two kernels alone (dK / dV reads the Delta of the last dQ run)
    this_parts = {name: CS.graph_ms(fn, reps=10) for name, fn in zip(("dq", "dkdv"),
                                                                     parts["this"])}
    lib_ms = None
    if bf16:
        lt = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*lt, is_causal=True, enable_gqa=True)
        lib_ms = [CS.backward_ms(lib_out, lt, dout.transpose(1, 2).contiguous())
                  for _ in range(rounds)]
    torch.cuda.synchronize()
    tol, errs = CS.ATTN_GRAD_TOL[str(dtype).removeprefix("torch.")], {}
    for name, a, b in zip(("dq", "dk", "dv"), grads["base"][:3], grads["this"][:3]):
        errs[name], ok = CS.close_err(b, a, tol)
        CS.check(ok and bool(torch.isfinite(b).all()),
                 f"flash backward: this tree's {name} disagrees with the base's: {errs[name]}")
    print(json.dumps({
        "kernel": "flash attention backward (dQ + dK / dV)",
        "shape": f"B={B}, S={S}, H={H}, KV={KV}, D=Dv={D}, "
                 f"{'bf16' if bf16 else 'float32'}, causal",
        "order": "base,this,this,base" + f" x {rounds}",
        "base_ms": turns["base"], "this_ms": turns["this"],
        "base_median_ms": statistics.median(turns["base"]),
        "this_median_ms": statistics.median(turns["this"]),
        "base_over_this": statistics.median(turns["base"]) / statistics.median(turns["this"]),
        "this_alone_ms": this_parts, "cudnn_sdpa_bwd_ms": lib_ms,
        "max_abs_diff_vs_base": errs, "tol": tol}), flush=True)


def backward_turns(base_root: Path, rounds: int) -> None:
    """``--backward``: both trees' backward kernels in turns (module doc)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels.build import ptr, stream

    libs = {"base": bwd_libraries(base_root, "base"), "this": bwd_libraries(ROOT, "this")}
    with ThreadPoolExecutor(4) as pool:  # one nvcc per source set, together
        list(pool.map(lambda lib: lib.build(), [lib for pair in libs.values() for lib in pair]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    for dtype in (bf, torch.float32):
        flash_turns(libs, dtype, gen, rounds)

    N, d = 2048, 3072
    x, dy = (torch.randn((N, d), generator=gen, device=dev).to(bf) for _ in range(2))
    w = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    out, runs, parts = {}, {}, {}
    for who, (_, rlib) in libs.items():
        rl = rlib.load()
        part = torch.empty((rl.rmsnorm_bwd_blocks(N), d), dtype=torch.float32, device=dev)
        out[who] = (torch.empty_like(x), torch.empty((d,), dtype=torch.float32, device=dev))

        def dx_call(rl=rl, part=part, g=out[who]):
            checked(rl.rmsnorm_bwd_launch(ptr(x), ptr(w), ptr(dy), ptr(g[0]), ptr(part), N, d, 1,
                                          CS.RMS_EPS, stream(dev)), "RMSNorm backward")

        def dw_call(rl=rl, part=part, g=out[who]):
            checked(rl.rmsnorm_dw_launch(ptr(part), ptr(g[1]), N, d, stream(dev)), "RMSNorm dw")

        def call(dx_call=dx_call, dw_call=dw_call):
            dx_call()
            dw_call()
        runs[who], parts[who] = call, (dx_call, dw_call)
    turns = {"base": [], "this": []}
    for _ in range(rounds):
        for who in ("base", "this", "this", "base"):
            turns[who].append(CS.graph_ms(runs[who]))
    this_parts = {name: CS.graph_ms(fn) for name, fn in zip(("dx", "dw"), parts["this"])}
    xb, wb = x.clone().requires_grad_(True), w.to(bf).requires_grad_(True)
    with torch.enable_grad():
        lib_y = F.rms_norm(xb, (d,), wb, CS.RMS_EPS)
    lib_ms = [CS.backward_ms(lib_y, (xb, wb), dy) for _ in range(rounds)]
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("dx", "dw"), out["base"], out["this"]):
        errs[name], ok = CS.close_err(b, a, CS.RMS_GRAD_TOL["bfloat16"])
        CS.check(ok and bool(torch.isfinite(b).all()),
                 f"RMSNorm backward: this tree's {name} disagrees with the base's: {errs[name]}")
    print(json.dumps({
        "kernel": "RMSNorm backward (dx + dw)", "shape": f"N={N}, d={d}, bf16",
        "order": "base,this,this,base" + f" x {rounds}",
        "base_ms": turns["base"], "this_ms": turns["this"],
        "base_median_ms": statistics.median(turns["base"]),
        "this_median_ms": statistics.median(turns["this"]),
        "base_over_this": statistics.median(turns["base"]) / statistics.median(turns["this"]),
        "this_alone_ms": this_parts, "f_rms_norm_bwd_ms": lib_ms,
        "max_abs_diff_vs_base": errs,
        "tol": CS.RMS_GRAD_TOL["bfloat16"]}), flush=True)


def ssd_module(root: Path, name: str):
    """The tree's ``kernels/ssd/ssd.py`` loaded as module ``name``: its
    wrappers build and load that tree's own sources into its ``_build/``."""
    spec = importlib.util.spec_from_file_location(
        name, root / "src/repro_torch/kernels/ssd/ssd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ssd_turns(base_root: Path, rounds: int) -> None:
    """Both trees' SSD scan backward in turns, and this tree's kernels each
    alone (module doc)."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.ssd import ssd as SK
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    mods = {"base": ssd_module(base_root, "ssd_base"), "this": SK}
    with ThreadPoolExecutor(2) as pool:  # one nvcc per tree, together
        list(pool.map(lambda m: m.BWD_LIBRARY.build(), mods.values()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(47)
    for label, H, N in (("mamba2", 24, 128), ("zamba2", 112, 64)):
        x, dt, Bv, Cv, A_log, D, _, states, dy, _ = CS.ssd_bwd_inputs(
            rng, 4, 512, H, 64, N, 128, torch.bfloat16, dev)
        args = (x, dt, Bv, Cv, A_log, D, 128, states, dy)
        runs = {who: (lambda m=m: m.ssd_bwd_cuda(*args)) for who, m in mods.items()}
        turns = {"base": [], "this": []}
        for _ in range(rounds):
            for who in ("base", "this", "this", "base"):
                turns[who].append(CS.graph_ms(runs[who], reps=10))
        launches, _ = SK.ssd_bwd_launches(*args)
        for _, fn in launches:  # each kernel's inputs in place before it runs alone
            fn()
        alone = {name: CS.graph_ms(fn, reps=10) for name, fn in launches}
        plain = CS.graph_ms(lambda: ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, 128, None, dy),
                            reps=3)
        got = {who: run() for who, run in runs.items()}
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(CS.SSD_GRADS, got["base"], got["this"]):
            if a is None:
                continue
            errs[name] = CS.rel_err(b, a)
            CS.check((errs[name] is None or errs[name] <= CS.SSD_GRAD_REL["bfloat16"])
                     and bool(torch.isfinite(b).all()),
                     f"SSD backward ({label}): this tree's {name} disagrees with the base's: "
                     f"{errs[name]}")
        print(json.dumps({
            "kernel": "SSD scan backward", "shape": f"{label}: B=4, S=512, H={H}, P=64, "
                                                   f"N={N}, Q=128, bf16",
            "order": "base,this,this,base" + f" x {rounds}",
            "base_ms": turns["base"], "this_ms": turns["this"],
            "base_median_ms": statistics.median(turns["base"]),
            "this_median_ms": statistics.median(turns["this"]),
            "base_over_this": statistics.median(turns["base"]) / statistics.median(turns["this"]),
            "this_alone_ms": alone, "plain_ms": plain,
            **CS.ssd_bwd_bound(4, 512, H, 64, N, 128, 2),
            "max_rel_diff_vs_base": errs, "tol_rel": CS.SSD_GRAD_REL["bfloat16"]}), flush=True)
        del x, dt, Bv, Cv, states, dy, got
        torch.cuda.empty_cache()


TRAIN_CELLS = ("train_mamba2_130m", "train_zamba2_7b")


def train_turns(base_root: Path, rounds: int) -> None:
    """``--train``: both trees' SSM training cells in turns (module doc)."""
    code = ("import sys, torch; sys.path[:0] = ['src', '.']; import chip_smoke as CS; "
            "d = torch.device('cuda'); " + "; ".join(f"CS.{c}(d)" for c in TRAIN_CELLS))
    turns = {c: {"base": [], "this": []} for c in TRAIN_CELLS}
    for _ in range(rounds):
        for who in ("base", "this", "this", "base"):
            root = base_root if who == "base" else ROOT
            run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                                 text=True, timeout=1200)
            if run.returncode != 0:
                raise RuntimeError(f"{who}'s training turn failed:\n{run.stdout[-4000:]}\n"
                                   f"{run.stderr[-4000:]}")
            for line in run.stdout.splitlines():
                cell = line[1:line.index("]")] if line.startswith("[train_") else None
                if cell not in turns:
                    continue
                row = json.loads(line[line.index("]") + 2:])
                prof = row["profile"] or {}
                turns[cell][who].append({
                    "ms_per_step": row["ms_per_step"], "split_ms": row["split_ms"],
                    "device_ms": prof.get("device_us", 0) / 1e3,
                    "busy_share": prof.get("busy_share"),
                    "ssd_bwd_top_us": {k: v for k, v in prof.get("top_us", {}).items()
                                       if "ssd_bwd" in k}})
    for cell, by in turns.items():
        med = {who: statistics.median(r["ms_per_step"] for r in rows) for who, rows in by.items()}
        print(json.dumps({"cell": cell, "order": "base,this,this,base" + f" x {rounds}",
                          "base": by["base"], "this": by["this"],
                          "base_median_ms_per_step": med["base"],
                          "this_median_ms_per_step": med["this"]}), flush=True)


def main() -> int:
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("flash_turns_chip: no CUDA device available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if not args or args[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    base_root = Path(args[0]).resolve()
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 3
    if "--train" in args:
        train_turns(base_root, int(args[args.index("--rounds") + 1]) if "--rounds" in args else 1)
        print_card()
        return 0
    if "--backward" in args or "--ssd" in args:
        if "--backward" in args:
            backward_turns(base_root, rounds)
        ssd_turns(base_root, rounds)
        print_card()
        return 0
    (base, base_lse), (this, this_lse) = (library(base_root, "flash_attention_base"),
                                          library(ROOT, "flash_attention_this"))
    with ThreadPoolExecutor(2) as pool:  # one nvcc per tree, together
        list(pool.map(lambda lib: lib.build(), (base, this)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, H, KV in SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        o_base, o_this, o_train = (torch.empty_like(q) for _ in range(3))
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        runs = {"base": launcher(base, base_lse, q, k, v, o_base),
                "this": launcher(this, this_lse, q, k, v, o_this)}
        train = launcher(this, this_lse, q, k, v, o_train, lse)
        turns = {"base": [], "this": []}
        for _ in range(rounds):
            for who in ("base", "this", "this", "base"):
                turns[who].append(CS.graph_ms(runs[who]))
        train_ms = CS.graph_ms(train)
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": f"{label}: B={B}, S={S}, H={H}, KV={KV}, D=Dv={D}, bf16, causal",
            "order": "base,this,this,base" + f" x {rounds}",
            "base_ms": turns["base"], "this_ms": turns["this"],
            "base_median_ms": statistics.median(turns["base"]),
            "this_median_ms": statistics.median(turns["this"]),
            "this_over_base": statistics.median(turns["this"]) / statistics.median(turns["base"]),
            "this_train_lse_ms": train_ms,
            "outputs_equal": bool(torch.equal(o_base, o_this) and torch.equal(o_this, o_train)),
        }), flush=True)
    print_card()
    return 0


def print_card() -> None:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])


if __name__ == "__main__":
    sys.exit(main())
