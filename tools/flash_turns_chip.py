"""The bf16 flash-attention forward of two trees, in turns on the card.

    PYTHONPATH=src python tools/flash_turns_chip.py BASE_ROOT [--rounds N]

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
"""
from __future__ import annotations

import ctypes
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
