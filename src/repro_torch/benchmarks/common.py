"""Shared benchmark plumbing: timing + row construction + paper targets.

The port's copy of the top-level ``benchmarks/common.py``. Two changes:
``timed`` waits for the card before it reads the clock, and runs no
warm-up call by default (the port compiles nothing per call, so a warm-up
would only run each simulation twice).
"""
from __future__ import annotations

import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 0, iters: int = 3):
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return out, dt * 1e6  # us


def row(name: str, us: float, derived, target=None, rel_tol: float = 0.15,
        cmp: str = "approx") -> dict:
    ok = None
    if target is not None and isinstance(derived, (int, float)):
        if cmp == "approx":
            ok = abs(derived - target) <= rel_tol * abs(target)
        elif cmp == "ge":
            ok = derived >= target
        elif cmp == "le":
            ok = derived <= target
    return {"name": name, "us_per_call": round(us, 1), "derived": derived,
            "target": target, "ok": ok}


CSV_HEADER = "name,us_per_call,derived,target,ok"


def csv_line(r: dict) -> str:
    """One CSV line per row dict (blank target/ok when unset) — the shared
    print format of ``repro_torch.benchmarks.run``."""
    tgt = "" if r["target"] is None else r["target"]
    ok = "" if r["ok"] is None else r["ok"]
    return f"{r['name']},{r['us_per_call']},{r['derived']},{tgt},{ok}"
