"""Fault tolerance: straggler monitoring, NaN guards, preemption handling,
and a supervised retry loop with elastic restart (designed for 1000+ nodes;
exercised here with simulated failures in tests/).

A copy of the JAX package's ``repro.train.fault_tolerance`` (pure Python).
"""
from __future__ import annotations

import signal
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    """Per-host step-time EMA; flags persistent stragglers.

    At pod scale the same monitor runs on the coordinator over per-host
    heartbeat timings; here 'hosts' are whatever timing sources are fed in.
    """

    alpha: float = 0.2
    threshold: float = 1.5  # x median EMA
    patience: int = 3
    ema: dict = field(default_factory=dict)
    strikes: dict = field(default_factory=dict)

    def record(self, host: str, step_time_s: float):
        prev = self.ema.get(host)
        self.ema[host] = (
            step_time_s if prev is None else self.alpha * step_time_s + (1 - self.alpha) * prev
        )

    def stragglers(self) -> list[str]:
        if len(self.ema) < 2:
            return []
        med = sorted(self.ema.values())[len(self.ema) // 2]
        out = []
        for h, v in self.ema.items():
            if v > self.threshold * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.patience:
                out.append(h)
        return out


class PreemptionHandler:
    """SIGTERM/SIGINT -> checkpoint-and-exit flag."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handle)
            except ValueError:  # non-main thread (tests)
                pass

    def _handle(self, signum, frame):
        self.requested = True

    def trigger(self):  # for tests
        self.requested = True


@dataclass
class NanGuard:
    """Skip-step policy on non-finite loss; abort after too many in a row."""

    max_consecutive: int = 10
    consecutive: int = 0
    total_skipped: int = 0

    def check(self, loss: float) -> bool:
        """True = apply the step; False = skip (restore last good params)."""
        import math

        if math.isfinite(loss):
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total_skipped += 1
        if self.consecutive > self.max_consecutive:
            raise RuntimeError(f"{self.consecutive} consecutive non-finite losses")
        return False


class Supervisor:
    """Retry loop around a run function: on failure, restore the latest
    checkpoint and resume; supports elastic restart via a rebuild callback
    (new mesh size -> new jitted step + resharded state)."""

    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.1):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0
        self.history: list[str] = []

    def run(self, fn, recover):
        """fn() runs until completion or raises; recover(attempt) rebuilds
        state (restore checkpoint, possibly on a smaller mesh)."""
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001
                self.restarts += 1
                self.history.append(f"{type(e).__name__}: {e}")
                if self.restarts > self.max_restarts:
                    raise
                time.sleep(self.backoff_s * 2 ** (self.restarts - 1))
                recover(self.restarts)
