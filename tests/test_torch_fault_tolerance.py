"""The port's fault tolerance (copied pure Python) and its Trainer under
preemption and a supervised restart: the mirrors of
``tests/test_fault_tolerance.py`` (the trainer on the CPU)."""
import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.fault_tolerance import NanGuard, StragglerMonitor, Supervisor
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def test_straggler_monitor_flags_persistent_slow_host():
    m = StragglerMonitor(patience=3)
    for step in range(10):
        for h in ("h0", "h1", "h2", "h3"):
            m.record(h, 1.0 if h != "h2" else 2.5)
        flagged = m.stragglers()
    assert flagged == ["h2"]


def test_straggler_monitor_tolerates_transient_blip():
    m = StragglerMonitor(patience=3)
    for step in range(10):
        for h in ("h0", "h1", "h2"):
            slow = h == "h2" and step == 4  # one blip only
            m.record(h, 3.0 if slow else 1.0)
        flagged = m.stragglers()
    assert flagged == []


def test_nan_guard_skips_then_aborts():
    g = NanGuard(max_consecutive=3)
    assert g.check(1.0)
    assert not g.check(float("nan"))
    assert not g.check(float("inf"))
    assert g.check(2.0)  # recovers
    assert g.consecutive == 0
    with pytest.raises(RuntimeError):
        for _ in range(5):
            g.check(float("nan"))


def test_supervisor_retries_then_succeeds():
    calls = {"n": 0, "recovered": []}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"injected failure {calls['n']}")
        return "done"

    sup = Supervisor(max_restarts=5, backoff_s=0.0)
    out = sup.run(fn, recover=lambda attempt: calls["recovered"].append(attempt))
    assert out == "done"
    assert sup.restarts == 2
    assert calls["recovered"] == [1, 2]


def test_supervisor_gives_up():
    sup = Supervisor(max_restarts=2, backoff_s=0.0)
    with pytest.raises(RuntimeError):
        sup.run(lambda: (_ for _ in ()).throw(RuntimeError("always")), recover=lambda a: None)
    assert sup.restarts == 3


def test_preemption_checkpoints_and_exits(tmp_path):
    cfg = get_config("granite-8b").reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    tr = Trainer(cfg, dcfg, TrainerConfig(steps=50, log_every=0,
                                          ckpt_dir=str(tmp_path / "ck")), device="cpu")
    tr.preempt.trigger()
    _, _, hist = tr.run(resume=False)
    assert len(hist) == 0  # exited before the first step
    assert latest_step(tmp_path / "ck") == 0


def test_training_survives_restart_with_supervisor(tmp_path):
    """Simulated crash mid-training; supervisor restores and completes."""
    cfg = get_config("granite-8b").reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    state = {"attempt": 0}

    def attempt():
        state["attempt"] += 1
        tr = Trainer(cfg, dcfg, TrainerConfig(
            steps=8, log_every=0, ckpt_every=2, ckpt_dir=str(tmp_path / "ck")), device="cpu")
        if state["attempt"] == 1:
            tr.tcfg.steps = 5
            tr.run(resume=False)
            raise RuntimeError("injected node failure")
        _, _, hist = tr.run(resume=True)
        return hist

    sup = Supervisor(max_restarts=2, backoff_s=0.0)
    hist = sup.run(attempt, recover=lambda a: None)
    assert hist[0]["step"] == 4  # resumed from the step-4 checkpoint
    assert hist[-1]["step"] == 7
