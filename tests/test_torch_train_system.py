"""End-to-end training on the port, on the CPU: the mirrors of
``tests/test_system.py`` (train a tiny model, checkpoint, resume, serve),
and the port's resume held bit-exact against an uninterrupted run."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _dcfg(cfg, seq=64, batch=4):
    return DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        modality=cfg.modality if cfg.family == "encdec" or cfg.modality == "vision" else "text",
        d_model=cfg.d_model, frontend_tokens=cfg.frontend_tokens,
    )


def test_train_loss_decreases():
    cfg = get_config("granite-8b").reduced()
    tcfg = TrainerConfig(steps=60, log_every=0,
                         opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    _, _, hist = Trainer(cfg, _dcfg(cfg), tcfg, device="cpu").run(resume=False)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2


def test_checkpoint_resume_exact(tmp_path):
    """The JAX test's resume at step 10, and then bit-exact on the CPU:
    the resumed run's losses and final parameters and optimizer state equal
    an uninterrupted run's."""
    cfg = get_config("granite-8b").reduced()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    t1 = Trainer(cfg, _dcfg(cfg), TrainerConfig(
        steps=10, log_every=0, ckpt_every=5, ckpt_dir=str(tmp_path / "ck"), opt=opt),
        device="cpu")
    t1.run(resume=False)
    t2 = Trainer(cfg, _dcfg(cfg), TrainerConfig(
        steps=14, log_every=0, ckpt_dir=str(tmp_path / "ck"), opt=opt), device="cpu")
    p2, o2, h2 = t2.run(resume=True)
    assert h2[0]["step"] == 10, "should resume from the checkpoint"
    assert all(np.isfinite(h["loss"]) for h in h2)
    t3 = Trainer(cfg, _dcfg(cfg), TrainerConfig(steps=14, log_every=0, opt=opt), device="cpu")
    p3, o3, h3 = t3.run(resume=False)
    assert [h["loss"] for h in h2] == [h["loss"] for h in h3[10:]]
    for (n, a), (_, b) in zip(p2.named_parameters(), p3.named_parameters()):
        assert torch.equal(a, b), n
    for key in ("m", "v"):
        for n in o3[key]:
            assert torch.equal(o2[key][n], o3[key][n]), (key, n)
    assert torch.equal(o2["step"], o3["step"])


def test_restore_returns_the_saved_tensors(tmp_path):
    """What ``Trainer.restore`` returns equals, bit for bit, what was saved
    (parameters in their dtypes, ``m``, ``v`` and ``step``)."""
    cfg = get_config("phi4-mini-3.8b").reduced()
    tr = Trainer(cfg, _dcfg(cfg, seq=32, batch=2), TrainerConfig(
        steps=2, log_every=0, ckpt_every=2, ckpt_dir=str(tmp_path / "ck")), device="cpu")
    params, opt, _ = tr.run(resume=False)
    rp, ro = tr.restore(2)
    for (n, a), (m, b) in zip(params.named_parameters(), rp.named_parameters()):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b) and b.requires_grad
    for key in ("m", "v"):
        for n in opt[key]:
            assert torch.equal(opt[key][n], ro[key][n])
    assert int(ro["step"]) == 2


def test_serve_batched_requests():
    cfg = get_config("granite-8b").reduced()
    params, _, _ = Trainer(cfg, _dcfg(cfg), TrainerConfig(steps=2, log_every=0),
                           device="cpu").run(resume=False)
    eng = Engine(cfg, params, scfg=ServeConfig(max_new_tokens=6), device="cpu")
    outs = eng.generate([[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]])
    assert len(outs) == 3
    assert all(len(o) == 6 for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)


def test_serve_deterministic_greedy():
    cfg = get_config("mamba2-130m").reduced()
    params, _, _ = Trainer(cfg, _dcfg(cfg), TrainerConfig(steps=2, log_every=0),
                           device="cpu").run(resume=False)
    eng = Engine(cfg, params, scfg=ServeConfig(max_new_tokens=5), device="cpu")
    a = eng.generate([[1, 2, 3, 4]])
    b = eng.generate([[1, 2, 3, 4]])
    assert a == b
