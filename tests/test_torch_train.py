"""The port's Trainer against the JAX package's, on the CPU in float32,
with JAX's initial parameters carried across
(``models.model.params_from_numpy``); ``loss_fn`` and its gradients are
held to JAX's in ``test_torch_train_loss.py``.

* six Trainer steps against JAX's Trainer (both seeded with JAX's initial
  parameters by overriding ``init_state``): losses and grad norms within
  rtol ``TRAIN_RTOL`` (AdamW's update divides by sqrt(v): the float32
  differences of the gradients grow step by step), the final parameters
  within atol ``PARAM_ATOL``;
* the NaN guard: a skipped step leaves the parameters and the optimizer
  state bit for bit as they were;
* the card's refusals (``check_trainable``, ``mode="ddp"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import model as JM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import trainer as TT

torch.set_num_threads(1)

TRAIN_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _flat(params):
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port_params(cfg, flat):
    p = TM.params_from_numpy(cfg, flat, device="cpu").float()
    for q in p.parameters():
        q.requires_grad_(True)
    return p


def _train_cfgs():
    jcfg, cfg = jax_get_config("granite-8b").reduced(), get_config("granite-8b").reduced()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=1)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    return jcfg, cfg, JDataConfig(**kw), DataConfig(**kw), opt


def test_trainer_matches_jax_over_six_steps():
    jcfg, cfg, jd, td, opt = _train_cfgs()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JM.init_params(jcfg, jax.random.key(3)))
    jtr = JTrainer(jcfg, jd, JTrainerConfig(steps=6, log_every=0, opt=JAdamWConfig(**opt)))
    flat0 = _flat(jp)  # the JAX step donates its parameters
    jtr.init_state = lambda: (jp, jadamw_init(jp))
    jparams, _, jhist = jtr.run(resume=False)
    ttr = TT.Trainer(cfg, td, TT.TrainerConfig(steps=6, log_every=0, opt=AdamWConfig(**opt)),
                     device="cpu")

    def init_state():
        p = _port_params(cfg, flat0)
        return p, adamw_init(dict(p.named_parameters()))

    ttr.init_state = init_state
    params, state, hist = ttr.run(resume=False)
    assert [h["step"] for h in hist] == list(range(6)) and int(state["step"]) == 6
    assert ttr.n_streams == jtr.n_streams
    for h, jh in zip(hist, jhist):
        assert sorted(h) == sorted(jh)
        for k in ("loss", "ce", "z_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(h[k], jh[k], rtol=TRAIN_RTOL, err_msg=k)
    want = _flat(jparams)
    got = TM.params_to_numpy(cfg, params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_nan_step_leaves_the_state_unchanged(monkeypatch):
    """Step 2's loss is made NaN: the guard skips it and the parameters and
    the optimizer state are bit for bit those after step 1; the history
    still records the step, and step 3 goes on from there."""
    _, cfg, _, td, opt = _train_cfgs()
    tr = TT.Trainer(cfg, td, TT.TrainerConfig(steps=4, log_every=0, opt=AdamWConfig(**opt)),
                    device="cpu")
    real, calls, snaps = TM.loss_fn, {"n": 0}, {}

    def loss_fn(cfg_, p, batch, rt=None):
        calls["n"] += 1
        loss, met = real(cfg_, p, batch, rt)
        if calls["n"] == 3:
            snaps["params"] = {k: v.detach().clone() for k, v in p.named_parameters()}
            loss = loss * float("nan")
            met = {**met, "loss": loss}
        return loss, met

    monkeypatch.setattr(TM, "loss_fn", loss_fn)
    real_step = tr.step

    def step(params, opt_state, batch):
        if calls["n"] == 2:  # before step 2: the optimizer state
            snaps["opt"] = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                            else v.clone() for k, v in opt_state.items()}
        out = real_step(params, opt_state, batch)
        if calls["n"] == 3:
            snaps["after"] = ({k: v.detach().clone() for k, v in params.named_parameters()},
                              {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                               else v.clone() for k, v in opt_state.items()})
        return out

    tr.step = step
    _, state, hist = tr.run(resume=False)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert np.isnan(hist[2]["loss"]) and "grad_norm" in hist[2] and "lr" in hist[2]
    assert tr.nan_guard.total_skipped == 1 and int(state["step"]) == 3
    after_p, after_o = snaps["after"]
    for k, v in snaps["params"].items():
        assert torch.equal(after_p[k], v), k
    for key in ("m", "v"):
        for n, t in snaps["opt"][key].items():
            assert torch.equal(after_o[key][n], t), (key, n)
    assert torch.equal(after_o["step"], snaps["opt"]["step"])


def test_card_refuses_what_it_cannot_train():
    """The card trains every family the port runs (dense GQA with
    local:global windows, M-RoPE and the vision stub, MLA, MoE, Mamba-2,
    the hybrid, the encoder-decoder); it refuses only attention at head dims
    the backward kernels are not built for (the reduced DeepSeek-V2's MLA
    at D 48 / Dv 32, a GQA head dim of 48), naming the ROADMAP item before
    anything touches the card, and ``mode="ddp"`` anywhere."""
    dev = torch.device("cuda")
    TT.check_trainable(get_config("phi4-mini-3.8b"), dev)
    TT.check_trainable(get_config("granite-8b").reduced(), dev)
    TT.check_trainable(get_config("mamba2-130m"), dev)
    TT.check_trainable(get_config("zamba2-7b"), dev)
    TT.check_trainable(get_config("zamba2-7b").reduced(), dev)
    for arch in ("llama4-scout-17b-a16e", "gemma3-4b", "deepseek-v2-236b",
                 "seamless-m4t-medium", "qwen2-vl-72b"):
        TT.check_trainable(get_config(arch), dev)
        TT.check_trainable(get_config(arch), torch.device("cpu"))
    assert TT.attention_head_dims(get_config("deepseek-v2-236b")) == (192, 128)
    assert TT.attention_head_dims(get_config("gemma3-4b")) == (256, 256)
    assert TT.attention_head_dims(get_config("mamba2-130m")) is None
    for cfg in (get_config("deepseek-v2-236b").reduced(),
                get_config("granite-8b").reduced().replace(head_dim=48)):
        with pytest.raises(NotImplementedError, match="item 12 step 7b"):
            TT.check_trainable(cfg, dev)
        with pytest.raises(NotImplementedError, match="item 12 step 7b"):
            TT.Trainer(cfg, DataConfig(vocab_size=8, seq_len=8, global_batch=1),
                       TT.TrainerConfig(), device="cuda")
        TT.check_trainable(cfg, torch.device("cpu"))  # the CPU trains every family
    with pytest.raises(NotImplementedError, match="item 12 step 7b"):
        TT.Trainer(get_config("granite-8b").reduced(),
                   DataConfig(vocab_size=8, seq_len=8, global_batch=1),
                   TT.TrainerConfig(mode="ddp"), device="cpu")
