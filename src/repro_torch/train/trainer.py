"""Trainer: the JAX package's ``repro.train.trainer`` on one device, with
checkpointing, the NaN guard, the straggler monitor and preemption handling.

JAX's ``"gspmd"`` mode on one device is a plain step, and that is the
port's: ``loss_fn`` forward, ``backward()``, then ``adamw_update`` in place.
``mode="ddp"`` (shard_map and FlooNoC's multi-stream gradient sync) needs
several devices and raises, naming its ROADMAP item. The NaN guard sees the
loss before anything is updated: a skipped step leaves the parameters and
the optimizer state exactly as they were (JAX discards the step's new
buffers; the port never writes them). Checkpoints are the JAX package's
(``{"params", "opt"}``, stacked layers, JAX's keys), so either package
restores the other's.

On a card the step's attention, RMSNorm and SSD scan run through the
hand-written kernels and their backward kernels (``kernels.flash_attention.
ops``, ``kernels.rmsnorm.ops``, ``kernels.ssd.ops``); no plain version runs.
That covers every family the port runs: dense GQA (with Gemma 3's
local:global windows, M-RoPE and the vision stub), MLA, ``moe`` (the
grouped product ``torch._grouped_mm`` differentiated by autograd, as JAX
differentiates its ``ragged_dot`` outside any Pallas kernel), ``ssm``
(Mamba-2), ``hybrid`` (Zamba2: Mamba-2 layers and a tied GQA block, whose
gradient autograd sums over its applications) and ``encdec`` (SeamlessM4T).
The card refuses only attention head dims that the backward kernels are not
built for. On the CPU every family that ``loss_fn`` runs trains, through the
plain versions, which autograd differentiates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs.base import ModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import admits_grad
from repro_torch.models import model as M
from repro_torch.models.spec import (
    DTYPES,
    build_tree,
    count_params_tree,
    layer_specs,
    nest,
    stack_layers,
    stacked_shapes,
    unnest,
    unstack_into,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
)
from repro_torch.runtime import Runtime, default_runtime
from repro_torch.train.fault_tolerance import NanGuard, PreemptionHandler, StragglerMonitor

ITEM_7B = "ROADMAP Queue 1 item 12 step 7b"


@dataclass
class TrainerConfig:
    """The training run's settings (the JAX package's fields)."""

    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 0  # 0 = disabled
    ckpt_dir: str | None = None
    mode: str = "gspmd"  # "gspmd" | "ddp"
    n_streams: int = 0  # 0 = ask the NoC-aware scheduler
    compress_pod: bool = False
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def attention_head_dims(cfg: ModelConfig) -> tuple[int, int] | None:
    """(D, Dv) of the model's attention (MLA: the rotary and non-rotary query
    dims, and the value dim), or None for an attention-free model."""
    if cfg.family == "ssm":
        return None
    if cfg.attn_kind == "mla":
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def check_trainable(cfg: ModelConfig, device: torch.device):
    """Raise ``NotImplementedError`` where the card cannot train ``cfg``: an
    attention whose head dims the backward kernels are not built for."""
    dims = attention_head_dims(cfg)
    if device.type != "cuda" or dims is None or admits_grad(*dims):
        return
    raise NotImplementedError(
        f"{cfg.name}: training attention at D={dims[0]}, Dv={dims[1]} on the card is not "
        f"ported (the backward kernels' head dims; {ITEM_7B})")


class Trainer:
    """Trains ``cfg`` on ``data_cfg``'s synthetic stream on one device (a
    card unless ``device`` names another)."""

    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig, tcfg: TrainerConfig,
                 rt: Runtime | None = None, device=None):
        self.cfg, self.dcfg, self.tcfg = cfg, data_cfg, tcfg
        self.rt = rt or default_runtime()
        self.device = resolve_device(device)
        if tcfg.mode == "ddp":
            raise NotImplementedError(
                "Trainer mode 'ddp' (shard_map with FlooNoC's multi-stream gradient sync) "
                f"needs several devices, which the port does not drive yet ({ITEM_7B})")
        M.check_supported(cfg)
        check_trainable(cfg, self.device)
        self.monitor = StragglerMonitor()
        self.nan_guard = NanGuard()
        self.preempt = PreemptionHandler(install=False)
        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.source = SyntheticLM(data_cfg)
        self.schema = M.param_schema(cfg)
        self.shapes = stacked_shapes(self.schema)
        n_params = count_params_tree(self.schema)
        if tcfg.n_streams == 0:
            plan = sched.suggest(n_params * 4, data_shards=1, pods=1, compute_s=1.0)
            self.n_streams = plan["n_streams"]
        else:
            self.n_streams = tcfg.n_streams
        # with time_phases set, each step synchronises the device between its
        # phases and records their milliseconds here
        self.time_phases = False
        self.last_phases: dict = {}

    # ------------------------------------------------------------------
    def _trainable(self, params):
        for p in params.parameters():
            if p.is_floating_point():
                p.requires_grad_(True)
        return params

    def init_state(self):
        """Random parameters from a generator seeded by ``tcfg.seed`` on the
        trainer's device, made trainable, and a fresh AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self._trainable(M.init_params(self.cfg, gen, device=self.device))
        return params, adamw_init(dict(params.named_parameters()))

    def _device_batch(self, batch: dict):
        """The numpy batch on the device; ``patch_embeds`` / ``frames`` in
        bf16, as the JAX trainer casts them."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if k in ("patch_embeds", "frames") and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            out[k] = t.to(self.device)
        return out

    def _mark(self, marks):
        if self.time_phases:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

    def step(self, params, opt, batch):
        """One training step on a device batch. Returns its metrics (the
        loss's, ``grad_norm`` and ``lr``) as floats; the update is applied in
        place only if the NaN guard passes the loss."""
        marks = []
        self._mark(marks)
        for p in params.parameters():
            p.grad = None
        loss, metrics = M.loss_fn(self.cfg, params, batch, self.rt)
        self._mark(marks)
        loss.backward()
        self._mark(marks)
        named = dict(params.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        applied = self.nan_guard.check(float(loss.detach()))
        with torch.no_grad():
            if applied:
                _, _, om = adamw_update(self.tcfg.opt, named, grads, opt)
            else:  # the step's metrics, nothing written
                om = {"grad_norm": global_norm(grads),
                      "lr": lr_schedule(self.tcfg.opt, opt["step"] + 1)}
        self._mark(marks)
        for p in params.parameters():
            p.grad = None
        if self.time_phases:
            self.last_phases = {name: (b - a) * 1e3 for name, a, b in zip(
                ("forward_ms", "backward_ms", "update_ms"), marks, marks[1:])}
        return {k: float(v.detach()) for k, v in {**metrics, **om}.items()}

    # ------------------------------------------------------------------
    def state_tree(self, params, opt):
        """The JAX package's checkpoint tree of (params, opt): nested dicts
        of stacked host tensors under ``params`` and ``opt`` (``m``, ``v``,
        ``step``)."""
        named = dict(params.named_parameters())
        return {
            "params": nest(stack_layers(named, self.shapes)),
            "opt": {"m": nest(stack_layers(opt["m"], self.shapes)),
                    "v": nest(stack_layers(opt["v"], self.shapes)),
                    "step": opt["step"].detach().cpu()},
        }

    def run(self, resume: bool = True):
        """Train from the newest checkpoint (with ``resume``) or from
        ``init_state`` to ``tcfg.steps``. Returns (params, opt, history)."""
        start = 0
        params = opt = None
        if resume and self.ckpt is not None:
            s = latest_step(self.ckpt.dir)
            if s is not None:
                params, opt = self.restore(s)
                start = s
        if params is None:
            params, opt = self.init_state()

        history = []
        for step in range(start, self.tcfg.steps):
            if self.preempt.requested:
                if self.ckpt:
                    self.ckpt.save(step, self.state_tree(params, opt), block=True)
                break
            t0 = time.time()
            batch = self._device_batch(self.source.batch_for_step(step))
            metrics = self.step(params, opt, batch)
            loss = metrics["loss"]
            dt = time.time() - t0
            self.monitor.record("host0", dt)
            history.append({"step": step, "loss": loss, "time_s": dt, **metrics})
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f} ms", flush=True)
            if self.ckpt and self.tcfg.ckpt_every and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state_tree(params, opt),
                               metadata={"arch": self.cfg.name})
        if self.ckpt:
            self.ckpt.wait()
        return params, opt, history

    def restore(self, step: int):
        """(params, opt) of checkpoint ``step``, on the trainer's device."""
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
        dtypes = {k: DTYPES[s.dtype] for k, s in layer_specs(self.schema).items()}
        like = {
            "params": nest({k: meta(sh, dtypes[k]) for k, sh in self.shapes.items()}),
            "opt": {"m": nest({k: meta(sh, torch.float32) for k, sh in self.shapes.items()}),
                    "v": nest({k: meta(sh, torch.float32) for k, sh in self.shapes.items()}),
                    "step": meta((), torch.int32)},
        }
        out = self.ckpt.restore(step, like)
        dev = self.device
        params = build_tree(self.schema, lambda path, s: torch.empty(
            s.shape, dtype=DTYPES[s.dtype], device=dev))
        named = dict(params.named_parameters())
        unstack_into(named, unnest(out["params"]))
        opt = adamw_init(named)
        unstack_into(opt["m"], unnest(out["opt"]["m"]))
        unstack_into(opt["v"], unnest(out["opt"]["v"]))
        opt["step"].copy_(out["opt"]["step"])
        return self._trainable(params), opt

