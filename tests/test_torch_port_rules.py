"""Ground rules of the PyTorch port, checked on the CPU.

* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
  the JAX package ``repro``;
* importing the port builds nothing and the entry points (the simulator,
  the design-space driver, the traffic compiler's replay, the explorer and
  serving) never drop to the CPU silently: without a card and without
  ``device="cpu"`` they raise;
* every configuration value the port does not implement yet is refused
  with ``NotImplementedError``; the simulator's knobs are all ported and
  accepted (through ``NocParams``, ``FabricSpec`` and ``convert``).
* every CUDA kernel's wrapper refuses CPU tensors, and a naive step whose
  unfused apply launch is refused raises (no fallback).
"""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.noc import dse
from repro_torch.core.noc import ml_traffic as ML
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import traffic as TT
from repro_torch.core.noc.engine import make_tables
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.spec import FabricSpec, preset
from repro_torch.core.noc.topology import build_mesh
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.kernels.kv_gather.kv_gather import kv_gather_cuda
from repro_torch.kernels.noc_router import noc_router, ref
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.models import model as TM
from repro_torch.models.attention import attention
from repro_torch.noc_explore import main as explore
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port in a fresh interpreter (the test
    process itself has JAX loaded)."""
    mods = _port_modules()
    assert "repro_torch.core.noc.sim" in mods and len(mods) >= 15
    assert {"repro_torch.core.noc.ml_traffic", "repro_torch.core.noc.spec",
            "repro_torch.core.noc.dse", "repro_torch.noc_explore",
            "repro_torch.models.moe"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "from repro_torch.kernels.flash_attention import flash_attention\n"
        "from repro_torch.kernels.noc_router import noc_router\n"
        "from repro_torch.kernels.rmsnorm import rmsnorm\n"
        "from repro_torch.kernels.ssd import ssd\n"
        "kv_gather = importlib.import_module('repro_torch.kernels.kv_gather.kv_gather')\n"
        "print(bad, [k.LIBRARY.lib for k in (noc_router, flash_attention, rmsnorm, ssd,\n"
        "                                    kv_gather)])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    # nothing of JAX, and no kernel library built or loaded by importing
    assert out.stdout.strip() == "[] [None, None, None, None, None]", out.stdout


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_no_source_of_the_port_names_jax_or_repro(path):
    files = [ROOT / path] if path.endswith(".py") else sorted(
        (ROOT / path).rglob("*.py"))
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {name}"


def test_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = build_mesh(nx=4, ny=2)
    wl = TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.build_sim(topo, NocParams(), wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tables(topo)
    sim = TS.build_sim(topo, NocParams(), wl, device="cpu")
    assert sim.init_state().fabric.in_buf.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dse.run_dse([preset("mesh", workload="neighbor")])
    phase = ML.compile_traffic(get_config("phi4-mini-3.8b").reduced(),
                               ML.ParallelismSpec(tp=4), build_mesh(nx=4, ny=4),
                               workloads=["tp"])[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ML.validate_phase(build_mesh(nx=4, ny=4), phase, NocParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explore(["--sweep"])  # the explorer's default device is cuda


def test_cuda_wrappers_refuse_cpu_tensors():
    buf = torch.zeros((1, 1, 5, 2, ref.NF), dtype=torch.int32)
    cnt = torch.zeros((1, 1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        noc_router.arb_cuda(buf, cnt, cnt, cnt, cnt,
                            torch.zeros((1, 1), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        kv_gather_cuda(torch.zeros((2, 1, 8)), torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("kw,item", [
    ({"n_vcs": 2}, None),
    ({"collective_offload": True}, None),
    ({"fused_cycles": 4}, None),
    ({"step_impl": "naive"}, None),
], ids=["kw0-item 7", "kw1-item 9", "kw2-item 6", "kw3-item 4"])
def test_unported_params_raise(kw, item):
    """Virtual channels, super-steps, collective offload and the naive
    step are ported and accepted (together too: ``test_params_from_jax_
    fields_drop_the_pallas_knobs``), through ``NocParams`` and
    ``FabricSpec``; an unknown step is refused as in JAX."""
    assert item is None  # no simulator knob is refused any more
    params = NocParams(**kw)
    assert all(getattr(params, k) == v for k, v in kw.items())
    assert FabricSpec(**kw).params() == params
    with pytest.raises(ValueError, match="step_impl"):
        NocParams(step_impl="fancy")


def test_unported_groups_raise():
    """Collective groups are ported: they build offload tables, and
    ``build_sim`` refuses them, as the JAX package does, without
    ``collective_offload`` or when the workload's group count differs."""
    topo = build_mesh(nx=4, ny=2)
    wl = TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=1)
    assert make_tables(topo, groups=[{"root": 0, "members": [1]}],
                       device="cpu").n_groups == 1
    with pytest.raises(ValueError, match="collective_offload"):
        TS.build_sim(topo, NocParams(), wl, groups=[{"root": 0}], device="cpu")
    with pytest.raises(ValueError, match="group"):
        TS.build_sim(topo, NocParams(collective_offload=True),
                     dataclasses.replace(wl, n_groups=1), device="cpu")
    sim = TS.build_sim(topo, NocParams(collective_offload=True), wl,
                       groups=[{"root": 0, "members": [1, 2]}], device="cpu")
    st = sim.init_state()
    assert tuple(st.fabric.red_got.shape) == (3, 8, 1, 5)
    with pytest.raises(ValueError, match="fused_cycles"):
        NocParams(collective_offload=True, fused_cycles=4)


def test_params_from_jax_fields_drop_the_pallas_knobs():
    fields = dataclasses.asdict(NocParams(n_channels=4))
    fields.update(backend="pallas", router_tile=8)
    assert convert.params_from_dict(fields) == NocParams(n_channels=4)
    assert convert.params_from_dict(
        {**fields, "n_vcs": 2, "fused_cycles": 4}) == NocParams(
            n_channels=4, n_vcs=2, fused_cycles=4)
    assert convert.params_from_dict(
        {**fields, "collective_offload": True}) == NocParams(
            n_channels=4, collective_offload=True)
    assert convert.params_from_dict(
        {**fields, "step_impl": "naive", "n_vcs": 2}) == NocParams(
            n_channels=4, step_impl="naive", n_vcs=2)


class _RefusingLibrary:
    """A router library whose arb launches succeed (writing nothing) and
    whose apply launches are refused with CUDA error 700, recording each
    apply launch's FIFO mode."""

    def __init__(self):
        self.apply_modes = []

    def noc_arb_launch(self, *args):
        return 0

    def noc_apply_launch(self, *args):
        self.apply_modes.append(args[-2])  # (..., V, fused, stream)
        return 700


def test_naive_step_refused_unfused_launch_raises(monkeypatch):
    """A naive step dispatched to the CUDA kernels launches the apply
    kernel in its unfused mode; when that launch is refused the step
    raises, counts nothing and runs no plain version in its place. Driven
    on CPU tensors with the device dispatch and the wrappers' CUDA check
    patched and a stand-in library (no card here)."""
    from repro_torch.kernels.noc_router import ops as router_ops

    lib = _RefusingLibrary()
    monkeypatch.setattr(router_ops, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(noc_router, "_require_cuda", lambda name, dev: None)
    monkeypatch.setattr(noc_router, "_stream", lambda dev: None)
    monkeypatch.setattr(noc_router.LIBRARY, "load", lambda: lib)

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran in place of the kernel")

    for name in ("router_cycle_reference", "router_cycle_offload_reference"):
        monkeypatch.setattr(router_ops, name, no_plain)
    topo = build_mesh(nx=4, ny=2)
    wl = TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=1)
    before = dict(noc_router.LAUNCHES)
    for impl, mode in (("naive", 0), ("fast", 1)):
        sim = TS.build_sim(topo, NocParams(step_impl=impl), wl, device="cpu")
        with pytest.raises(RuntimeError, match="noc_apply_kernel launch failed"):
            TS.run(sim, 1)
        assert lib.apply_modes[-1] == mode
    assert noc_router.LAUNCHES["arb"] == before["arb"] + 2
    for key in ("apply", "apply_unfused"):
        assert noc_router.LAUNCHES[key] == before[key]


def test_model_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel.rmsnorm_cuda(x, torch.ones(64), 1e-5)
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_cuda(q, q, q)
    x, bc, h = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 4)), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_cuda(x, torch.zeros((1, 8, 2)), bc, bc, h, h, 4)


def test_serving_entry_points_refuse_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi4-mini-3.8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg)
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)
    assert Engine(cfg, params, device="cpu").device.type == "cpu"


def _config(arch):
    """A registered config, or for ``<arch>-mla`` that config with MLA
    attention, for ``<arch>-vision`` that config with the vision front end."""
    if arch.endswith("-mla"):
        return get_config(arch.removesuffix("-mla")).replace(attn_kind="mla")
    if arch.endswith("-vision"):
        return get_config(arch.removesuffix("-vision")).replace(modality="vision")
    return get_config(arch)


@pytest.mark.parametrize("arch", ["gemma3-4b-mla", "seamless-m4t-medium-mla",
                                  "llama4-scout-17b-a16e-vision", "zamba2-7b-mla"])
def test_unported_model_families_raise(arch):
    """Every family runs in the port: dense (GQA, with Gemma 3's
    local:global layers or Qwen2-VL's M-RoPE and vision stub, or MLA),
    ``moe`` with GQA or MLA attention (Llama-4-Scout, DeepSeek-V2), ``ssm``
    (Mamba-2), ``hybrid`` (Zamba2) and ``encdec`` (SeamlessM4T). Refused,
    naming the ROADMAP item: MLA attention in a local:global (Gemma 3's),
    encoder-decoder (SeamlessM4T's) or hybrid (Zamba2's) model, where the
    JAX package would silently build GQA, and a vision front end outside a
    plain dense model (Llama-4-Scout's MoE), where it builds no
    ``patch_proj``."""
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.init_params(_config(arch).reduced(), device="cpu")


def test_unported_model_options_raise():
    """A sliding window runs only in a dense model's local:global layers:
    a window without a period (where the JAX package would apply none), a
    period without a window, or a window in another family is refused."""
    q = torch.zeros((1, 8, 2, 32))
    assert attention(q, q, q, window=4).shape == q.shape
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.param_schema(get_config("phi4-mini-3.8b").replace(sliding_window=64))
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.param_schema(get_config("gemma3-4b").replace(local_global_period=0))
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.param_schema(get_config("gemma3-4b").replace(sliding_window=0))
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.param_schema(get_config("llama4-scout-17b-a16e").replace(sliding_window=64))
    for arch in ("phi4-mini-3.8b", "granite-8b", "mistral-large-123b", "mamba2-130m",
                 "zamba2-7b", "llama4-scout-17b-a16e", "gemma3-4b", "deepseek-v2-236b",
                 "qwen2-vl-72b", "seamless-m4t-medium"):
        assert TM.count_params(get_config(arch)) > 0
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.param_schema(get_config("zamba2-7b").replace(sliding_window=64))


def test_explorer_runs_the_ddp_workload(capsys):
    """``--workload ddp`` prices and simulates the gradient all-reduce of
    the MoE demo model (its parameter count from the MoE schema) on the
    CPU when asked to, delivering every byte; the help lists it.
    ``tests/test_torch_noc_ml_traffic.py`` holds its output to the JAX
    explorer's."""
    explore(["--workload", "ddp", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "== ddp traffic of llama4-scout-17b-a16e-reduced on mesh4x4" in out
    assert "delivered=yes" in out and "delivered=NO" not in out
    with pytest.raises(SystemExit):
        explore(["--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    assert "(ddp/tp/moe/pp)" in help_text and "not ported" not in help_text


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_no_source_of_the_port_imports_ml_dtypes(path):
    """The card's host has no ``ml_dtypes``: checkpoints carry bf16 as raw
    bytes, decoded with ``torch.frombuffer``."""
    files = [ROOT / path] if path.endswith(".py") else sorted((ROOT / path).rglob("*.py"))
    for f in files:
        for name in _imported_names(f):
            assert name.split(".")[0] != "ml_dtypes", f"{f}: imports {name}"


@pytest.mark.parametrize("field,value", [("seq_shard_cache", True), ("manual", True),
                                         ("batch_over_model", True), ("moe_impl", "a2a"),
                                         ("gather_weights", True)])
def test_runtime_mesh_fields_raise(field, value):
    """The port's ``Runtime`` keeps ``remat`` and ``cache_quant``; the JAX
    runtime's mesh fields are refused when set, naming the ROADMAP item."""
    from repro_torch.runtime import Runtime, default_runtime

    rt = default_runtime()
    assert rt.remat and not rt.cache_quant and rt.with_(cache_quant=True).cache_quant
    with pytest.raises(NotImplementedError, match="item 12 step 7b"):
        Runtime(**{field: value})
    with pytest.raises(NotImplementedError, match="item 12 step 7b"):
        rt.with_(**{field: value})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "llama4-scout-17b-a16e",
                                  "gemma3-4b", "deepseek-v2-236b", "seamless-m4t-medium"])
def test_card_training_outside_dense_gqa_raises(arch, monkeypatch):
    """The card trains every family, the full configs at their head dims
    (the backward kernels'); the trainer refuses on the card, before it
    touches it, only a head dim the kernels are not built for (the reduced
    DeepSeek-V2's MLA at D 48 / Dv 32), and ``mode="ddp"`` anywhere, each
    naming the ROADMAP item. The CPU trains every family; without a card
    and without ``device="cpu"`` the trainer raises rather than drop to the
    CPU."""
    from repro_torch.data import DataConfig
    from repro_torch.kernels.flash_attention.flash_attention import admits_grad
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import attention_head_dims, check_trainable

    check_trainable(get_config(arch), torch.device("cuda"))
    cfg = get_config(arch).reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=1)
    dims = attention_head_dims(cfg)
    if dims is None or admits_grad(*dims):
        check_trainable(cfg, torch.device("cuda"))
    else:
        with pytest.raises(NotImplementedError, match="item 12 step 7b"):
            Trainer(cfg, dcfg, TrainerConfig(), device="cuda")
    with pytest.raises(NotImplementedError, match="item 12 step 7b"):
        Trainer(cfg, dcfg, TrainerConfig(mode="ddp"), device="cpu")
    assert Trainer(cfg, dcfg, TrainerConfig(), device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_config("phi4-mini-3.8b").reduced(), dcfg, TrainerConfig())
