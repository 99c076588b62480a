"""The port's training loss and every parameter's gradient against
``jax.value_and_grad(loss_fn)`` on the CPU in float32, with JAX's initial
parameters carried across (``models.model.params_from_numpy``), on
``granite-8b`` (dense GQA), ``mamba2-130m`` (SSM), ``zamba2-7b`` (hybrid:
two superblocks of Mamba-2 layers, each followed by the tied
``shared_attn`` block, whose gradient sums its two applications'),
``llama4-scout-17b-a16e`` (MoE: float32 routes every token alike, as in
``tests/test_torch_serve.py``), ``gemma3-4b`` (local:global windows, 128
tokens past its 64-token window), ``deepseek-v2-236b`` (MLA and MoE),
``qwen2-vl-72b`` (M-RoPE, the vision stub's ``patch_embeds``) and
``seamless-m4t-medium`` (the encoder-decoder, with ``frames``)
``reduced()``, the batch's front-end inputs from ``SyntheticLM``: the loss and its metrics
within rtol 1e-5, each gradient within atol ``GRAD_ATOL`` x its largest
magnitude (float32 sums in another order through 4 layers and their
backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.runtime import default_runtime
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.models.spec import stack_layers, stacked_shapes

torch.set_num_threads(1)

GRAD_ATOL = 1e-4


def _flat(params):
    return {".".join(str(k.key) for k in path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port_params(cfg, flat):
    p = TM.params_from_numpy(cfg, flat, device="cpu").float()
    for q in p.parameters():
        q.requires_grad_(True)
    return p


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m", "zamba2-7b",
                                  "llama4-scout-17b-a16e", "gemma3-4b", "deepseek-v2-236b",
                                  "qwen2-vl-72b", "seamless-m4t-medium"])
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JM.init_params(jcfg, jax.random.key(0)))
    flat = _flat(jp)
    # Gemma 3's reduced window is 64 tokens: 128 so that it masks
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128 if cfg.sliding_window else 32, global_batch=2,
        seed=4, modality=cfg.modality, d_model=cfg.d_model,
        frontend_tokens=cfg.frontend_tokens)).batch_for_step(0)
    batch["loss_mask"][1, 20:] = 0.0  # a partial mask
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                             default_runtime()), has_aux=True)(jp)
    p = _port_params(cfg, flat)
    loss, met = TM.loss_fn(cfg, p, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert sorted(met) == sorted(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    got = stack_layers({n: q.grad for n, q in p.named_parameters()},
                       stacked_shapes(TM.param_schema(cfg)))
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=GRAD_ATOL * scale, rtol=0,
                                   err_msg=k)
