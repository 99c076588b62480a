"""The port's Checkpointer: the mirrors of ``tests/test_checkpoint.py``,
and checkpoints restored across the packages in both directions, bit for
bit (the on-disk format is the JAX package's: ``step_<n>/manifest.json``
and ``arrays_<proc>.npz``, JAX ``keystr`` keys, bf16 as raw bytes)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.checkpoint.checkpointer import _flatten

torch.set_num_threads(1)


def _tree():
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _random_tree(rng):
    """bf16, float32 and int32 leaves, one zero-size, nested two deep."""
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "params": {"blocks": {"attn": {"wq": a(2, 8, 4, 3)}, "ln1": {"scale": a(2, 8)}},
                   "embed": {"embedding": a(16, 8)}, "empty": a(0, 3)},
        "opt": {"m": {"x": a(5)}, "step": np.asarray(3, np.int32)},
    }


DT = {"['params']['blocks']['attn']['wq']": "bfloat16", "['params']['embed']['embedding']":
      "bfloat16", "['params']['empty']": "bfloat16"}


def _as_torch(tree, path=()):
    if isinstance(tree, dict):
        return {k: _as_torch(v, path + (k,)) for k, v in tree.items()}
    key = "".join(f"[{k!r}]" for k in path)
    t = torch.as_tensor(tree)
    return t.to(torch.bfloat16) if DT.get(key) == "bfloat16" else t


def _as_jax(tree, path=()):
    if isinstance(tree, dict):
        return {k: _as_jax(v, path + (k,)) for k, v in tree.items()}
    key = "".join(f"[{k!r}]" for k in path)
    return jnp.asarray(tree, jnp.bfloat16 if DT.get(key) == "bfloat16" else tree.dtype)


def _bits(x):
    """A leaf's bytes and dtype name, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return str(t.dtype).removeprefix("torch."), tuple(t.shape), raw.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    t = _tree()
    ck.save(3, t)
    out = ck.restore(3, t)
    for key, leaf in _flatten(out).items():
        assert _bits(leaf) == _bits(_flatten(t)[key])


def test_latest_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert latest_step(tmp_path) == 4
    steps = sorted(int(p.name.split("_")[1]) for p in Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_async_save_waits(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(1, _tree())
    ck.wait()
    assert latest_step(tmp_path) == 1


def test_no_tmp_left_behind(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(5, _tree())
    assert not list(Path(tmp_path).glob("*.tmp"))
    m = json.loads((Path(tmp_path) / "step_5" / "manifest.json").read_text())
    assert m["step"] == 5
    assert m["arrays"]["['nested']['b']"] == {"shape": [5], "dtype": "bfloat16"}


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, {"w": torch.zeros((3,))})
    with pytest.raises(ValueError):
        ck.restore(1, {"w": torch.empty((4,), device="meta")})
    with pytest.raises(KeyError):
        ck.restore(1, {"v": torch.empty((3,), device="meta")})


def test_restore_casts_to_the_structure(tmp_path):
    """The restored leaf takes the structure's dtype (and the CPU for a
    ``meta`` leaf); a save copies to the host at once, so later in-place
    updates do not reach the checkpoint."""
    ck = Checkpointer(tmp_path, async_save=True)
    t = _tree()
    ck.save(2, t)
    t["w"].add_(1.0)
    ck.wait()
    out = ck.restore(2, {"w": torch.empty((3, 4), dtype=torch.float64, device="meta"),
                         "nested": {"b": torch.empty(5), "step": torch.empty((), dtype=torch.int64)}})
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(12.0, dtype=torch.float64).reshape(3, 4))
    assert out["nested"]["b"].dtype == torch.float32 and int(out["nested"]["step"]) == 7


def test_jax_saves_port_restores(tmp_path):
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    JCheckpointer(tmp_path, async_save=False).save(4, _as_jax(tree), metadata={"arch": "x"})
    like = _as_torch(tree)
    out = Checkpointer(tmp_path, async_save=False).restore(4, like)
    want = _flatten(_as_jax(tree))
    for key, leaf in _flatten(out).items():
        assert _bits(leaf) == _bits(want[key]), key


def test_port_saves_jax_restores(tmp_path):
    rng = np.random.default_rng(1)
    tree = _random_tree(rng)
    Checkpointer(tmp_path, async_save=False).save(6, _as_torch(tree))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), _as_jax(tree))
    out = JCheckpointer(tmp_path, async_save=False).restore(6, like)
    want = _flatten(_as_torch(tree))
    paths = jax.tree_util.tree_flatten_with_path(out)[0]
    assert len(paths) == len(want)
    for path, leaf in paths:
        assert _bits(leaf) == _bits(want[jax.tree_util.keystr(path)])
