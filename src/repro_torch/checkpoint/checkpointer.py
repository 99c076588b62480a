"""Manifest-driven, atomically published checkpoints with async save: the
counterpart of ``repro.checkpoint.checkpointer``, in its on-disk format.

Layout:  <dir>/step_<n>/manifest.json + arrays_<proc>.npz
  * manifest: flat key -> {shape, dtype}; step; user metadata
  * keys are JAX's ``keystr`` of the saved tree (``['params']['blocks']
    ['attn']['wq']``): a tree is nested dicts of tensors or numpy arrays
  * a dtype numpy cannot store in an npz (bfloat16) is shipped as its raw
    bytes (1-d uint8) under its own name, as JAX's ``_encode`` does, and
    decoded with ``torch.frombuffer``: no ``ml_dtypes``
  * publish is atomic (write to .tmp, os.replace); keep-N garbage collection
  * restore loads every array and checks each against the structure it is
    restored into (shape; the dtype is cast to the target's)

A checkpoint written by either package restores in the other. One process
saves everything (``arrays_0.npz``; the rank's file under
``torch.distributed``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

_NATIVE = {np.dtype(t) for t in ("f2", "f4", "f8", "i1", "i2", "i4", "i8",
                                 "u1", "u2", "u4", "u8", "b1", "c8", "c16")}
# the torch dtypes checkpoints hold, by the name numpy (and ml_dtypes) give them
_TORCH = {"float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
          "bool": torch.bool}
_NAME = {v: k for k, v in _TORCH.items()}


def _to_host(leaf) -> tuple[np.ndarray, list, str]:
    """(the array as the npz stores it, its shape, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _NAME[t.dtype]
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.uint8).numpy().copy()
            return raw, list(t.shape), name
        return t.numpy().copy(), list(t.shape), name
    a = np.asarray(leaf)
    if a.dtype not in _NATIVE:
        raise TypeError(f"cannot store numpy dtype {a.dtype}; pass a torch tensor")
    return a, list(a.shape), str(a.dtype)


def _decode(a: np.ndarray, shape, dtype_name: str) -> torch.Tensor:
    """The saved array as a CPU tensor of its saved dtype and shape."""
    if dtype_name not in _TORCH:
        raise TypeError(f"checkpoint dtype {dtype_name!r} is not one the port reads")
    dt = _TORCH[dtype_name]
    if a.dtype == np.uint8 and dt != torch.uint8:  # raw bytes (bfloat16)
        if a.size == 0:
            return torch.empty(tuple(shape), dtype=dt)
        return torch.frombuffer(bytearray(a.tobytes()), dtype=torch.uint8).view(dt).reshape(
            tuple(shape))
    return torch.from_numpy(np.array(a)).reshape(tuple(shape))


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()) -> dict:
    """``{keystr: leaf}`` of a tree of nested dicts (JAX's key order: sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (k,)))
        return out
    return {_keystr(path): tree}


def _unflatten_like(like, fn, path=()):
    """A tree shaped as ``like`` whose leaves are ``fn(keystr, like_leaf)``."""
    if isinstance(like, dict):
        return {k: _unflatten_like(v, fn, path + (k,)) for k, v in like.items()}
    return fn(_keystr(path), like)


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def latest_step(directory: str | Path) -> int | None:
    """The newest published step under ``directory`` (None if none)."""
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*") if p.is_dir()
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


class Checkpointer:
    """Saves and restores trees of tensors under ``directory``, keeping the
    newest ``keep`` steps; ``async_save`` writes on a thread."""

    def __init__(self, directory: str | Path, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree, metadata: dict | None = None, block: bool = False):
        """Save ``tree`` as ``step``: copied to the host now (so training may
        go on updating its tensors in place), written now or on a thread."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        meta = {
            "step": step,
            "arrays": {k: {"shape": shape, "dtype": name} for k, (_, shape, name) in host.items()},
            "metadata": metadata or {},
        }
        arrays = {k: a for k, (a, _, _) in host.items()}
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, meta)

    def _write(self, step: int, arrays: dict, meta: dict):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / f"arrays_{_process_index()}.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self):
        """Block until an async save has been published."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------- restore
    def restore(self, step: int, like_tree):
        """Restore into the structure of ``like_tree`` (nested dicts whose
        leaves have ``shape`` and ``dtype``: tensors, on any device, the
        ``meta`` device too): each key must be saved with the like leaf's
        shape; the result is cast to its dtype, on its device (the CPU for
        a ``meta`` leaf)."""
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "manifest.json").read_text())
        arrays: dict[str, np.ndarray] = {}
        for f in sorted(d.glob("arrays_*.npz")):
            with np.load(f) as z:
                arrays.update({k: z[k] for k in z.files})

        def leaf(key, like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing {key}")
            am = meta["arrays"][key]
            t = _decode(arrays[key], am["shape"], am["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{key}: saved {tuple(t.shape)} != expected "
                                 f"{tuple(like.shape)}")
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
            dev = "cpu" if torch.device(dev).type == "meta" else dev
            return t.to(device=dev, dtype=like.dtype if isinstance(like, torch.Tensor)
                        else _TORCH[str(np.dtype(like.dtype))])

        return _unflatten_like(like_tree, leaf)
