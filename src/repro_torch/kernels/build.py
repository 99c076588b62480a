"""Build a kernel package's CUDA sources into a ``ctypes``-loaded library.

Every kernel package of the port compiles its ``csrc/*.cu`` the same way:
plain ``nvcc`` for ``sm_90a`` into a shared library with a C interface, at
first use on a CUDA tensor, keyed by a hash of the sources, the local
headers they include and the flags, into ``_build/`` beside the package.
Importing builds nothing; a library for the current sources is built once
and reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def included(sources: Sequence[Path]) -> list[Path]:
    """The sources and, depth first, every header they ``#include "..."``
    (found beside the including file, as ``nvcc`` finds it), each once."""
    seen: list[Path] = []

    def visit(path: Path):
        if path in seen:
            return
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            if (path.parent / name).exists():
                visit(path.parent / name)

    for src in sources:
        visit(Path(src))
    return seen


class CudaLibrary:
    """One package's kernels: ``name`` keys the file, ``declare(lib)`` sets
    the C signatures once the library is loaded."""

    def __init__(self, name: str, sources: Sequence[Path], build_dir: Path,
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.sources = tuple(sources)
        self.build_dir = build_dir
        self._declare = declare
        self.lib = None  # the loaded library, once a launch has needed it
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the built library for the current sources lives: keyed by
        the sources, every local header they include, and the flags."""
        h = hashlib.sha256()
        for src in included(self.sources):
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return self.build_dir / f"{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the kernels unless a library for these sources exists."""
        so = self.path()
        if so.exists():
            return so
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, self.sources)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)  # atomic: concurrent builders agree on the result
        except subprocess.CalledProcessError as err:
            raise RuntimeError(f"nvcc failed:\n{err.stdout}\n{err.stderr}") from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return so

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; declare the C signatures."""
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self.lib = lib
        return self.lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (a null pointer for an absent operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def wants_grad(*tensors) -> bool:
    """Whether autograd would record a function of ``tensors``: grad mode on
    and any of them requiring a gradient."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel launched through
    ``ctypes``: its output would leave autograd's graph, and every input
    upstream would silently get no gradient. The flash-attention and RMSNorm
    kernels are differentiated through their ``ops`` entry points (whose
    ``autograd.Function`` launches them with grad mode off); the others have
    no backward."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: a kernel launched outside autograd's graph was asked for a "
            "gradient; training through it on the card is not ported yet (ROADMAP "
            "Queue 1 item 12 step 7b)")
