"""The CUDA paged KV gather against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one (the kernel has no CPU
mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kv_gather.py``.
This file imports neither JAX nor ``repro``. A gather copies values, so
the kernel must equal the plain version bit for bit: at the sweep shapes
of ``tests/test_kernels.py`` and Phi-4-mini's serving shape, in float32,
bfloat16 and int32, with int32 and int64 tables, and on page pools that
are not 16-byte aligned.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.kv_gather import kv_gather
from repro_torch.kernels.kv_gather.kv_gather import LAUNCHES, kv_gather_cuda
from repro_torch.kernels.kv_gather.ref import kv_gather_ref

SWEEP = [(10, 8, 32, 3, 4), (64, 16, 128, 2, 8)]  # (n_pages, page, KVD, B, mp)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _inputs(rng, n_pages, page, KVD, B, mp, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if dtype == "int32":
        pages = torch.as_tensor(rng.integers(0, 100, (n_pages, page, KVD), dtype=np.int32))
    else:
        pages = torch.as_tensor(rng.standard_normal((n_pages, page, KVD), dtype=np.float32))
    table = torch.as_tensor(rng.integers(0, n_pages, (B, mp), dtype=np.int32))
    table.view(-1)[-1] = table.view(-1)[0]  # a repeated id
    return pages.to("cuda", DTYPES[dtype]), table.to("cuda")


SERVING = (512, 16, 2048, 4, 32)  # Phi-4-mini's K|V page: 2 x 8 KV heads x 128


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SWEEP + [SERVING], ids=["sweep0", "sweep1", "serving"])
def test_kernel_matches_plain(shape, dtype):
    p, t = _inputs(np.random.default_rng(sum(shape)), *shape, dtype)
    before = LAUNCHES["kv_gather"]
    got = kv_gather(p, t)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_gather"] == before + 1
    assert torch.equal(got, kv_gather_ref(p, t))
    assert torch.equal(kv_gather_cuda(p, t.to(torch.int64)), got)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,KVD", [(1, 32), (0, 3), (1, 3)])
def test_kernel_unaligned_pages(offset, KVD):
    """Page bytes or base address not 16-byte aligned: the narrow path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n_pages, page = 10, 8
    flat = torch.arange(n_pages * page * KVD + offset, dtype=torch.float32,
                        device="cuda")
    pages = flat[offset:].view(n_pages, page, KVD)
    table = torch.tensor([[3, 1, 3], [9, 0, 2]], dtype=torch.int32, device="cuda")
    assert torch.equal(kv_gather_cuda(pages, table), kv_gather_ref(pages, table))


@pytest.mark.gpu
def test_kernel_refuses_out_of_range_ids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pages = torch.zeros((4, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="page ids"):
        kv_gather(pages, torch.tensor([[0, 4]], dtype=torch.int32, device="cuda"))
