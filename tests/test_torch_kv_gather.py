"""The port's paged KV gather (``repro_torch.kernels.kv_gather``) against
the JAX package's: the plain version equal to JAX ``kv_gather_ref`` and to
the Pallas kernel in interpret mode, bit for bit, at the sweep shapes of
``tests/test_kernels.py`` in float32, bfloat16 and int32; repeated ids;
ids out of range raise. The CUDA kernel against the plain version, also
bit for bit, is in ``tests/test_torch_cuda_kv_gather.py`` (card only).

A gather copies values, so every tolerance is exact equality. bfloat16
travels between the packages as float32, which holds every bfloat16 value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_gather import kv_gather as jax_kv_gather
from repro.kernels.kv_gather.ref import kv_gather_ref as jax_kv_gather_ref
from repro_torch.kernels.kv_gather import kv_gather
from repro_torch.kernels.kv_gather.kv_gather import kv_gather_cuda
from repro_torch.kernels.kv_gather.ref import kv_gather_ref

torch.set_num_threads(1)

SWEEP = [(10, 8, 32, 3, 4), (64, 16, 128, 2, 8)]  # (n_pages, page, KVD, B, mp)
DTYPES = ["float32", "bfloat16", "int32"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _inputs(rng, n_pages, page, KVD, B, mp, dtype):
    """Pages as numpy float32 (int32 for int32) that the dtype holds
    exactly, and a [B, mp] int32 table."""
    if dtype == "int32":
        pages = rng.integers(0, 100, (n_pages, page, KVD), dtype=np.int32)
    else:
        pages = rng.standard_normal((n_pages, page, KVD), dtype=np.float32)
        if dtype == "bfloat16":
            pages = np.array(jnp.asarray(pages, jnp.bfloat16).astype(jnp.float32))
    table = rng.integers(0, n_pages, (B, mp), dtype=np.int32)
    return pages, table


def _port(pages, table, dtype):
    return torch.tensor(pages).to(TORCH[dtype]), torch.tensor(table)


def _np(t):
    return t.cpu().to(torch.float32 if t.dtype == torch.bfloat16 else t.dtype).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_pages,page,KVD,B,mp", SWEEP)
@pytest.mark.parametrize("jax_fn", ["ref", "pallas_interpret"])
def test_plain_matches_jax(jax_fn, n_pages, page, KVD, B, mp, dtype):
    rng = np.random.default_rng(n_pages + KVD)
    pages, table = _inputs(rng, n_pages, page, KVD, B, mp, dtype)
    jp, jt = jnp.asarray(pages, JNP[dtype]), jnp.asarray(table)
    want = (jax_kv_gather_ref(jp, jt) if jax_fn == "ref"
            else jax_kv_gather(jp, jt, interpret=True))
    got = kv_gather(*_port(pages, table, dtype))
    assert got.dtype == TORCH[dtype]
    assert tuple(got.shape) == (B, mp * page, KVD)
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(
        jnp.float32 if dtype == "bfloat16" else want.dtype)))


def test_repeated_ids_copy_twice_and_int64_tables():
    rng = np.random.default_rng(3)
    pages, table = _inputs(rng, 10, 8, 32, 3, 4, "float32")
    table[1, :] = 7  # one page, four slots
    table[2, 3] = table[0, 0]
    want = np.asarray(jax_kv_gather_ref(jnp.asarray(pages), jnp.asarray(table)))
    p, t = _port(pages, table, "float32")
    np.testing.assert_array_equal(kv_gather(p, t).numpy(), want)
    np.testing.assert_array_equal(kv_gather(p, t.to(torch.int64)).numpy(), want)
    np.testing.assert_array_equal(kv_gather_ref(p, t).numpy()[1].reshape(4, 8, 32),
                                  np.broadcast_to(pages[7], (4, 8, 32)))


@pytest.mark.parametrize("bad", [-1, 10, 2**31 - 1])
def test_out_of_range_ids_raise(bad):
    rng = np.random.default_rng(4)
    pages, table = _inputs(rng, 10, 8, 32, 3, 4, "float32")
    table[2, 1] = bad
    with pytest.raises(ValueError, match="page ids"):
        kv_gather(*_port(pages, table, "float32"))


def test_malformed_tables_raise():
    pages = torch.zeros((4, 2, 8))
    with pytest.raises(ValueError, match="int32 or int64"):
        kv_gather(pages, torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="max_pages"):
        kv_gather(pages, torch.zeros((4,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kv_gather_cuda(pages, torch.zeros((2, 2), dtype=torch.int32))
