"""Plain PyTorch paged KV gather: the CPU path and the CUDA kernel's
yardstick. The same function as the JAX package's ``kv_gather_ref`` and
Pallas kernel (``repro/kernels/kv_gather/``) for page ids in range."""
from __future__ import annotations


def kv_gather_ref(pages, table):
    """pages: [n_pages, page, KVD]; table: [B, max_pages] page ids ->
    [B, max_pages * page, KVD], ``out[b, p*page:(p+1)*page] =
    pages[table[b, p]]``."""
    B, mp = table.shape
    _, page, KVD = pages.shape
    return pages.index_select(0, table.reshape(-1)).reshape(B, mp * page, KVD)
