"""Public paged KV gather, dispatched on the device: a CPU tensor runs the
plain version (``ref``), a CUDA tensor the kernel
(``kv_gather.kv_gather_cuda``) or raises. The counterpart of the JAX
package's ``repro.kernels.kv_gather.kv_gather``."""
from __future__ import annotations

from repro_torch.kernels.kv_gather.kv_gather import check_table, kv_gather_cuda
from repro_torch.kernels.kv_gather.ref import kv_gather_ref


def kv_gather(pages, table):
    """pages: [n_pages, page, KVD]; table: [B, max_pages] int32 or int64
    page ids -> [B, max_pages * page, KVD]. Ids outside ``[0, n_pages)``
    raise ``ValueError`` on every device (one host sync on the card)."""
    if pages.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no KV gather kernel for device {pages.device}")
    if pages.dim() != 3:
        raise ValueError(f"pages must be [n_pages, page, KVD], got {tuple(pages.shape)}")
    check_table(table, pages.shape[0])
    if pages.device.type == "cpu":
        return kv_gather_ref(pages, table)
    return kv_gather_cuda(pages, table)
