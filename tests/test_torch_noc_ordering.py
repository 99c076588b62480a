"""Paper Fig. 10 through the port: ``tests/test_noc_ordering.py``
mirrored. Each configuration runs in both packages; the port's SimState
equals JAX's leaf for leaf, every stats entry is equal, and the JAX
test's claim holds on the port's stats.

Horizons: the JAX tests run 4000 cycles. Tile 0's 16 transfers are done
by cycle 688 (RoB-less, one stream, alternating), 277 (two streams), 277
(RoB) and 333 (RoB-less, one destination) in the JAX simulator; the
mirrors stop 10% or more later and assert all 16 done, so the completion
times and stall counts they read are those of the JAX horizon.
"""
import functools

import torch

from torch_mirror import build_both, run_both

torch.set_num_threads(1)

HORIZONS = {  # (order, streams, alternate, unique_txn) -> cycles
    ("robless", 1, True, False): 760,
    ("robless", 2, False, True): 310,
    ("rob", 1, True, False): 310,
    ("robless", 1, False, False): 370,
}


@functools.lru_cache(maxsize=None)
def _run(order: str, streams: int, alternate: bool, unique_txn: bool):
    def make(pkg):
        topo = pkg.top.build_mesh(nx=4, ny=4)
        return topo, pkg.T.ordering_workload(
            topo, streams=streams, alternate=alternate, unique_txn=unique_txn,
            n_txns=16, transfer_kb=1)
    cycles = HORIZONS[order, streams, alternate, unique_txn]
    _, _, out = run_both(build_both(make, ni_order=order), cycles,
                         tag=f"{order}/{streams}")
    done = out["dma_done"][0].sum()
    assert done == 16  # complete: the JAX horizon reads the same numbers
    return out, done, out["last_rx"][0]


def test_robless_single_stream_stalls():
    """Same TxnID, alternating destinations: outstanding txns to a different
    dst must stall injection -> serialization."""
    out, done, t = _run("robless", 1, True, False)
    assert done == 16
    assert out["ni_stalls"][0] > 50, "expected ordering stalls"


def test_multistream_removes_stalls():
    """Two backends with unique TxnIDs: same total traffic, no inter-stream
    ordering -> much faster completion (the paper's key claim)."""
    out1, done1, t1 = _run("robless", 1, True, False)
    out2, done2, t2 = _run("robless", 2, False, True)
    assert done1 == done2 == 16
    assert out2["ni_stalls"][0] == 0
    assert t2 < t1 * 0.6, f"multi-stream should be much faster: {t2} vs {t1}"


def test_rob_ni_matches_multistream_performance():
    """The RoB NI tolerates out-of-order responses up to its credit
    capacity; RoB-less + multi-stream is at least as fast."""
    _, _, t_rob = _run("rob", 1, True, False)
    _, _, t_ms = _run("robless", 2, False, True)
    assert t_ms <= t_rob * 1.1


def test_same_destination_never_stalls():
    """RoB-less with a single destination: static routing keeps responses
    in order, so no stalls even with one TxnID."""
    out, done, _ = _run("robless", 1, False, False)
    assert done == 16
    assert out["ni_stalls"][0] == 0
