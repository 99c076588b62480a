"""Runtime knobs threaded through the port's training and serving code.

The counterpart of ``repro.runtime.Runtime`` on one device. The JAX
package's ``Runtime`` carries a mesh and the knobs that place work on it;
the port has no mesh yet, so it keeps the fields that mean something on
one device:

* ``remat`` (default True, as in JAX): training recomputes each layer's
  activations in the backward pass (``models.model.forward``);
* ``cache_quant``: the int8 KV cache, carried as JAX carries it. Nothing in
  ``models/`` or ``serve/`` reads it (in the JAX package only ``launch/``
  does): the int8 path runs whenever a cache built by
  ``models.model.init_cache(..., quant=True)`` reaches ``decode_step``.

``attn_impl``, ``block_q`` / ``block_k`` and ``moe_capacity_factor`` choose
the JAX package's TPU attention tiling and MoE default; the port's flash
kernel tiles itself and ``models.moe.moe_block`` takes the capacity factor
from the config, so they are not here. The mesh fields (``seq_shard_cache``,
``manual``, ``batch_over_model``, ``moe_impl="a2a"``, ``gather_weights``)
are refused when set, naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# the JAX Runtime's mesh fields and the value each takes on one device
MESH_FIELDS = {"seq_shard_cache": False, "manual": False, "batch_over_model": False,
               "moe_impl": "gather", "gather_weights": False}


@dataclass(frozen=True)
class Runtime:
    """One device's runtime: ``remat`` and ``cache_quant``; the mesh fields
    only at their single-device values."""

    remat: bool = True
    cache_quant: bool = False
    seq_shard_cache: bool = False
    manual: bool = False
    batch_over_model: bool = False
    moe_impl: str = "gather"
    gather_weights: bool = False

    def __post_init__(self):
        for name, default in MESH_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"Runtime.{name}={getattr(self, name)!r} needs a device mesh, which "
                    "the port does not have yet (ROADMAP Queue 1 item 12 step 7b)")

    def with_(self, **kw) -> "Runtime":
        """A copy with ``kw`` replaced."""
        return dataclasses.replace(self, **kw)


def default_runtime() -> Runtime:
    """The single-device runtime: remat on, no cache quantisation."""
    return Runtime()
