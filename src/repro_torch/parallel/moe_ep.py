"""Expert parallelism: a ``moe`` layer over one rank's experts, then one
all-reduce.

Counterpart of ``repro.parallel.moe_ep`` for serving under ``tp`` (one
process a rank, ``parallel.comm.Group``).  The activations entering the
layer are the same on every rank (the attention before it ends in an
all-reduce), and the router is replicated, so every rank routes every
token over all E experts with the global capacity ``ceil(cf * N * k /
E)`` -- the same choices, ranks and drops on every rank.  A rank then
computes only the kept slots of its own experts (``sharding.Split``'s
``experts``, the contiguous range its expert stacks hold) and its columns
of the shared expert, and one ``all_reduce_sum`` adds the ranks' shares:
the bytes of the dense MLP's all-reduce.  The reference's local capacity
``ceil(cf * n_loc * k / E)`` is this global one on a mesh with no data
axis, which is also what its GSPMD scatter and GShard executors compute
under a (1, tp) mesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import moe_layer


def moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str,
           group_size: int = 4096):
    """The rank's share of the layer (``layers.moe_layer`` over
    ``cfg.shard.experts``; ``impl`` ``scatter`` or ``gshard``, as
    ``lm.moe_impl`` picks), summed over ``cfg.shard.group``.  Returns (y,
    aux): every rank's y is the whole layer's, and its aux the one every
    rank computed from the same routing."""
    sh = cfg.shard
    y, aux = moe_layer(p, x, cfg, impl=impl, group_size=group_size,
                       experts=sh.experts)
    return sh.group.all_reduce_sum(y, "trunk"), aux
