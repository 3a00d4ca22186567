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

In training the layer is the Megatron pair around the rank's share: its
input goes through ``comm.copy_to_group`` and the sum through
``comm.reduce_from_group``.  The router's gradient then has two parts on
a rank: the combine weights' (its own experts' kept choices only) and the
router loss's, which every rank computes whole.  The router loss goes
through ``comm.share_grad``, the reference's ``pmean`` over ``model``
(``repro/parallel/moe_ep.py:114-116``): each rank carries 1 / M of its
gradient, so the model group's sum of the router's gradient (and of the
layer input's, at ``copy_to_group``) counts it once.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import moe_layer
from repro_torch.parallel import comm


def moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str,
           group_size: int = 4096, data=None):
    """The rank's share of the layer (``layers.moe_layer`` over
    ``cfg.shard.experts``; ``impl`` ``scatter`` or ``gshard``, as
    ``lm.moe_impl`` picks), summed over ``cfg.shard.group``.  Returns (y,
    aux): every rank's y is the whole layer's, and its aux the one every
    rank computed from the same routing (``data``: a training rank's data
    group, ``layers.moe_aux_loss``)."""
    sh = cfg.shard
    y, aux = moe_layer(p, comm.copy_to_group(x, sh.group, "trunk"), cfg,
                       impl=impl, group_size=group_size, experts=sh.experts,
                       data=data)
    return (comm.reduce_from_group(y, sh.group, "trunk"),
            comm.share_grad(aux, sh.group))
