"""Gradient compression with error feedback (``repro.optim.compression``):
int8 block quantization, each block of ``block`` values scaled by its
absmax, the quantization residual carried to the next step.

    q, scale, new_err = compress(grad + err)
    g_sync = all_reduce_sum(decompress(q, scale)) / world

No training loop of the port calls it yet (nor does the JAX package's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_mod


def compress(x: torch.Tensor, block: int = 256):
    """-> (int8 values (nblocks, block), f32 scales (nblocks, 1), residual
    in x's shape and dtype); x flattened and zero-padded to whole
    blocks."""
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    err = (blocks - deq).reshape(-1)[:flat.numel()].reshape(x.shape)
    return q, scale, err.to(x.dtype)


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compressed_psum(grads, group, err_state=None, block: int = 256):
    """Error-feedback compressed gradient mean over ``group`` (a
    ``parallel.comm.Group``): each leaf ``g`` with its error ``e`` is
    compressed, decompressed, summed over the ranks and divided by the
    world.  Returns (synced grads, new error state), trees of ``grads``'
    structure."""
    if err_state is None:
        err_state = tree_mod.map_tree(lambda _, g: torch.zeros_like(g), grads)
    synced, errs = [], []
    for path, g in tree_mod.items(grads):
        e = tree_mod.get(err_state, path)
        q, s, err = compress(g + e.to(g.dtype), block)
        deq = decompress(q, s, g.shape).float()
        deq = group.all_reduce_sum(deq, "grad") / group.world
        synced.append(deq.to(g.dtype))
        errs.append(err)
    return (tree_mod.unflatten(grads, synced),
            tree_mod.unflatten(grads, errs))
