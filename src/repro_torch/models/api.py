"""Serving steps over the model: one-shot paged prefill and the decode
step, each ending in a sampler head.

Counterpart of the serving half of ``repro.models.api``.  ``sampler`` is
a ``repro_torch.serve.sampler.Sampler`` (its ``head`` turns the final
hidden state into what the host needs).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def serve_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: list, pos: torch.Tensor, sampler, *,
                 block_tables: Optional[torch.Tensor] = None):
    """One token step: returns (head output, cache).  ``pos`` is (B,) --
    every row at its own position -- or (B, T) for a (B, T) window, whose
    head then reads position 0.  The pools in ``cache`` are written in
    place.

    The step with one head, as ``repro.models.api.serve_decode`` has it,
    for callers outside the engine; ``ServeEngine._decode_rows`` runs
    ``lm.decode_step`` once and then one head per sampler group."""
    h, cache = lm.decode_step(params, cfg, token, cache, pos,
                              block_tables=block_tables)
    if h.dim() == 3:
        h = h[:, 0]
    return sampler.head(params, cfg, h), cache


def serve_prefill_paged(params: dict, cfg: ModelConfig,
                        tokens: torch.Tensor, cache_len: int, sampler, *,
                        pools: dict, blocks: torch.Tensor):
    """One-shot paged prompt pass (B = 1): prefill at the block-aligned
    ``cache_len`` and write its K/V straight into the slot's pool
    ``blocks`` ((nb,) int) of ``pools`` ({"k", "v"}: (L, num_blocks, bs,
    Hkv, hd)), in place.  Positions of the last block past the prompt
    receive the prefill's zero padding, as in the JAX package; decode
    overwrites them before any query can see them.  Returns the head
    output."""
    h, cache = lm.prefill(params, cfg, tokens, cache_len)
    leaf = cache[0]["slot0"]["attn"]
    nb = blocks.shape[0]
    for name in ("k", "v"):
        pool = pools[name]
        bs = pool.shape[2]
        view = leaf[name][:, 0, :nb * bs]              # (L, nb*bs, Hkv, hd)
        pool[:, blocks] = view.reshape(view.shape[0], nb, bs,
                                       *view.shape[2:]).to(pool.dtype)
    return sampler.head(params, cfg, h)
