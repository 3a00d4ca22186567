"""Model assembly for the dense decoder: embed, the layer stack, the head.

Counterpart of ``repro.models.lm`` for the ``dense`` family.  Params are
the stacked tree of ``repro_torch.weights`` (leading layer axis per
segment slot), already cast to the compute dtype; the JAX package's
``lax.scan`` over the stack is a Python loop indexing ``[l]``.

Caches keep the JAX tree structure, ``[{"slot0": {"attn": {"k", "v"}}}]``
per segment: a prefill returns the dense ``(L, B, max_len, Hkv, hd)``
leaves, a decode step takes the paged store's ``(L, num_blocks, bs,
Hkv, hd)`` pools and writes them in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (attention, mlp, rms_norm,
                                      step_constants)
from repro_torch.weights import dtype_of


def segments(cfg: ModelConfig):
    """Decoder block program: list of (unit, count)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family only")
    return [(("attn",), cfg.n_layers)]


def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) head weight.  Tied: the ``.T`` VIEW of the (V, D)
    embedding -- nothing is copied (a materialised transpose would be a
    311 MB copy per step at qwen3-0.6b's width).  Untied: ``lm_head``,
    which ``weights.cast_params`` stores as the same kind of view."""
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["lm_head"]


def final_hidden(params: dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _layer(sp: dict, l: int) -> dict:
    """Layer ``l``'s params out of a stacked slot tree (views)."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in sp.items()}


def layer_params(params: dict, cfg: ModelConfig) -> list:
    """Every layer's param views, ``[segment][layer][slot]``: built once
    by a caller that runs many passes over one param tree (the serving
    engine), so a pass indexes no stacked leaf."""
    return [[[_layer(seg[f"slot{j}"], l) for j in range(len(unit))]
             for l in range(count)]
            for seg, (unit, count) in zip(params["decoder"], segments(cfg))]


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, *, consts,
                 cache=None):
    a, extra = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                         cfg, consts=consts, causal=True,
                         window=cfg.attention_window, cache=cache)
    x = x + a
    h = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
    return x + h, extra


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device) -> list:
    """Fresh dense cache tree: per segment ``{"slot0": {"attn": {"k",
    "v"}}}`` with ``(L, B, max_len, Hkv, hd)`` leaves."""
    dt = dtype_of(cfg)
    caches = []
    for unit, count in segments(cfg):
        shape = (count, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        caches.append({f"slot{j}": {"attn": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}}
            for j in range(len(unit))})
    return caches


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Process the prompt (B, S): returns (last hidden (B, D), cache) with
    the cache's K/V zero-padded to ``max_len`` positions."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    consts = step_constants(cfg, torch.arange(S, device=tokens.device))
    caches = init_cache(cfg, B, max_len, tokens.device)
    for seg_layers, seg_cache in zip(layer_params(params, cfg), caches):
        for l, slots in enumerate(seg_layers):
            for j, p in enumerate(slots):
                x, (k, v) = _apply_layer(p, x, cfg, consts=consts)
                leaf = seg_cache[f"slot{j}"]["attn"]
                leaf["k"][l, :, :S] = k
                leaf["v"][l, :, :S] = v
    h = final_hidden(params, cfg, x[:, -1:, :])[:, 0, :]
    return h, caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: list, pos: torch.Tensor, *,
                block_tables: Optional[torch.Tensor] = None,
                layers: Optional[list] = None):
    """One decode step over the paged pools.

    token (B, T) int; pos (B,) -- each row at its own position, RAGGED
    decode -- or (B, T) per-(row, query) positions; ``caches`` holds the
    store's pools, written in place; ``layers`` is ``layer_params(params,
    cfg)`` where the caller keeps it.  The RoPE table and the paged
    branch's indices are computed once for all layers
    (``layers.step_constants``).  Returns (h, caches): h is (B, D) for
    T == 1 and (B, T, D) otherwise."""
    if block_tables is None:
        raise NotImplementedError(
            "decode_step runs the paged layout only: pass block_tables")
    T = token.shape[1]
    if pos.dim() == 2:
        positions = pos                                   # (B, T)
    elif pos.dim() == 1:
        positions = pos[:, None] + torch.arange(T, device=pos.device)
    else:
        raise ValueError(f"pos must be (B,) or (B, T); got {tuple(pos.shape)}")
    if layers is None:
        layers = layer_params(params, cfg)
    consts = step_constants(
        cfg, positions, cache_pos=pos, block_tables=block_tables,
        block_size=caches[0]["slot0"]["attn"]["k"].shape[2])
    x = embed_tokens(params, cfg, token)
    for seg_layers, seg_cache in zip(layers, caches):
        for l, slots in enumerate(seg_layers):
            for j, p in enumerate(slots):
                pools = seg_cache[f"slot{j}"]["attn"]
                x, _ = _apply_layer(p, x, cfg, consts=consts, cache={
                    "k": pools["k"][l], "v": pools["v"][l]})
    if T == 1:
        return final_hidden(params, cfg, x[:, 0, :]), caches
    return final_hidden(params, cfg, x), caches
