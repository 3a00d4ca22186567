"""Model assembly for the dense decoder: embed, the layer stack, the head.

Counterpart of ``repro.models.lm`` for the ``dense`` family.  Params are
the stacked tree of ``repro_torch.weights`` (leading layer axis per
segment slot), already cast to the compute dtype; the JAX package's
``lax.scan`` over the stack is a Python loop indexing ``[l]``.

Caches keep the JAX tree structure, ``[{"slot0": {"attn": {"k", "v"}}}]``
per segment: a prefill returns the dense ``(L, B, max_len, Hkv, hd)``
leaves; a decode step takes either the paged store's ``(L, num_blocks,
bs, Hkv, hd)`` pools (with block tables) or dense ``(L, N, S, Hkv, hd)``
leaves, and writes them in place.

Under tensor parallelism the tree is one rank's slice
(``weights.shard_params``) and ``cfg`` the rank's view
(``sharding.local_config``: its heads and MLP width, and ``cfg.shard``
the rank's ``parallel.sharding.Split`` with its group): the embedding
lookup is vocabulary-sharded (each rank gathers the ids in its range,
zeros elsewhere, then an all-reduce -- exact, one rank alone is non-zero
per token), an all-reduce follows each layer's ``wo`` and ``w_out``,
``lm_head_weight`` is the rank's (D, V / ranks) slice and ``logits_fn``
all-gathers the slices' f32 logits.
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


def _trunk_group(cfg: ModelConfig):
    """The group a split trunk all-reduces over, or None."""
    sh = cfg.shard
    return sh.group if sh is not None and sh.trunk else None


def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    group = _trunk_group(cfg)
    if group is None:
        return params["embed"][tokens]
    # vocabulary-sharded lookup: this rank's rows for the ids in its
    # range, exact zeros elsewhere; the sum over ranks adds zeros only
    lo, hi = cfg.shard.vocab
    local = tokens - lo
    mine = (local >= 0) & (local < hi - lo)
    x = params["embed"][local.clamp(0, hi - lo - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return group.all_reduce_sum(x, "embed")


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) head weight.  Tied: the ``.T`` VIEW of the (V, D)
    embedding -- nothing is copied (a materialised transpose would be a
    311 MB copy per step at qwen3-0.6b's width).  Untied: ``lm_head``,
    which ``weights.cast_params`` stores as the same kind of view.  On a
    rank of a sharded head, the rank's (D, V / ranks) slice: the
    embedding's rows when the trunk is split, else a view of the whole
    embedding's rows [lo, hi) -- contiguous rows, so still the ``.T``
    view of a contiguous (V / ranks, D) tensor the head kernels read."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    sh = cfg.shard
    if sh is not None and not sh.trunk:
        w = w.t()[sh.vocab[0]:sh.vocab[1]].t()
    return w


def final_hidden(params: dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(params: dict, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits ``x @ W``, as the JAX package's
    ``jnp.dot(x, W, preferred_element_type=jnp.float32)``.  On the card
    one GEMM reads the bf16 W in place and writes f32
    (``aten::mm.dtype``), with no f32 copy of W (622 MB at qwen3-0.6b's
    width); on the CPU, where that overload has no kernel, ``x.float() @
    W.float()``."""
    w = lm_head_weight(params, cfg)
    h = x.reshape(-1, x.shape[-1])
    if h.device.type == "cpu":
        out = torch.matmul(h.float(), w.float())
    else:
        out = torch.mm(h, w, out_dtype=torch.float32)
    sh = cfg.shard
    if sh is not None:
        # every rank's (rows, V / ranks) slice, in rank order: the O(rows
        # * V) traffic the comparator heads never pay
        g = sh.group.all_gather(out, "logits")
        out = g.permute(1, 0, 2).reshape(out.shape[0], -1)
    return out.reshape(*x.shape[:-1], out.shape[-1])


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
                 cache=None, group=None):
    """One decoder layer; with ``group`` (a split trunk) the row-parallel
    outputs of ``wo`` and ``w_out`` are summed over the ranks."""
    a, extra = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                         cfg, consts=consts, causal=True,
                         window=cfg.attention_window, cache=cache)
    if group is not None:
        a = group.all_reduce_sum(a, "trunk")
    x = x + a
    h = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
    if group is not None:
        h = group.all_reduce_sum(h, "trunk")
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


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    """The eval forward over ``tokens`` (B, S): returns (f32 logits (B,
    S, V), aux loss 0.0; the dense family has no router loss).  The
    reference's train-mode attention is masked softmax over all S
    positions; this is the same function through the cache-less branch
    (``ops.flash_attention``, causal, the architecture window)."""
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    consts = step_constants(cfg, torch.arange(S, device=tokens.device))
    group = _trunk_group(cfg)
    for seg_layers in layer_params(params, cfg):
        for slots in seg_layers:
            for p in slots:
                x, _ = _apply_layer(p, x, cfg, consts=consts, group=group)
    return logits_fn(params, cfg, final_hidden(params, cfg, x)), 0.0


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Process the prompt (B, S): returns (last hidden (B, D), cache) with
    the cache's K/V zero-padded to ``max_len`` positions."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    consts = step_constants(cfg, torch.arange(S, device=tokens.device))
    caches = init_cache(cfg, B, max_len, tokens.device)
    group = _trunk_group(cfg)
    for seg_layers, seg_cache in zip(layer_params(params, cfg), caches):
        for l, slots in enumerate(seg_layers):
            for j, p in enumerate(slots):
                x, (k, v) = _apply_layer(p, x, cfg, consts=consts,
                                         group=group)
                leaf = seg_cache[f"slot{j}"]["attn"]
                leaf["k"][l, :, :S] = k
                leaf["v"][l, :, :S] = v
    h = final_hidden(params, cfg, x[:, -1:, :])[:, 0, :]
    return h, caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: list, pos: torch.Tensor, *,
                block_tables: Optional[torch.Tensor] = None,
                cache_rows: Optional[torch.Tensor] = None,
                layers: Optional[list] = None):
    """One decode step, the caches written in place.

    token (B, T) int; pos a scalar (every row at one position), (B,) --
    each row at its own position, RAGGED decode, a window of T
    consecutive queries from it -- or (B, T) per-(row, query) positions.
    With ``block_tables`` (B, nb) the caches hold the paged store's
    pools; without, dense ``(L, N, S, Hkv, hd)`` leaves, batch row b in
    cache row ``cache_rows[b]`` (default b).  ``layers`` is
    ``layer_params(params, cfg)`` where the caller keeps it.  The RoPE
    table and the cache indices are computed once for all layers
    (``layers.step_constants``).  Returns (h, caches): h is (B, D) for
    T == 1 and (B, T, D) otherwise."""
    T = token.shape[1]
    if pos.dim() == 2:
        positions = pos                                   # (B, T)
    elif pos.dim() == 1:
        positions = pos[:, None] + torch.arange(T, device=pos.device)
    elif pos.dim() == 0:
        positions = pos + torch.arange(T, device=pos.device)   # (T,)
    else:
        raise ValueError(f"pos must be a scalar, (B,) or (B, T); got "
                         f"{tuple(pos.shape)}")
    if layers is None:
        layers = layer_params(params, cfg)
    leaf = caches[0]["slot0"]["attn"]["k"]
    if block_tables is not None:
        consts = step_constants(cfg, positions, cache_pos=pos,
                                block_tables=block_tables,
                                block_size=leaf.shape[2])
    else:
        consts = step_constants(cfg, positions, cache_pos=pos,
                                cache_len=leaf.shape[2], rows=cache_rows,
                                window=cfg.attention_window)
    x = embed_tokens(params, cfg, token)
    group = _trunk_group(cfg)
    for seg_layers, seg_cache in zip(layers, caches):
        for l, slots in enumerate(seg_layers):
            for j, p in enumerate(slots):
                kv = seg_cache[f"slot{j}"]["attn"]
                x, _ = _apply_layer(p, x, cfg, consts=consts, cache={
                    "k": kv["k"][l], "v": kv["v"][l]}, group=group)
    if T == 1:
        return final_hidden(params, cfg, x[:, 0, :]), caches
    return final_hidden(params, cfg, x), caches
