"""Model assembly: embed, the block program's layers, the head.

Counterpart of ``repro.models.lm`` for all six families: ``dense`` and
``vlm`` (whose stub frontend's image embeddings take the first positions,
``embed_tokens``), ``moe``, ``hybrid``, ``ssm`` and ``encdec``.  A config
lowers to a block program (``segments``): a list of ``(unit, count)``,
the unit a tuple of layer kinds -- ``attn`` (self-attention + MLP),
``moe`` (self-attention + the routed experts, ``layers.moe_layer``),
``rec`` (the RG-LRU block + MLP, ``models.rglru``), ``rwkv`` (the RWKV6
time-mix + channel-mix layer, ``models.rwkv6``) or ``xattn`` (causal
self-attention, cross-attention over the encoder's output, MLP) --
repeated ``count`` times.  An ``encdec`` config's encoder is the block
program ``encoder_segments``: ``enc`` layers, bidirectional
self-attention + MLP over the stub frontend's source embeddings, at
their own positions (``encode``).  Params are the stacked
tree of ``repro_torch.weights`` (one dict per segment, each slot's
leaves with a leading axis of ``count``), already cast to the compute
dtype; the JAX package's ``lax.scan`` over a segment is a Python loop
indexing ``[l]``.

Caches keep the JAX tree structure, per segment ``{"slot{j}": {"attn":
{"k", "v"}}, {"rec": {"conv", "h"}} or {"shift1", "shift2", "wkv"}}``
(an ``rwkv`` slot's cache is its state itself; an ``xattn`` slot's holds
``"xk"`` / ``"xv"`` beside ``"attn"``, the read-only cross K/V ``(count,
B, S_src, Hkv, hd)`` a prefill computes once): a prefill returns dense
leaves -- K/V ``(count, B, S, Hkv, hd)`` with S = ``max_len``, or
``min(max_len, window)`` for an architecture window (the ring buffer,
position p at row p % window), the RG-LRU state ``(count, B, w - 1,
lru)`` / ``(count, B, lru)`` f32, the RWKV6 shifts ``(count, B, D)`` and
``wkv`` ``(count, B, H, hd, hd)`` f32; a decode step takes either the
paged store's pools (with block tables; ``pool_tree``: each
attention-bearing slot's ``(count, num_blocks, bs, Hkv, hd)`` view) or
dense leaves with N cache rows, and writes them in place.

Under tensor parallelism the tree is one rank's slice
(``weights.shard_params``) and ``cfg`` the rank's view
(``sharding.local_config``: its heads and MLP width, and ``cfg.shard``
the rank's ``parallel.sharding.Split`` with its group): the embedding
lookup is vocabulary-sharded (each rank gathers the ids in its range,
zeros elsewhere, then an all-reduce -- exact, one rank alone is non-zero
per token; a vlm config's image embeddings then take the first
positions on every rank), an all-reduce follows each layer's ``wo`` and
``w_out`` (a ``moe`` layer's: its experts' share of the routed sum plus
its part of the shared expert; a ``rec`` layer's RG-LRU block and MLP;
an ``rwkv`` layer's time-mix, whose channel-mix sums and gathers its
own, ``rwkv6.rwkv_channel_mix``), the recurrent states hold the rank's
channels (``rglru`` / ``rwkv6``), ``lm_head_weight`` is the rank's (D, V
/ ranks) slice and ``logits_fn`` all-gathers the slices' f32 logits.

Training under a split (every family) differentiates through the
collectives with the Megatron pair: the embedding's sum and each ``wo``
/ ``w_out`` output go through ``comm.reduce_from_group``, the normed
inputs of wq / wk / wv and of the MLP's first matrices, and the head's
input, through ``comm.copy_to_group``, whose backward sums their
gradient over the ranks; a ``moe`` layer's input and its experts' sum
are the same pair (``parallel.moe_ep``), the recurrent blocks carry
their own (``rglru``, ``rwkv6``); the loss reads the rank's logits
slice alone (``local_logits``).  An encoder's layers take the pair as a
dense layer does, each ``xattn`` layer's cross-attention too, and the
encoder's output, which every ``xattn`` layer's kv heads read, is copied
once (kind ``"cross"``).  A vocabulary kept whole on every rank
(``sharding.vocab_cut`` false: one that does not divide by the ranks)
takes the plain lookup, head and loss, with neither the embedding's sum
nor the head's copy.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6
from repro_torch.models.layers import (StepConstants, _split_heads,
                                      attention, mlp, moe_layer, rms_norm,
                                      step_constants)
from repro_torch.parallel import comm, moe_ep, sharding
from repro_torch.weights import dtype_of, head_layout


def segments(cfg: ModelConfig):
    """Decoder block program: list of (unit, count).  The hybrid pattern
    splits into whole units plus a remainder unit, as the reference's
    (``repro/models/lm.py:50-70``)."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [(("attn",), L)]
    if cfg.family == "moe":
        # every ``interleave_step``-th layer routes; the others are dense
        s = cfg.moe.interleave_step
        if s == 1:
            return [(("moe",), L)]
        return [(tuple("moe" if i % s == s - 1 else "attn"
                       for i in range(s)), L // s)]
    if cfg.family == "ssm":
        return [(("rwkv",), L)]
    if cfg.family == "hybrid":
        pat = tuple(cfg.hybrid_pattern)
        full, rem = divmod(L, len(pat))
        segs = [(pat, full)]
        if rem:
            segs.append((pat[:rem], 1))
        return segs
    if cfg.family == "encdec":
        return [(("xattn",), L)]
    raise ValueError(f"family {cfg.family!r}")


def encoder_segments(cfg: ModelConfig):
    """The encoder's block program: ``n_encoder_layers`` ``enc`` layers,
    or none."""
    return [(("enc",), cfg.n_encoder_layers)] if cfg.n_encoder_layers else []


def layer_types(cfg: ModelConfig) -> list:
    """Every layer's kind, in order."""
    out = []
    for unit, count in segments(cfg):
        out += list(unit) * count
    return out


def trunk_group(cfg: ModelConfig):
    """The group a split trunk all-reduces over, or None."""
    sh = cfg.shard
    return sh.group if sh is not None and sh.trunk else None


def moe_impl(cfg: ModelConfig, decode: bool) -> str:
    """The MoE executor (reference ``_moe_impl``): the config's, unless
    it is ``auto`` -- then ``scatter`` in a decode step and ``gshard`` in
    a prefill or ``forward``."""
    if cfg.moe_impl != "auto":
        return cfg.moe_impl
    return "scatter" if decode else "gshard"


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings (B, T, D); under a config with
    ``num_image_tokens``, given ``image_embeds`` (B, n, D) -- the stub
    vision frontend's patch embeddings -- take the first n positions, cast
    to the compute dtype (reference ``embed_tokens``).  Under a split
    trunk with a cut vocabulary the token embeddings are summed over the
    ranks first; every rank holds the same ``image_embeds`` and puts them
    in after the sum (summed, they would count ``world`` times).  A
    vocabulary kept whole on every rank (``sharding.vocab_cut`` false)
    is looked up as it is, with no sum: summed, the rows would count
    ``world`` times too."""
    group = trunk_group(cfg)
    embed = params["embed"]
    if group is None or not sharding.vocab_cut(cfg):
        x = embed[tokens]
    else:
        # vocabulary-sharded lookup: this rank's rows for the ids in its
        # range, exact zeros elsewhere; the sum over ranks adds zeros only
        lo, hi = cfg.shard.vocab
        local = tokens - lo
        mine = (local >= 0) & (local < hi - lo)
        x = embed[local.clamp(0, hi - lo - 1)]
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        x = comm.reduce_from_group(x, group, "embed")
    if cfg.num_image_tokens and image_embeds is not None:
        n = image_embeds.shape[1]
        x = torch.cat([image_embeds.to(x.dtype), x[:, n:]], dim=1)
    return x


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) head weight.  Tied: the ``.T`` VIEW of the (V, D)
    embedding -- nothing is copied (a materialised transpose would be a
    311 MB copy per step at qwen3-0.6b's width).  Untied: ``lm_head``,
    which ``weights.cast_params`` stores as the same kind of view.  On a
    rank of a sharded head, the rank's (D, V / ranks) slice: the
    embedding's rows when the trunk is split, else a view of the whole
    embedding's rows [lo, hi) -- contiguous rows, so still the ``.T``
    view of a contiguous (V / ranks, D) tensor the head kernels read.
    A data-cut untied head (FSDP, ``comm.Shard``) is gathered here,
    where the step reads it, into the same layout; a tied one is the
    embedding ``api.train_loss`` gathered."""
    if cfg.tie_embeddings:
        w = params["embed"].t()
    elif isinstance(params["lm_head"], comm.Shard):
        w = head_layout(("lm_head",), params["lm_head"].whole())
    else:
        w = params["lm_head"]
    sh = cfg.shard
    if sh is not None and not sh.trunk:
        w = w.t()[sh.vocab[0]:sh.vocab[1]].t()
    return w


def final_hidden(params: dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


class _HeadMatmul(torch.autograd.Function):
    """``h @ W`` with an f32 result, as the JAX package's ``jnp.dot(h, W,
    preferred_element_type=jnp.float32)``, with the derivative that
    PyTorch's ``mm.dtype`` overload lacks.  On the card the forward is
    one GEMM that reads the bf16 W in place and writes f32 (no f32 copy
    of W: 622 MB at qwen3-0.6b's width); on the CPU, where that overload
    has no kernel, ``h.float() @ W.float()``.  The backward keeps the f32
    output gradient in f32, as the reference's transpose does (a
    ``dot_general`` of the f32 cotangent with the bf16 operand, f32
    result): each operand's gradient is an f32 GEMM against the other
    operand in f32, cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.device.type == "cpu":
            return torch.mm(h.float(), w.float())
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = torch.mm(g, w.float().t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(h.float().t(), g).to(w.dtype)
        return dh, dw


def local_logits(params: dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (rows, V / ranks) f32: a split trunk's rank's slice of
    the logits, never gathered (the vocabulary-parallel loss reads it,
    ``models.api.vocab_parallel_xent``).  The head's input goes through
    ``comm.copy_to_group`` (kind ``"head"``): the rank's vocabulary
    columns give a part of its gradient.  Only for a cut vocabulary: a
    whole one's head is ``logits_fn``'s, whose input gradient is already
    whole on every rank (behind the copy it would count ``world``
    times)."""
    x = comm.copy_to_group(x.reshape(-1, x.shape[-1]), trunk_group(cfg),
                           "head")
    return _HeadMatmul.apply(x, lm_head_weight(params, cfg))


def logits_fn(params: dict, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits ``x @ W`` (``_HeadMatmul``); a
    rank's vocabulary slices all-gathered where the vocabulary is cut."""
    w = lm_head_weight(params, cfg)
    out = _HeadMatmul.apply(x.reshape(-1, x.shape[-1]), w)
    sh = cfg.shard
    if sh is not None and sharding.vocab_cut(cfg):
        # every rank's (rows, V / ranks) slice, in rank order: the O(rows
        # * V) traffic the comparator heads never pay
        g = sh.group.all_gather(out, "logits")
        out = g.permute(1, 0, 2).reshape(out.shape[0], -1)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _layer(sp: dict, l: int) -> dict:
    """Layer ``l``'s params out of a stacked slot tree (views)."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in sp.items()}


def _stack_layers(stack: list, segs: list) -> list:
    return [[[_layer(seg[f"slot{j}"], l) for j in range(len(unit))]
             for l in range(count)]
            for seg, (unit, count) in zip(stack, segs)]


def layer_params(params: dict, cfg: ModelConfig,
                 stack: str = "decoder") -> list:
    """Every layer's param views, ``[segment][layer][slot]``, of the
    decoder's stack (or the encoder's, ``stack="encoder"``): built once
    by a caller that runs many passes over one param tree (the serving
    engine), so a pass indexes no stacked leaf."""
    segs = segments(cfg) if stack == "decoder" else encoder_segments(cfg)
    return _stack_layers(params[stack], segs)


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 consts, cache=None, group=None, cross=None, data=None):
    """One layer of ``kind``; with ``group`` (a split trunk) the
    row-parallel outputs of ``wo`` and ``w_out`` are summed over the
    ranks (a ``rec`` layer's RG-LRU block and MLP, an ``rwkv`` layer's
    time-mix and channel-mix too), and a ``moe`` layer runs its rank's
    experts (``parallel.moe_ep``).  Returns (x, extra, aux):
    an attention-bearing layer's self-attention ``attention`` extra, a
    ``rec`` or ``rwkv`` layer's new state; a ``moe`` layer's router loss
    (f32 scalar), else None.  An ``xattn`` layer's cross-attention is
    split as its self-attention is: its normed query input copied, the
    rank's heads, its output summed.  A ``moe`` layer routes with ``moe_impl``:
    the decode executor with a cache, the prefill one without.  An
    ``enc`` layer's self-attention is bidirectional with no window; an
    ``xattn`` layer's cross-attention reads ``cross``: the encoder's
    output (B, S_src, D) without a cache, the read-only ``{"k", "v"}``
    cross K/V in a decode step (reference ``_apply_layer``).  ``data``, a
    training rank's data group, reaches a ``moe`` layer's router loss."""
    if kind == "rwkv":
        return (*_recurrent(rwkv6.init_state, rwkv6.rwkv_block, p, x, cfg,
                            consts, cache, group), None)
    if kind == "rec":
        x, extra = _recurrent(rglru.init_state, rglru.rglru_block, p["rec"],
                              x, cfg, consts, cache, group)
        h = mlp(p["mlp"], comm.copy_to_group(
            rms_norm(x, p["ln2"], cfg.norm_eps), group, "trunk"),
            cfg.activation)
        return x + comm.reduce_from_group(h, group, "trunk"), extra, None
    enc = kind == "enc"
    a, extra = attention(p["attn"], comm.copy_to_group(
        rms_norm(x, p["ln1"], cfg.norm_eps), group, "trunk"),
                         cfg, consts=consts, causal=not enc,
                         window=None if enc else cfg.attention_window,
                         cache=cache)
    x = x + comm.reduce_from_group(a, group, "trunk")
    if kind == "xattn":
        h = comm.copy_to_group(rms_norm(x, p["lnx"], cfg.norm_eps), group,
                               "trunk")
        if isinstance(cross, dict):
            xa, _ = attention(p["xattn"], h, cfg, consts=None, cache=cross)
        else:
            xa, _ = attention(p["xattn"], h, cfg, consts=None, kv_x=cross,
                              causal=False)
        x = x + comm.reduce_from_group(xa, group, "trunk")
    h_in = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind != "moe":
        h = mlp(p["mlp"], comm.copy_to_group(h_in, group, "trunk"),
                cfg.activation)
        return x + comm.reduce_from_group(h, group, "trunk"), extra, None
    impl = moe_impl(cfg, cache is not None)
    if group is not None:
        h, aux = moe_ep.moe_ep(p["moe"], h_in, cfg, impl=impl,
                               group_size=cfg.moe_group_size, data=data)
    else:
        h, aux = moe_layer(p["moe"], h_in, cfg, impl=impl,
                           group_size=cfg.moe_group_size, data=data)
    return x + h, extra, aux


def _recurrent(init_state, block, p: dict, x: torch.Tensor,
               cfg: ModelConfig, consts, cache: Optional[dict], group=None):
    """A recurrent ``block`` (``rglru.rglru_block`` of a ``rec`` layer,
    ``rwkv6.rwkv_block`` of an ``rwkv`` layer; ``group`` a split trunk's
    ranks, which it sums over).  Without ``cache``
    (prefill, ``forward``) from a zero state (``init_state``); returns
    (x, the new state).  With ``cache`` -- the layer's state leaves over N
    cache rows -- a decode step: every row's old state is gathered
    (``consts.rows``, default row b for batch row b) before any is
    written, then the new state goes back to the same rows in place, cast
    to each leaf's dtype.  A padding row repeats a live row's slot, token
    and state, so it writes the identical new state to the identical row,
    and no row advances twice."""
    B = x.shape[0]
    if cache is None:
        return block(p, x, cfg, init_state(cfg, (B,), x.dtype, x.device),
                     group)
    rows = consts.rows if consts.rows is not None else torch.arange(
        B, device=x.device)
    old = {name: leaf[rows] for name, leaf in cache.items()}
    x, new = block(p, x, cfg, old, group)
    for name, leaf in cache.items():
        leaf.index_put_((rows,), new[name].to(leaf.dtype))
    return x, cache


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device, src_len: Optional[int] = None) -> list:
    """Fresh dense cache tree: per segment, each slot's ``{"attn": {"k",
    "v"}}`` with ``(count, B, S, Hkv, hd)`` leaves (S = ``max_len``, or
    ``min(max_len, window)`` under an architecture window), ``{"rec":
    {"conv", "h"}}`` with ``(count, B, w - 1, lru)`` / ``(count, B,
    lru)`` f32 leaves, or an ``rwkv`` slot's ``{"shift1", "shift2",
    "wkv"}`` (``rwkv6.init_state`` over (count, B)), zeros.  With
    ``src_len``, an ``xattn`` slot also holds ``"xk"`` / ``"xv"`` ``(count,
    B, src_len, Hkv, hd)``, which a prefill fills."""
    dt = dtype_of(cfg)
    w = cfg.attention_window
    rows = max_len if w is None else min(max_len, w)    # w: a ring buffer
    caches = []
    for unit, count in segments(cfg):
        seg = {}
        for j, kind in enumerate(unit):
            if kind == "rec":
                seg[f"slot{j}"] = {"rec": rglru.init_state(
                    cfg, (count, batch_size), dt, device)}
                continue
            if kind == "rwkv":
                seg[f"slot{j}"] = rwkv6.init_state(
                    cfg, (count, batch_size), dt, device)
                continue
            shape = (count, batch_size, rows, cfg.n_kv_heads, cfg.head_dim)
            seg[f"slot{j}"] = {"attn": {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}}
            if kind == "xattn" and src_len is not None:
                xshape = (count, batch_size, src_len, cfg.n_kv_heads,
                          cfg.head_dim)
                for name in ("xk", "xv"):
                    seg[f"slot{j}"][name] = torch.zeros(xshape, dtype=dt,
                                                        device=device)
        caches.append(seg)
    return caches


KV_KINDS = ("attn", "moe", "xattn")


def kv_layers(cfg: ModelConfig) -> int:
    """Layers that keep linear self-attention K/V: the ``attn``, ``moe``
    and ``xattn`` ones."""
    return sum(k in KV_KINDS for k in layer_types(cfg))


def pool_tree(cfg: ModelConfig, pools: dict) -> list:
    """The paged store's pools ``{"k", "v"}`` -- each ``(kv_layers(cfg),
    num_blocks, bs, Hkv, hd)`` -- as the model's cache tree: per segment,
    each ``KV_KINDS`` slot's ``{"attn": {"k", "v"}}`` is the view
    of ``count`` consecutive layers of the stack, slot after slot in
    segment order (a program of one slot gets the pools themselves).
    llama4's ``(attn, moe)`` unit thus reads layers [0, L/2) and [L/2,
    L) of the stack; a layer's index there is storage only."""
    tree, at = [], 0
    for unit, count in segments(cfg):
        seg = {}
        for j, kind in enumerate(unit):
            if kind in KV_KINDS:
                seg[f"slot{j}"] = {"attn": {
                    name: t if count == t.shape[0] else t[at:at + count]
                    for name, t in pools.items()}}
                at += count
        tree.append(seg)
    return tree


def _layers(params: dict, cfg: ModelConfig, layers: Optional[list]):
    """(params, cache index (segment, layer, slot), kind) of every layer
    in order, from ``layer_params`` (or the caller's copy of it)."""
    if layers is None:
        layers = layer_params(params, cfg)
    for s, (seg_layers, (unit, _)) in enumerate(zip(layers, segments(cfg))):
        for l, slots in enumerate(seg_layers):
            for j, p in enumerate(slots):
                yield p, (s, l, f"slot{j}"), unit[j]


def _store_kv(leaf: dict, l: int, k: torch.Tensor, v: torch.Tensor,
              cfg: ModelConfig) -> None:
    """A prefill's K/V (B, S, Hkv, hd) into layer ``l`` of a dense cache
    leaf (reference ``build_cache_from_kv``): linear from row 0, or, in a
    ring of ``s_cache`` rows no longer than the prompt, the last
    ``s_cache`` positions at rows ``pos % s_cache``."""
    S, s_cache = k.shape[1], leaf["k"].shape[2]
    if cfg.attention_window is not None and S >= s_cache:
        rows = torch.arange(S - s_cache, S, device=k.device) % s_cache
        leaf["k"][l][:, rows] = k[:, -s_cache:].to(leaf["k"].dtype)
        leaf["v"][l][:, rows] = v[:, -s_cache:].to(leaf["v"].dtype)
    else:
        leaf["k"][l, :, :S] = k
        leaf["v"][l, :, :S] = v


def _whole_leaves(p: dict) -> dict:
    """A layer's params with every data-cut leaf (``comm.Shard``)
    gathered whole."""
    return {k: _whole_leaves(v) if isinstance(v, dict) else comm.whole(v)
            for k, v in p.items()}


def _unit(slots: list, unit: tuple, x: torch.Tensor, cfg: ModelConfig,
          consts, group, cross=None, data=None):
    """One unit of the block program over x (its slots' layers in
    order): returns (x, the f32 sum of its router losses).  A training
    rank's data-cut leaves (FSDP) are gathered here, all of the unit's
    first, so that under ``run_units``' checkpoint the gathered weights
    are freed after the forward and gathered again in the recompute;
    every rank runs the units in one order, so the gathers line up."""
    slots = [_whole_leaves(p) for p in slots]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(slots, unit):
        x, _, a = _apply_layer(p, x, cfg, kind, consts=consts, group=group,
                               cross=cross, data=data)
        if a is not None:
            aux = aux + a
    return x, aux


def run_units(stack_layers: list, segs: list, x: torch.Tensor,
               cfg: ModelConfig, consts, group, cross=None, data=None):
    """Every unit of a block program over x, each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` asks and grad is on:
    returns (x, the f32 sum of the router losses).  Under ``remat="none"``
    autograd keeps every unit's gathered data-cut weights (FSDP,
    ``_unit``) until the backward: a whole layer's compute-dtype weights
    a unit, as the replicated layout's cast tree held them."""
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_layers, (unit, _) in zip(stack_layers, segs):
        for slots in seg_layers:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _unit, slots, unit, x, cfg, consts, group, cross, data,
                    use_reentrant=False)
            else:
                x, aux = _unit(slots, unit, x, cfg, consts, group, cross,
                               data)
            total = total + aux
    return x, total


def encode(params: dict, cfg: ModelConfig,
           src_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder stack over the stub frontend's embeddings (B, S_src, D)
    (``encoder_input``): bidirectional self-attention at the source
    positions 0..S_src-1 (their own RoPE table), then ``encoder_output``
    (reference ``encode``).  Under a split trunk each ``enc`` layer takes
    the pair around its self-attention and MLP, as a dense layer does."""
    x, consts = encoder_input(cfg, src_embeds)
    x, _ = run_units(layer_params(params, cfg, "encoder"),
                     encoder_segments(cfg), x, cfg, consts, trunk_group(cfg))
    return encoder_output(params, cfg, x)


def encoder_input(cfg: ModelConfig, src_embeds: torch.Tensor):
    """``encode``'s input: (``src_embeds`` cast to the compute dtype, the
    step constants of the source positions)."""
    x = src_embeds.to(dtype_of(cfg))
    return x, step_constants(cfg, torch.arange(x.shape[1], device=x.device))


def encoder_output(params: dict, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """``encode``'s end: ``encoder_norm`` over the encoder stack's output
    x.  Under a split trunk it goes through ``comm.copy_to_group`` (kind
    ``"cross"``) once, before every ``xattn`` layer's ``wk`` / ``wv`` read
    it: each rank's kv heads give a part of its gradient, one all-reduce
    of (B, S_src, D) a step sums them."""
    return comm.copy_to_group(rms_norm(x, params["encoder_norm"],
                                       cfg.norm_eps), trunk_group(cfg),
                              "cross")


def _encoder_output(params: dict, cfg: ModelConfig,
                    src_embeds: Optional[torch.Tensor]):
    """``encode`` of ``src_embeds`` for an ``encdec`` config, else None."""
    if not cfg.n_encoder_layers:
        return None
    if src_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder config needs "
                         "src_embeds (B, S_src, D)")
    return encode(params, cfg, src_embeds)


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """One ``xattn`` layer's read-only cross K/V (B, S_src, Hkv, hd) from
    the encoder's output: no norm, no RoPE (reference ``_cross_kv``); on
    a rank of a split trunk its kv heads (``cfg.n_kv_heads`` the
    rank's)."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return (_split_heads(enc_out @ p["xattn"]["wk"], hkv, hd),
            _split_heads(enc_out @ p["xattn"]["wv"], hkv, hd))


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None):
    """The train / eval forward over ``tokens`` (B, S): returns (f32
    logits (B, S, V), the f32 sum of the ``moe`` layers' router losses, 0
    for a family without them).  The reference's train-mode attention is
    masked softmax over all S positions; this is the same function
    through the cache-less branch (``ops.flash_attention``, causal, the
    architecture window), which carries its gradient; a ``rec`` layer
    runs its block from a zero state, a ``moe`` layer routes through the
    prefill executor.  ``image_embeds`` (B, n, D) replace the first n
    positions' embeddings of a ``vlm`` config; an ``encdec`` config's
    ``src_embeds`` (B, S_src, D) go through ``encode`` first, and every
    ``xattn`` layer attends over its output.

    ``cfg.remat``: with grad enabled and a policy other than ``"none"``,
    each unit of the block program runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, as the
    reference wraps each unit in ``jax.checkpoint``: the unit's input is
    kept and its activations are recomputed in the backward (so flash
    attention launches twice a layer a step).  PyTorch has no
    counterpart of ``"dots"`` (``dots_with_no_batch_dims_saveable``,
    which keeps the matmul outputs), so ``"dots"`` saves less than the
    reference and recomputes more -- as ``"full"`` does; the numbers are
    the same."""
    h, total = hidden(params, cfg, tokens, image_embeds=image_embeds,
                      src_embeds=src_embeds)
    return logits_fn(params, cfg, h), total


def embed_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               image_embeds: Optional[torch.Tensor] = None):
    """A forward's or a prefill's input over ``tokens`` (B, S): (the
    token embeddings, a vlm config's image prefix in place
    (``embed_tokens``), the step constants of positions 0..S-1)."""
    x = embed_tokens(params, cfg, tokens, image_embeds)
    return x, step_constants(cfg, torch.arange(tokens.shape[1],
                                               device=tokens.device))


def hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
           image_embeds: Optional[torch.Tensor] = None,
           src_embeds: Optional[torch.Tensor] = None, data=None):
    """``forward`` up to the head: (the final-normed hidden states (B, S,
    D), the f32 sum of the router losses; ``data``, a training rank's
    data group, makes each its share over the global means)."""
    enc_out = _encoder_output(params, cfg, src_embeds)
    x, consts = embed_step(params, cfg, tokens, image_embeds)
    x, total = run_units(layer_params(params, cfg), segments(cfg), x, cfg,
                          consts, trunk_group(cfg), enc_out, data)
    return final_hidden(params, cfg, x), total


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, *, image_embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None):
    """Process the prompt (B, S): returns (last hidden (B, D), cache):
    each self-attention layer's K/V zero-padded to ``max_len`` positions
    (or its ring buffer, ``_store_kv``), each ``rec`` layer's state after
    the prompt, each ``xattn`` layer's cross K/V over the encoder's output
    of ``src_embeds`` (computed once here; a decode step only reads it).
    ``image_embeds`` as in ``forward``."""
    B = tokens.shape[0]
    enc_out = _encoder_output(params, cfg, src_embeds)
    x, consts = embed_step(params, cfg, tokens, image_embeds)
    caches = init_cache(cfg, B, max_len, tokens.device,
                        None if enc_out is None else enc_out.shape[1])
    group = trunk_group(cfg)
    for p, (s, l, slot), kind in _layers(params, cfg, None):
        x = prefill_layer(p, x, cfg, kind, consts, group, enc_out,
                          caches[s][slot], l)
    h = final_hidden(params, cfg, x[:, -1:, :])[:, 0, :]
    return h, caches


def prefill_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                  consts, group, enc_out: Optional[torch.Tensor],
                  leaf: dict, l: int) -> torch.Tensor:
    """One layer of ``prefill``: the layer over x, then what it leaves
    written into layer ``l`` of its slot's cache ``leaf`` -- a recurrent
    layer's state, or the K/V (``_store_kv``) and an ``xattn`` layer's
    cross K/V."""
    x, extra, _ = _apply_layer(p, x, cfg, kind, consts=consts, group=group,
                               cross=enc_out)
    if kind in ("rec", "rwkv"):
        state = leaf["rec"] if kind == "rec" else leaf
        for name, t in state.items():
            t[l] = extra[name]
        return x
    _store_kv(leaf["attn"], l, *extra, cfg)
    if kind == "xattn":
        leaf["xk"][l], leaf["xv"][l] = _cross_kv(p, enc_out, cfg)
    return x


def _first_kv(caches: list, cfg: ModelConfig) -> Optional[torch.Tensor]:
    """A self-attention layer's K leaf (pools or dense), whose shape says
    what the step's cache indices are; None for a config with no
    attention layer (``ssm``)."""
    for seg, (unit, _) in zip(caches, segments(cfg)):
        for j, kind in enumerate(unit):
            if kind in KV_KINDS:
                return seg[f"slot{j}"]["attn"]["k"]
    return None


def decode_constants(cfg: ModelConfig, caches: list, pos: torch.Tensor,
                     T: int, *, block_tables: Optional[torch.Tensor] = None,
                     cache_rows: Optional[torch.Tensor] = None):
    """The ``layers.step_constants`` of a decode step of T queries a row
    from ``pos`` over ``caches`` (see ``decode_step``)."""
    if pos.dim() == 2:
        positions = pos                                   # (B, T)
    elif pos.dim() == 1:
        positions = pos[:, None] + torch.arange(T, device=pos.device)
    elif pos.dim() == 0:
        positions = pos + torch.arange(T, device=pos.device)   # (T,)
    else:
        raise ValueError(f"pos must be a scalar, (B,) or (B, T); got "
                         f"{tuple(pos.shape)}")
    leaf = _first_kv(caches, cfg)
    if leaf is None:
        # no attention layer: no RoPE table, no cache cells, only the rows
        return StepConstants(None, None, rows=cache_rows)
    if block_tables is not None:
        return step_constants(cfg, positions, cache_pos=pos,
                              block_tables=block_tables,
                              block_size=leaf.shape[2])
    return step_constants(cfg, positions, cache_pos=pos,
                          cache_len=leaf.shape[2], rows=cache_rows,
                          window=cfg.attention_window)


def decode_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 consts, group, leaf: dict, l: int,
                 cache_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of ``decode_step`` over layer ``l`` of its slot's cache
    ``leaf``, written in place; an ``xattn`` layer reads its slot's
    ``xk`` / ``xv``."""
    cross = None
    if kind == "xattn":
        if "xk" not in leaf:
            raise ValueError("an xattn layer's decode step needs the "
                             "prefill's cross K/V (xk / xv)")
        cross = {"k": leaf["xk"][l], "v": leaf["xv"][l]}
        if cache_rows is not None:
            cross = {name: t[cache_rows] for name, t in cross.items()}
    if kind != "rwkv":
        leaf = leaf["rec" if kind == "rec" else "attn"]
    x, _, _ = _apply_layer(p, x, cfg, kind, consts=consts, cache={
        name: t[l] for name, t in leaf.items()}, group=group, cross=cross)
    return x


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
    pools; without, dense leaves over N cache rows (K/V ``(L, N, S, Hkv,
    hd)``, a ring of S = window rows under an architecture window, T = 1
    there; a ``rec`` layer's state), batch row b in cache row
    ``cache_rows[b]`` (default b).  ``layers`` is
    ``layer_params(params, cfg)`` where the caller keeps it.  The RoPE
    table and the cache indices are computed once for all layers
    (``layers.step_constants``).  An ``xattn`` layer reads its slot's
    ``xk`` / ``xv`` (the prefill's cross K/V) and never writes them.
    Returns (h, caches): h is (B, D) for T == 1 and (B, T, D)
    otherwise."""
    T = token.shape[1]
    consts = decode_constants(cfg, caches, pos, T, block_tables=block_tables,
                              cache_rows=cache_rows)
    x = embed_tokens(params, cfg, token)
    group = trunk_group(cfg)
    for p, (s, l, slot), kind in _layers(params, cfg, layers):
        x = decode_layer(p, x, cfg, kind, consts, group, caches[s][slot], l,
                         cache_rows)
    if T == 1:
        return final_hidden(params, cfg, x[:, 0, :]), caches
    return final_hidden(params, cfg, x), caches
