"""The training loss, and the serving steps over the model: one-shot
prefill (dense or paged), the decode step and the device-resident
multi-step decode, each ending in a sampler head.

Counterpart of ``repro.models.api``, whose input structs
(``batch_struct``, ``cache_struct``, ``params_struct``) are trees on the
``meta`` device here.  ``sampler`` is a
``repro_torch.serve.sampler.Sampler`` (its ``head`` turns the final
hidden state into what the host needs, its ``sample_device`` into the
next token).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import prng
from repro_torch import tree as tree_mod
from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.parallel import comm, sharding
from repro_torch.weights import cast_params


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def merge_stats(stats: torch.Tensor) -> torch.Tensor:
    """The per-row logsumexp of slices whose (max, sum exp(x - max)) are
    ``stats`` (ranks, rows, 2) f32, merged in rank order: ``m = max_r
    m_r``, ``l = sum_r l_r * exp(m_r - m)`` (the online softmax's
    merge), ``m + log l``.  The same bits on every rank that holds the
    same ``stats``."""
    m = stats[..., 0].amax(dim=0)
    l = torch.zeros_like(m)
    for part in stats:
        l = l + part[:, 1] * torch.exp(part[:, 0] - m)
    return m + torch.log(l)


class _VocabParallelXent(torch.autograd.Function):
    """Per-row softmax cross-entropy over a vocabulary cut into contiguous
    slices, one a rank of ``group``, without gathering the (rows, V)
    logits: the reference's one-hot-free label pick
    (``repro/models/api.py:54-69``), which exists so the vocabulary axis
    is never gathered.

    Forward: ``ops.softmax_stats`` (the stats kernel on the card) on the
    rank's slice gives (m_r, l_r); the pairs are all-gathered over the
    group (rows x 2 x 4 bytes a rank) and merged into ``lse`` in rank
    order (``merge_stats``); the rank whose range holds a row's label
    gives ``x[label - lo]``, the others 0, and an all-reduce sums them
    (one term is non-zero: exact); ``lse - label_logit``.

    Backward: ``exp(x - lse)`` as ``ops.online_softmax`` of the slice
    (the softmax kernel, ``exp(x - m') / l'`` of its own stats) times the
    per-row factor ``l_r * exp(m_r - lse)``, 1 taken off at a local
    label, then scaled by the row's ``g`` in place, as
    ``ops._SoftmaxXent.backward``; no collective.  The label's 1 comes off
    in static shapes: every row takes off ``mine`` (1 or 0) at its
    clamped local column, and ``p - 0`` is ``p`` -- the same numbers as
    picking the rows that hold their label, with no host sync, so the
    step runs on ``meta`` too."""

    @staticmethod
    def forward(ctx, x, labels, group, lo):
        m_r, l_r = ops.softmax_stats(x)
        stats = group.all_gather(torch.stack([m_r, l_r], dim=1), "loss")
        lse = merge_stats(stats)
        local = labels.long() - lo
        mine = (local >= 0) & (local < x.shape[1])
        rows = torch.arange(x.shape[0], device=x.device)
        pick = torch.where(mine, x[rows, local.clamp(0, x.shape[1] - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        pick = group.all_reduce_sum(pick.contiguous(), "loss")
        ctx.save_for_backward(x, local, mine, m_r, l_r, lse)
        return lse - pick

    @staticmethod
    def backward(ctx, g):
        x, local, mine, m_r, l_r, lse = ctx.saved_tensors
        p = ops.online_softmax(x)
        p.mul_((l_r * torch.exp(m_r - lse))[:, None])
        rows = torch.arange(x.shape[0], device=x.device)
        p[rows, local.clamp(0, x.shape[1] - 1)] -= mine.to(p.dtype)
        p.mul_(g[:, None])
        return p.to(x.dtype), None, None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        group, lo: int) -> torch.Tensor:
    """Per-row cross-entropy (N,) f32 of the rank's logits slice (N, V /
    ranks) f32, ids [lo, lo + V / ranks) of the vocabulary, labels (N,)
    in [0, V); differentiable in ``logits`` (``_VocabParallelXent``)."""
    return _VocabParallelXent.apply(logits, labels, group, lo)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *, split=None,
              data=None) -> torch.Tensor:
    """Mean softmax cross-entropy; logits (..., V) f32, labels (...) int
    in [0, V), mask (...) or None.  Each token's loss is
    ``ops.softmax_xent`` over the flattened (N, V) rows -- the
    cross-entropy kernel on the card, whose backward runs the softmax
    kernel -- then the reference's mean: ``sum(loss * mask) /
    max(sum(mask), 1)``, or the plain mean without a mask.

    ``split`` (a ``parallel.sharding.Split`` over its group, a trunk cut
    of world > 1 that cuts the vocabulary; ``train_loss`` passes None
    for one that keeps it whole): ``logits`` are the rank's (N, V /
    ranks) slice and
    each token's loss is ``vocab_parallel_xent``'s.  ``data`` (the rank's
    data group, its rows one block of the global batch): the loss is the
    rank's SHARE of the global mean, its masked sum over the global
    count of tokens (the mask's sum all-reduced over the data group, kind
    ``"loss"``; without a mask the rank's tokens times the group's
    size), so the shares' sum over the data group is the mean and its
    gradient the mean's; a mean of the ranks' means would not be where
    the ranks' counts differ."""
    v = logits.shape[-1]
    flat = logits.reshape(-1, v).float()
    if split is not None and split.trunk and split.world > 1:
        per_tok = vocab_parallel_xent(flat, labels.reshape(-1), split.group,
                                      split.vocab[0])
    else:
        per_tok = ops.softmax_xent(flat, labels.reshape(-1))
    if data is None:
        if mask is None:
            return per_tok.mean()
        mask = mask.reshape(-1).float()
        return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if mask is None:
        return per_tok.sum() / float(per_tok.numel() * data.world)
    mask = mask.reshape(-1).float()
    count = data.all_reduce_sum(mask.sum().reshape(1), "loss")[0]
    return (per_tok * mask).sum() / torch.clamp(count, min=1.0)


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               data=None, dcut=None) -> torch.Tensor:
    """The training objective of ``batch`` ({"tokens", "labels"} (B, S),
    optionally "loss_mask", and the stub frontends' "image_embeds" (vlm)
    or "src_embeds" (encdec), which go on to ``lm.forward``):
    ``xent_loss`` of ``lm.forward``'s logits, plus ``router_aux_weight``
    times the router loss under ``cfg.moe``.  ``params`` are the f32
    masters, cast to the compute dtype inside the loss as the reference's
    ``forward`` casts them (``weights.cast_params`` is differentiable), so
    the gradients reach the masters in f32.

    On a mesh: ``cfg`` is the rank's view (``sharding.local_config``) and
    ``params`` its slice when the model axis is split.  Where the split
    cuts the vocabulary the loss reads the rank's logits slice
    (``lm.local_logits``, its input behind ``comm.copy_to_group``)
    through the vocabulary-parallel loss; where it keeps the vocabulary
    whole (one that does not divide by the model axis,
    ``sharding.vocab_cut`` false) the head and the loss are the plain
    ones (``lm.logits_fn``, ``ops.softmax_xent``: the cross-entropy
    kernel on the card), the same numbers on every model rank, whose
    input gradient is whole already.  ``data`` is the rank's data group,
    and the loss its share of the global mean (``xent_loss``) plus its
    share of the global router loss (``layers.moe_aux_loss`` over
    ``data``: the routed counts summed over the group before the
    product), so the data group's sum of the shares is the global loss.
    Under a split model axis the router loss's gradient is shared over
    the model group (``parallel.moe_ep``).  ``dcut`` (a
    ``sharding.DataCut``, D > 1): ``params`` hold the rank's 1/D cut of
    every data-cut leaf (FSDP), which ``cast_params`` leaves as a
    ``comm.Shard``: the embedding is gathered here, once, for the lookup
    and a tied head; an untied head where the head reads it; a unit's
    leaves inside the unit (``lm._unit``)."""
    cast = cast_params(params, cfg, dcut)
    if isinstance(cast["embed"], comm.Shard):
        cast["embed"] = cast["embed"].whole()
    h, aux = lm.hidden(cast, cfg, batch["tokens"],
                       image_embeds=batch.get("image_embeds"),
                       src_embeds=batch.get("src_embeds"), data=data)
    loss = head_loss(cast, cfg, h, batch, data=data)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


def head_loss(params: dict, cfg: ModelConfig, h: torch.Tensor, batch: dict,
              *, data=None) -> torch.Tensor:
    """``train_loss``'s head and cross-entropy over the final-normed
    hidden states h (B, S, D), ``params`` cast: the rank's logits slice
    through the vocabulary-parallel loss where the split cuts the
    vocabulary, else the whole head and ``xent_loss``."""
    sh = cfg.shard
    if sh is not None and sh.trunk and sharding.vocab_cut(cfg):
        logits, split = lm.local_logits(params, cfg, h), sh
    else:
        logits, split = lm.logits_fn(params, cfg, h), None
    return xent_loss(logits, batch["labels"], batch.get("loss_mask"),
                     split=split, data=data)


def serve_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  max_len: int, sampler, *,
                  image_embeds: Optional[torch.Tensor] = None,
                  src_embeds: Optional[torch.Tensor] = None):
    """Prompt pass for a dense store: returns (head output, cache), the
    cache ``lm.prefill``'s tree (K/V zero-padded past the prompt to
    ``max_len``, or a windowed layer's ring buffer; a ``rec`` layer's
    state); the engine copies a B = 1 cache into its slot's row
    (``PagedKVStore.admit``).  ``image_embeds`` / ``src_embeds``: the
    stub frontends' inputs of a vlm / encdec config (``lm.prefill``)."""
    h, cache = lm.prefill(params, cfg, tokens, max_len,
                          image_embeds=image_embeds, src_embeds=src_embeds)
    return sampler.head(params, cfg, h), cache


def serve_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: list, pos: torch.Tensor, sampler, *,
                 block_tables: Optional[torch.Tensor] = None):
    """One token step: returns (head output, cache).  ``pos`` is a scalar,
    (B,) -- every row at its own position -- or (B, T) for a (B, T)
    window, whose head then reads position 0.  The cache (paged pools
    with ``block_tables``, dense leaves without) is written in place.

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
    Hkv, hd) over the L attention-bearing layers, ``lm.pool_tree``'s
    stack), in place, every attention-bearing slot into its own view.
    Positions of the last block past the prompt receive the prefill's
    zero padding, as in the JAX package; decode overwrites them before
    any query can see them.  Returns the head output."""
    h, cache = lm.prefill(params, cfg, tokens, cache_len)
    nb = blocks.shape[0]
    for seg, pseg in zip(cache, lm.pool_tree(cfg, pools)):
        for slot, views in pseg.items():
            for name, pool in views["attn"].items():
                bs = pool.shape[2]
                view = seg[slot]["attn"][name][:, 0, :nb * bs]
                pool[:, blocks] = view.reshape(view.shape[0], nb, bs,
                                               *view.shape[2:]).to(pool.dtype)
    return sampler.head(params, cfg, h)


@dataclasses.dataclass
class MultiCarry:
    """The carry of the multi-step decode, all on one device and updated
    in place by ``decode_multi_step``:

    tok, pos   (B,) int64 / int32: each row's trunk input this step
    keys       (B, 2) int64: each row's PRNG key (``repro_torch.prng``)
    emitted    (B,) int32: tokens each row has emitted in this dispatch
    halted     (B,) bool: rows that emitted ``eos_id``
    out        (B, steps) int64: the emitted tokens, -1 where a row
               emitted nothing
    step       (1,) int64: the next column of ``out``
    caps       (B,) int32: each row's emit cap (0 for a padding row)
    """
    tok: torch.Tensor
    pos: torch.Tensor
    keys: torch.Tensor
    emitted: torch.Tensor
    halted: torch.Tensor
    out: torch.Tensor
    step: torch.Tensor
    caps: torch.Tensor

    @classmethod
    def start(cls, token, pos, keys, emit_caps, steps: int) -> "MultiCarry":
        """A dispatch's first carry: the rows' (last token, next write
        position), keys and caps, nothing emitted."""
        b, dev = token.shape[0], token.device
        return cls(token.long().clone(), pos.to(torch.int32).clone(),
                   keys.long().clone(),
                   torch.zeros(b, dtype=torch.int32, device=dev),
                   torch.zeros(b, dtype=torch.bool, device=dev),
                   torch.full((b, steps), -1, dtype=torch.int64, device=dev),
                   torch.zeros(1, dtype=torch.int64, device=dev),
                   emit_caps.to(torch.int32))

    def active(self) -> torch.Tensor:
        return ~self.halted & (self.emitted < self.caps)


def decode_multi_step(params: dict, cfg: ModelConfig, c: MultiCarry,
                      cache: list, row_sets: Sequence[torch.Tensor], *,
                      eos_id: int, samplers: Sequence,
                      block_tables: Optional[torch.Tensor] = None,
                      cache_rows: Optional[torch.Tensor] = None,
                      layers: Optional[list] = None) -> None:
    """One iteration of the multi-step decode, in place on ``c`` and the
    pools: the trunk at T 1 over every row, one ``sample_device`` per
    sampler group (``row_sets[g]`` its rows), then the carry.

    A row is ACTIVE while it has not halted and has emitted fewer than
    its cap.  An active row emits its sampled token into column ``step``
    of ``out`` and, when a group's sampler draws (``Sampler.draws``),
    consumes one split of its key (row 1 draws, row 0 is its next key;
    a sampler that never draws never reads its key, so a dispatch of
    such groups splits none); one that samples ``eos_id`` halts after
    emitting it.  A row that is active next step feeds its token back at
    the next position; any other row repeats its last (token, position),
    so it rewrites the K/V cell it wrote last with the same values -- a
    no-op that never writes past the block table's cover, which reaches
    each row's last emitting write only.  ``cache`` holds paged pools
    with ``block_tables``, else dense leaves with ``cache_rows``
    (``lm.decode_step``).  It reads nothing on the host, so a CUDA graph
    can capture it (``serve.step_graph``)."""
    active = c.active()
    h, _ = lm.decode_step(params, cfg, c.tok[:, None], cache, c.pos,
                          block_tables=block_tables, cache_rows=cache_rows,
                          layers=layers)
    draws = any(s.draws for s in samplers)
    split = prng.split(c.keys) if draws else None    # (B, 2, 2)
    sampled = c.tok.clone()
    for s, rows in zip(samplers, row_sets):
        sampled[rows] = s.sample_device(
            params, cfg, h[rows], split[rows, 1] if draws else None)
    c.out.index_copy_(1, c.step,
                      torch.where(active, sampled, -1)[:, None])
    c.halted |= active & (sampled == eos_id)
    c.emitted += active.to(torch.int32)
    if draws:
        c.keys.copy_(torch.where(active[:, None], split[:, 0], c.keys))
    nxt = c.active()
    c.tok.copy_(torch.where(nxt, sampled, c.tok))
    c.pos.copy_(torch.where(nxt, c.pos + 1, c.pos))
    c.step += 1


def serve_decode_multi(params: dict, cfg: ModelConfig, token: torch.Tensor,
                       cache: list, pos: torch.Tensor, keys: torch.Tensor,
                       emit_caps: torch.Tensor,
                       row_sets: Sequence[torch.Tensor], *, steps: int,
                       eos_id: int, samplers: Sequence,
                       block_tables: Optional[torch.Tensor] = None,
                       cache_rows: Optional[torch.Tensor] = None,
                       layers: Optional[list] = None):
    """Device-resident multi-step decode, eagerly: up to ``steps``
    iterations of ``decode_multi_step`` -- trunk, K/V writes, keyed
    sampling and the feedback of the sampled token -- leaving early once
    no row is active, as the JAX package's ``lax.while_loop`` does.  The
    ``host_stride`` engine's dispatch on the CPU and inside
    ``step_graph.eager_steps()``; on the card the engine replays one
    captured iteration instead (``serve.step_graph``).

    token (B,) each row's last token, pos (B,) its next write position,
    keys (B, 2), emit_caps (B,) each row's cap (the engine folds
    ``max_new_tokens``, ``max_len`` and the block cover into it; 0 for a
    padding row), ``samplers`` the full samplers of the groups and
    ``row_sets`` their rows; ``block_tables`` or ``cache_rows`` as
    ``decode_multi_step`` takes them.  Returns ``(out (B, steps) int64
    with -1 padding, emitted (B,) int32, new keys (B, 2), the iterations
    run)``; the cache is written in place."""
    c = MultiCarry.start(token, pos, keys, emit_caps, steps)
    while int(c.step) < steps and bool(c.active().any()):
        decode_multi_step(params, cfg, c, cache, row_sets, eos_id=eos_id,
                          samplers=samplers, block_tables=block_tables,
                          cache_rows=cache_rows, layers=layers)
    return c.out, c.emitted, c.keys, int(c.step)


# ---------------------------------------------------------------------------
# Input structs on the ``meta`` device (shapes and dtypes, no memory)
# ---------------------------------------------------------------------------
def batch_struct(cfg: ModelConfig, shape, rows: Optional[int] = None) -> dict:
    """The batch of ``shape`` (a ``ShapeSpec``; train or prefill) on
    ``meta``, ``rows`` of it (default the global batch): ``tokens`` (B,
    S) int32, the stub frontends' ``src_embeds`` (B, S, D) of an encdec
    config or ``image_embeds`` (B, n, D) of a vlm one in the compute
    dtype, and ``labels`` (B, S) int32 for training (reference
    ``batch_struct``)."""
    b = shape.global_batch if rows is None else rows
    s, dt = shape.seq_len, getattr(torch, cfg.dtype)
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.n_encoder_layers:
        out["src_embeds"] = torch.empty((b, s, cfg.d_model), dtype=dt,
                                        device="meta")
    elif cfg.num_image_tokens:
        out["image_embeds"] = torch.empty((b, cfg.num_image_tokens,
                                           cfg.d_model), dtype=dt,
                                          device="meta")
    if shape.kind == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32,
                                    device="meta")
    return out


def cache_struct(cfg: ModelConfig, batch_size: int, max_len: int) -> list:
    """The dense decode cache on ``meta`` (``lm.init_cache``), an encdec
    config's cross K/V over a source of ``max_len`` positions (reference
    ``cache_struct``)."""
    return lm.init_cache(cfg, batch_size, max_len, "meta",
                         max_len if cfg.n_encoder_layers else None)


def params_struct(cfg: ModelConfig) -> dict:
    """The f32 masters' tree on ``meta`` (``weights.param_shapes``):
    the reference's ``eval_shape`` of ``init_params``."""
    return tree_mod.map_tree(
        lambda _, spec: torch.empty(spec[0], dtype=torch.float32,
                                    device="meta"),
        weights.param_shapes(cfg))
