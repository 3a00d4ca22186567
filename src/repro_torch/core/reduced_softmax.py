"""The paper's contribution: the Reduced Softmax unit.

Counterpart of the single-device part of ``repro.core.reduced_softmax``.
Theorem 1 (exp, hence softmax, is monotonic) means an inference-only
accelerator can replace the softmax activation by a comparator:
``predict(x) = argmax(x)`` with NO exponentials, sum or division, and the
classification is identical.

  1. ``reduced_softmax_predict``  the pure form (argmax);
  2. ``fused_reduced_head``       argmax over ``h @ W`` without storing the
                                  logits (the CUDA head kernel on the
                                  card, its plain version on the CPU);
  3. ``reduced_topk`` /           the k-winner comparator, plain and fused
     ``fused_reduced_topk``       with the head matmul.

  4. ``topk_sample``              the keyed draw over the k survivors
                                  (``prng.categorical``: a softmax over k
                                  values, not the vocabulary).
  5. ``distributed_argmax`` /     the multi-chip form for a vocabulary-
     ``sharded_reduced_head`` /   sharded head (reference :146-340): each
     ``sharded_reduced_topk`` /   rank runs the head kernel on its own
     ``sharded_verify_draft``     contiguous slice of W, offsets its ids to
                                  GLOBAL ids, and one all-gather of the
                                  (val, idx) tables -- O(rows * ranks * k),
                                  never O(rows * V) -- feeds a merge that
                                  picks the unsharded winners bit for bit.
                                  The merges (``merge_argmax``,
                                  ``_merge_topk_tables``) take stacked
                                  tables, so one process can combine
                                  slices it ran itself.

Ties everywhere: the lowest index wins (as ``torch.argmax``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref


def reduced_softmax_predict(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The comparator unit: class = argmax of the raw inputs -- by
    Theorem 1 equal to ``argmax(softmax(x))``."""
    return torch.argmax(x, dim=dim)


def argmax_with_value(x: torch.Tensor, dim: int = -1):
    """(argmax, max) pair -- the comparator's full output bus."""
    return torch.argmax(x, dim=dim), torch.amax(x, dim=dim)


def reduced_topk(x: torch.Tensor, k: int):
    """The k-winner comparator: top-k (vals f32, idxs int32) over the
    last axis, values descending, the lowest index first among ties.
    Still zero exp / sum / divide; for k = 1 it is
    ``reduced_softmax_predict`` plus the max value."""
    return ref.topk_select(x, k)


def topk_sample(vals: torch.Tensor, idxs: torch.Tensor, key: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """Sample a vocabulary id from the k comparator survivors: vals /
    idxs (B, k) from ``reduced_topk`` or the fused head, ONE key (2,)
    over the (B, k) logits, as ``repro.core.reduced_softmax.topk_sample``
    draws.  The softmax this stands for runs over k values, not V;
    temperature <= 0 is greedy (survivor 0).  Returns (B,) int32."""
    if temperature <= 0.0:
        return idxs[:, 0].to(torch.int32)
    choice = prng.categorical(key, vals.float() / temperature)      # (B,)
    return torch.gather(idxs, 1, choice[:, None])[:, 0].to(torch.int32)


def fused_reduced_topk(h: torch.Tensor, w: torch.Tensor, k: int):
    """Top-k of ``h @ w`` over the vocabulary without storing the logits:
    (vals (B, k) f32, idxs (B, k) int32) -- the bus a top-k sampler
    reads."""
    return ops.fused_topk_head(h, w, k)


def fused_reduced_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary of ``h @ w`` for greedy decoding: (B,)
    int32, h (B, D), w (D, V)."""
    return ops.fused_argmax_head(h, w)


# ---------------------------------------------------------------------------
# The distributed (vocabulary-sharded) reduced unit
# ---------------------------------------------------------------------------
def _combine_val_idx(val: torch.Tensor, idx: torch.Tensor, dim: int = 0):
    """Argmax over a (val, idx) table along ``dim``: (idx, val) of the
    largest value, the smallest GLOBAL index among equal values -- what
    ``torch.argmax`` gives on the unsharded row."""
    best = torch.amax(val, dim=dim, keepdim=True)
    cand = torch.where(val == best, idx, torch.iinfo(idx.dtype).max)
    return torch.amin(cand, dim=dim), best.squeeze(dim)


def merge_argmax(vals: torch.Tensor, idxs: torch.Tensor):
    """The winners of rank-stacked (ranks, ...) (val, global idx) tables:
    (idx int32, val f32), each of the remaining shape."""
    return _combine_val_idx(vals, idxs, dim=0)


def _gather_pairs(group, val: torch.Tensor, idx: torch.Tensor):
    """One all-gather of a (val f32, idx int32) table pair, the ids riding
    as f32 bit patterns: (vals, idxs), each (ranks, *val.shape)."""
    both = group.all_gather(torch.stack([val, idx.view(torch.float32)]),
                            "head")
    return both[:, 0], both[:, 1].view(torch.int32)


def shard_argmax_table(h: torch.Tensor, w: torch.Tensor, v_lo: int):
    """A vocabulary shard's comparator: (val (B,) f32, global idx (B,)
    int32) of ``h @ w`` over the shard's (D, V / ranks) ``w``, whose ids
    start at ``v_lo`` -- the argmax head kernel on the slice."""
    idx, val = ops.fused_argmax_head_with_value(h, w)
    return val, idx + v_lo


def distributed_argmax(logits: torch.Tensor, group, *,
                       v_lo: int) -> torch.Tensor:
    """argmax over the last (vocabulary) axis of logits split across the
    group's ranks, this rank holding ids [v_lo, v_lo + V_local): one
    (val, idx) pair per row per rank crosses the group.  (rows...) int32."""
    idx = torch.argmax(logits, dim=-1).to(torch.int32) + v_lo
    vals, idxs = _gather_pairs(group, torch.amax(logits, dim=-1).float(), idx)
    return merge_argmax(vals, idxs)[0]


def sharded_reduced_head(h: torch.Tensor, w: torch.Tensor, group, *,
                         v_lo: int) -> torch.Tensor:
    """The distributed reduced head: each rank's fused argmax over its
    slice ``w`` (D, V / ranks), then the (val, idx) combine.  (B,)
    int32, the same on every rank and equal to the unsharded head's."""
    vals, idxs = _gather_pairs(group, *shard_argmax_table(h, w, v_lo))
    return merge_argmax(vals, idxs)[0]


def _merge_topk_tables(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Exact top-k over candidate tables (B, M): k passes of the (val,
    idx) combine -- values descending, the lowest GLOBAL id among equal
    values -- each winner retired by its (unique) id, never by value, so
    equal values on two ranks survive as two candidates.  (vals (B, k)
    f32, idxs (B, k) int32), the unsharded bus bit for bit."""
    out_v, out_i = [], []
    for _ in range(k):
        idx, val = _combine_val_idx(vals, idxs, dim=-1)
        out_v.append(val)
        out_i.append(idx)
        vals = torch.where(idxs == idx[:, None], -torch.inf, vals)
    return torch.stack(out_v, dim=-1), torch.stack(out_i, dim=-1)


def shard_topk_table(h: torch.Tensor, w: torch.Tensor, k: int, *,
                     v_lo: int, rank: int, ranks: int, vocab_size: int):
    """A vocabulary shard's k-winner bus: the top-k head kernel on the
    slice ``w`` (D, V / ranks), ids offset to global.  A shard narrower
    than k pads with -inf at unique out-of-vocabulary ids (``vocab_size
    + rank * pad + j``): never chosen while a real candidate remains,
    harmless to retire.  (vals (B, k) f32, idxs (B, k) int32)."""
    v_local = w.shape[1]
    kk = min(k, v_local)
    vals, idxs = ops.fused_topk_head(h, w, kk)
    idxs = idxs + v_lo
    if kk < k:
        pad = k - kk
        base = vocab_size + rank * pad
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              -torch.inf)], dim=1)
        ids = torch.arange(base, base + pad, dtype=idxs.dtype,
                           device=idxs.device)
        idxs = torch.cat([idxs, ids.expand(idxs.shape[0], pad)], dim=1)
    return vals, idxs


def merge_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """The global top-k of rank-stacked (ranks, B, k) tables."""
    r, b, kk = vals.shape
    return _merge_topk_tables(vals.permute(1, 0, 2).reshape(b, r * kk),
                              idxs.permute(1, 0, 2).reshape(b, r * kk), k)


def sharded_reduced_topk(h: torch.Tensor, w: torch.Tensor, k: int, group,
                         *, v_lo: int, vocab_size: int):
    """The k-winner comparator bus on a vocabulary-sharded head: each
    rank's fused top-k over its slice, one all-gather of k (val, idx)
    pairs per row per rank, then the k-pass merge -- (vals (B, k) f32,
    idxs (B, k) int32) identical to the unsharded bus."""
    vals, idxs = _gather_pairs(group, *shard_topk_table(
        h, w, k, v_lo=v_lo, rank=group.rank, ranks=group.world,
        vocab_size=vocab_size))
    return merge_topk(vals, idxs, k)


def shard_verify_table(h: torch.Tensor, w: torch.Tensor,
                       cand: torch.Tensor, v_lo: int):
    """A vocabulary shard's verify: the verify head kernel on the slice,
    each position's (max val (B, T) f32, global idx (B, T) int32)."""
    ids, _, vals = ops.verify_draft_with_value(h, w, cand)
    return vals, ids + v_lo


def accepted_run(ids: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(B,) int32: the leading run where ``ids[:, :T-1] == cand`` (the
    -1 padding of a ragged draft never equals an id)."""
    ok = (ids[:, :ids.shape[1] - 1] == cand).to(torch.int32)
    return torch.cumprod(ok, dim=-1).sum(dim=-1).to(torch.int32)


def sharded_verify_draft(h: torch.Tensor, w: torch.Tensor,
                         cand: torch.Tensor, group, *, v_lo: int):
    """Speculative verification on a vocabulary-sharded head: the contract
    of ``ops.verify_draft`` -- h (B, T, D), w the rank's (D, V / ranks)
    slice, cand (B, T-1) -> (ids (B, T) int32, accept (B,) int32) -- with
    each position's argmax the per-rank comparator plus the (val, idx)
    combine: one pair per position per rank crosses the group."""
    vals, idxs = _gather_pairs(group, *shard_verify_table(h, w, cand, v_lo))
    ids = merge_argmax(vals, idxs)[0]
    return ids, accepted_run(ids, cand)


def unit_op_counts(k: int, precision_bits: int = 8, cordic_iters: int = 24):
    """Arithmetic-op inventory of each softmax unit for one k-class
    decision (a copy of the JAX package's table): exp/LUT lookups, adds,
    multiplies/divides, compares -- the paper's circuit-size argument in
    op counts."""
    return {
        "softmax": dict(exp=k, add=k - 1, div=k, cmp=k - 1, lut=0),
        "log_softmax": dict(exp=k, add=2 * k - 1, div=0, cmp=2 * (k - 1),
                            lut=0),
        "base2_softmax": dict(exp=0, add=2 * k - 1, div=k, cmp=k - 1, lut=k,
                              shift=k),
        "pseudo_softmax": dict(exp=0, add=k - 1, div=k, cmp=k - 1, lut=k),
        "inverse_softmax": dict(exp=k, add=k, div=0, cmp=k - 1,
                                cordic_iters=cordic_iters * k),
        "reduced (ours)": dict(exp=0, add=0, div=0, cmp=k - 1, lut=0),
    }
