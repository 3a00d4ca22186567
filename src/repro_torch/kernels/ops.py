"""Entry points of the port's kernels, dispatched by the tensors' device.

  - CPU tensors run the plain PyTorch version (``ref``);
  - CUDA tensors launch the hand-written kernel, or the call raises --
    there is no fallback from a kernel to its plain version.

The JAX package's ``use_pallas``/``interpret`` flags have no counterpart
here: the device of the operands is the only switch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attn_approx as approx
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_argmax_head as _fah
from repro_torch.kernels import fused_topk_head as _ftk
from repro_torch.kernels import fused_xent as _fx
from repro_torch.kernels import online_softmax as _os
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def _device_type(*tensors: torch.Tensor) -> str:
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"operands on several devices: {sorted(types)}")
    kind = types.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"device type {kind!r}: the port runs on 'cuda', "
                         "or 'cpu' through the plain versions")
    return kind


def fused_argmax_head_with_value(h: torch.Tensor, w: torch.Tensor):
    """(argmax_v(h @ w) int32, max_v f32); h (B, D), w (D, V)."""
    if _device_type(h, w) == "cpu":
        return ref.fused_argmax_head_with_value(h, w)
    return _fah.fused_argmax_head_with_value(h, w)


def fused_argmax_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmax_v(h @ w) -> (B,) int32.  The paper's reduced unit, fused."""
    return fused_argmax_head_with_value(h, w)[0]


def fused_topk_head(h: torch.Tensor, w: torch.Tensor, k: int):
    """Top-k (vals (B, k) f32, idxs (B, k) int32) of h @ w -- the reduced
    unit's k-winner form; values descending, lower index first on ties."""
    if _device_type(h, w) == "cpu":
        return ref.fused_topk_head(h, w, k)
    return _ftk.fused_topk_head(h, w, k)


def verify_draft(h: torch.Tensor, w: torch.Tensor, cand: torch.Tensor):
    """Speculative-decoding verification -- the comparator-only unit.

    h (B, T, D) hidden states at T consecutive positions; w (D, V); cand
    (B, T-1) int32 draft ids (-1 past a row's real width).  Returns (ids
    (B, T) int32, accept (B,) int32): the per-position argmax and the
    length of the accepted draft prefix -- greedy emits exactly
    ``ids[b, :accept[b] + 1]`` this step."""
    if _device_type(h, w, cand) == "cpu":
        return ref.verify_draft(h, w, cand)
    return _fah.fused_verify_head(h, w, cand)


def paged_attention(q, k_pool, v_pool, block_tables, positions, *,
                    attn_approx: str = "exact",
                    window: Optional[int] = None):
    """Ragged decode attention straight off a block-paged KV pool.

    q (B, Hq, hd) or (B, T, Hq, hd); pools (num_blocks, bs, Hkv, hd);
    block_tables (B, nb) int32; positions (B,) or (B, T) int32 -- each
    query attends over kv positions <= its own (and > position - window
    with a window).  ``attn_approx`` is the score function, one of
    ``core.attn_approx.VARIANTS``.  Returns q's shape and dtype."""
    attn_approx, window = approx.resolve(attn_approx, window)
    if _device_type(q, k_pool, v_pool, block_tables, positions) == "cpu":
        return ref.paged_attention(q, k_pool, v_pool, block_tables,
                                   positions, attn_approx=attn_approx,
                                   window=window)
    return _pa.paged_attention(q, k_pool, v_pool, block_tables, positions,
                               attn_approx=attn_approx, window=window)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Attention of T queries over S keys with the scores never stored.

    q (B, Hq, T, hd); k, v (B, Hkv, S, hd), GQA when Hkv < Hq (query head
    h reads kv head h // (Hq / Hkv)).  Query and key indices both count
    from 0: ``causal`` keeps keys <= the query's index, ``window`` keys >
    index - window.  A query with no visible key gives 0.  Returns
    (B, Hq, T, hd) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window={window}: must be >= 1 or None")
    if _device_type(q, k, v) == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def softmax_stats(x: torch.Tensor):
    """(max, sum exp(x - max)) per row of x (B, V), both (B,) f32 -- the
    online-softmax carry, phase 1 of the full softmax unit."""
    if _device_type(x) == "cpu":
        return ref.softmax_stats(x)
    return _os.softmax_stats(x)


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """The full softmax unit (the paper's baseline): stable softmax over
    the last axis, (B, V) -> (B, V) f32."""
    if _device_type(x) == "cpu":
        return ref.online_softmax(x)
    return _os.online_softmax(x)


class _SoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross-entropy; the backward recomputes the softmax
    from the saved logits (no probabilities kept from the forward), as
    ``repro.kernels.ops._xent_bwd`` does."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if _device_type(logits, labels) == "cpu":
            return ref.fused_xent(logits, labels)
        return _fx.fused_xent(logits, labels)

    @staticmethod
    def backward(ctx, g):
        """``(softmax(logits) - onehot(labels)) * g`` in the logits' dtype,
        computed in place on the fresh f32 probabilities: subtracting 1 at
        each row's label column and scaling rounds exactly as the
        reference's one-hot product does, with no (B, V) one-hot or
        second f32 (B, V) tensor made."""
        logits, labels = ctx.saved_tensors
        p = online_softmax(logits)
        p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1
        p.mul_(g[:, None])
        return p.to(logits.dtype), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy ``logsumexp(x) - x[label]``, (B, V),
    (B,) int -> (B,) f32, the probabilities never stored in the forward.
    Differentiable in ``logits`` (not in ``labels``): the gradient is
    ``(softmax(logits) - onehot(labels)) * g`` in the logits' dtype, its
    softmax through ``online_softmax`` -- the kernel on the card.
    Labels must lie in [0, V)."""
    return _SoftmaxXent.apply(logits, labels)
