"""Entry points of the port's kernels, dispatched by the tensors' device.

  - CPU tensors run the plain PyTorch version (``ref``);
  - CUDA tensors launch the hand-written kernel, or the call raises --
    there is no fallback from a kernel to its plain version;
  - ``meta`` tensors (shapes and dtypes, no memory: the dry-run's walk,
    ``launch.dryrun``) go to ``kernels.meta``, which gives the kernel's
    outputs and allocates its scratch, and runs no plain version.  Any
    other device raises.

The JAX package's ``use_pallas``/``interpret`` flags have no counterpart
here: the device of the operands is the only switch.

Gradients: ``flash_attention`` and ``softmax_xent`` carry them on both
devices (an ``autograd.Function`` on the card; plain autograd through
``ref`` on the CPU).  Every other entry's kernel has no backward, so on
the card it raises ``ValueError`` when grad is enabled and an operand
requires it -- a gradient is never dropped in silence.  The meta route
follows the card's: the same autograd, the same refusals.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attn_approx as approx
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_argmax_head as _fah
from repro_torch.kernels import fused_topk_head as _ftk
from repro_torch.kernels import fused_xent as _fx
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import online_softmax as _os
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def _device_type(*tensors: torch.Tensor) -> str:
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"operands on several devices: {sorted(types)}")
    kind = types.pop()
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"device type {kind!r}: the port runs on 'cuda', "
                         "on 'cpu' through the plain versions, or on "
                         "'meta' for the dry-run")
    return kind


def _no_grad_kernel(name: str, *tensors: torch.Tensor) -> None:
    """Refuse a kernel without a backward on operands that want one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the CUDA kernel has no backward, and an operand "
            "requires grad; detach it, or call under torch.no_grad()")


def fused_argmax_head_with_value(h: torch.Tensor, w: torch.Tensor):
    """(argmax_v(h @ w) int32, max_v f32); h (B, D), w (D, V)."""
    kind = _device_type(h, w)
    if kind == "cpu":
        return ref.fused_argmax_head_with_value(h, w)
    _no_grad_kernel("fused_argmax_head", h, w)
    if kind == "meta":
        return _meta.fused_argmax_head_with_value(h, w)
    return _fah.fused_argmax_head_with_value(h, w)


def fused_argmax_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmax_v(h @ w) -> (B,) int32.  The paper's reduced unit, fused."""
    return fused_argmax_head_with_value(h, w)[0]


def fused_topk_head(h: torch.Tensor, w: torch.Tensor, k: int):
    """Top-k (vals (B, k) f32, idxs (B, k) int32) of h @ w -- the reduced
    unit's k-winner form; values descending, lower index first on ties."""
    kind = _device_type(h, w)
    if kind == "cpu":
        return ref.fused_topk_head(h, w, k)
    _no_grad_kernel("fused_topk_head", h, w)
    if kind == "meta":
        return _meta.fused_topk_head(h, w, k)
    return _ftk.fused_topk_head(h, w, k)


def verify_draft(h: torch.Tensor, w: torch.Tensor, cand: torch.Tensor):
    """Speculative-decoding verification -- the comparator-only unit.

    h (B, T, D) hidden states at T consecutive positions; w (D, V); cand
    (B, T-1) int32 draft ids (-1 past a row's real width).  Returns (ids
    (B, T) int32, accept (B,) int32): the per-position argmax and the
    length of the accepted draft prefix -- greedy emits exactly
    ``ids[b, :accept[b] + 1]`` this step."""
    kind = _device_type(h, w, cand)
    if kind == "cpu":
        return ref.verify_draft(h, w, cand)
    _no_grad_kernel("fused_verify_head", h, w)
    if kind == "meta":
        return _meta.fused_verify_head(h, w, cand, False)
    return _fah.fused_verify_head(h, w, cand)


def verify_draft_with_value(h: torch.Tensor, w: torch.Tensor,
                            cand: torch.Tensor):
    """``verify_draft`` plus each position's max logit: (ids (B, T)
    int32, accept (B,) int32, vals (B, T) f32) -- the verify head on a
    vocabulary shard, whose (val, idx) pairs merge across ranks."""
    kind = _device_type(h, w, cand)
    if kind == "cpu":
        return ref.verify_draft_with_value(h, w, cand)
    _no_grad_kernel("fused_verify_head", h, w)
    if kind == "meta":
        return _meta.fused_verify_head(h, w, cand, True)
    return _fah.fused_verify_head(h, w, cand, with_value=True)


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
    kind = _device_type(q, k_pool, v_pool, block_tables, positions)
    if kind == "cpu":
        return ref.paged_attention(q, k_pool, v_pool, block_tables,
                                   positions, attn_approx=attn_approx,
                                   window=window)
    _no_grad_kernel("paged_attention", q, k_pool, v_pool)
    if kind == "meta":
        return _meta.paged_attention(q, k_pool, v_pool, block_tables,
                                     positions, attn_approx, window)
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
    return _FlashAttention.apply(q, k, v, causal, window)


# f32 scores a slice of the flash backward's recompute may hold (512 MB)
FLASH_BWD_SCORES = 1 << 27


def flash_attention_backward(q, k, v, g, *, causal: bool = True,
                             window: Optional[int] = None):
    """(dq, dk, dv) of ``ref.flash_attention(q, k, v)`` against its output
    gradient ``g``: the plain version recomputed under autograd, over
    slices of query rows so that no slice's (B, Hq, rows, keys) f32
    scores exceed ``FLASH_BWD_SCORES`` elements.  A slice of rows [t0,
    t1) reads only the keys it can see (up to t1 - 1 when causal, from
    t0 - window + 1 under a window); dk and dv sum in f32 over the
    slices, each gradient cast to its input's dtype at the end.  The JAX
    package has no backward kernel either: its train-mode attention is
    XLA's masked softmax, whose transpose XLA derives."""
    b, hq, t, _ = q.shape
    s = k.shape[2]
    rows = max(1, min(t, FLASH_BWD_SCORES // max(1, b * hq * s)))
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t0 in range(0, t, rows):
        t1 = min(t, t0 + rows)
        lo = 0 if window is None else max(0, t0 - window + 1)
        hi = min(s, t1) if causal else s
        if hi <= lo:                  # no visible key: out 0, grads 0
            dq[:, :, t0:t1] = 0
            continue
        qc = q[:, :, t0:t1].detach().requires_grad_(True)
        kc = k[:, :, lo:hi].detach().requires_grad_(True)
        vc = v[:, :, lo:hi].detach().requires_grad_(True)
        with torch.enable_grad():
            out = ref.flash_attention(qc, kc, vc, causal=causal,
                                      window=window, q_start=t0, k_start=lo)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             g[:, :, t0:t1])
        dq[:, :, t0:t1] = gq
        dk[:, :, lo:hi] += gk
        dv[:, :, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention on the card (and on ``meta``) with a gradient: the
    forward is the kernel, the backward ``flash_attention_backward`` --
    the plain version recomputed from the saved q, k, v, since no kernel is
    written for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "meta":
            return _meta.flash_attention(q, k, v, causal, window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, g, causal=ctx.causal,
                                          window=ctx.window), None, None)


def softmax_stats(x: torch.Tensor):
    """(max, sum exp(x - max)) per row of x (B, V), both (B,) f32 -- the
    online-softmax carry, phase 1 of the full softmax unit."""
    kind = _device_type(x)
    if kind == "cpu":
        return ref.softmax_stats(x)
    _no_grad_kernel("softmax_stats", x)
    if kind == "meta":
        return _meta.softmax_stats(x)
    return _os.softmax_stats(x)


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """The full softmax unit (the paper's baseline): stable softmax over
    the last axis, (B, V) -> (B, V) f32."""
    kind = _device_type(x)
    if kind == "cpu":
        return ref.online_softmax(x)
    _no_grad_kernel("online_softmax", x)
    if kind == "meta":
        return _meta.online_softmax(x)
    return _os.online_softmax(x)


class _SoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross-entropy; the backward recomputes the softmax
    from the saved logits (no probabilities kept from the forward), as
    ``repro.kernels.ops._xent_bwd`` does."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        kind = _device_type(logits, labels)
        if kind == "cpu":
            return ref.fused_xent(logits, labels)
        if kind == "meta":
            return _meta.fused_xent(logits, labels)
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
