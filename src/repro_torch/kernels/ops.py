"""Entry points of the port's kernels, dispatched by the tensors' device.

  - CPU tensors run the plain PyTorch version (``ref``);
  - CUDA tensors launch the hand-written kernel, or the call raises --
    there is no fallback from a kernel to its plain version.

The JAX package's ``use_pallas``/``interpret`` flags have no counterpart
here: the device of the operands is the only switch.  ``attn_approx``
other than ``'exact'`` waits for a later slice and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused_argmax_head as _fah
from repro_torch.kernels import fused_topk_head as _ftk
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

ATTN_APPROX = ("exact", "base2", "pseudo", "pwl", "maxonly")


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
    with a window).  Returns q's shape and dtype."""
    if attn_approx not in ATTN_APPROX:
        raise ValueError(f"attn_approx={attn_approx!r}: unknown score "
                         f"function (choose from {sorted(ATTN_APPROX)})")
    if attn_approx != "exact":
        raise NotImplementedError(
            f"attn_approx={attn_approx!r}: the port has the exact score "
            "function only so far")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: must be >= 1 or None")
    if _device_type(q, k_pool, v_pool, block_tables, positions) == "cpu":
        return ref.paged_attention(q, k_pool, v_pool, block_tables,
                                   positions, window=window)
    return _pa.paged_attention(q, k_pool, v_pool, block_tables, positions,
                               window=window)
