"""Wrapper of the CUDA top-k comparator head (``csrc/fused_topk_head.cu``).

Replaces the TPU kernel ``repro.kernels.fused_topk_head.fused_topk_head``
(Pallas, ``pallas_call`` at fused_topk_head.py:144): the top-k
``(value, index)`` pairs of ``h @ w`` with the (B, V) logits never
stored, values descending and the lower index first among equal values.

Bound on the H100: memory -- one read of the head weight, as for the
argmax head.  The design reuses the argmax head's vocabulary split: each
block keeps its range's logits in shared memory and writes a sorted
partial list of k per row; a merge kernel then reduces each row's lists
32 at a time by trees of pairwise rank merges in the order "larger
value, else lower index" (``ref.topk_merge_tree`` is its plain model),
deterministic and without atomics.  The source's header says what it
leaves for later.

``fused_topk_head.launches`` counts the calls that launched the kernel
pair.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_argmax_head import (DTYPES,
                                                   check_head_operands,
                                                   n_splits)

MAX_K = 64                  # the samplers' MAX_TOP_K
_MAX_ROWS_PER_SPLIT = 2048  # logits a block keeps in shared memory, per row
_LISTS_PER_BLOCK = 32       # lists a merge block takes (csrc: kListsPerBlock)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("fused_topk_head").repro_fused_topk_head
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_topk_head(h: torch.Tensor, w: torch.Tensor, k: int):
    """(vals (B, k) f32, idxs (B, k) int32): the top k of ``h @ w``.

    h (B, D), w (D, V) as ``check_head_operands`` takes them; 1 <= k <=
    min(64, V).  Anything else raises."""
    wt = check_head_operands(h, w)
    b, d = h.shape
    v = wt.shape[0]
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k={k}: need 1 <= k <= min({MAX_K}, V={v})")
    nsplit = max(n_splits(h.device, v), -(-v // _MAX_ROWS_PER_SPLIT))
    if nsplit > _LISTS_PER_BLOCK ** 2:
        raise ValueError(f"V={v}: {nsplit} vocabulary ranges, more than "
                         f"the merge's two stages take "
                         f"({_LISTS_PER_BLOCK ** 2})")
    n1 = -(-nsplit // _LISTS_PER_BLOCK)
    pval = torch.empty((b, nsplit, k), dtype=torch.float32, device=h.device)
    pidx = torch.empty((b, nsplit, k), dtype=torch.int32, device=h.device)
    mval = torch.empty((b, n1, k), dtype=torch.float32, device=h.device)
    midx = torch.empty((b, n1, k), dtype=torch.int32, device=h.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=h.device)
    idxs = torch.empty((b, k), dtype=torch.int32, device=h.device)
    err = _fn()(h.data_ptr(), wt.data_ptr(), pval.data_ptr(),
                pidx.data_ptr(), mval.data_ptr(), midx.data_ptr(),
                vals.data_ptr(), idxs.data_ptr(), b, d, v, k, nsplit,
                DTYPES[h.dtype],
                torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_head kernel launch failed: CUDA "
                           f"error {err}")
    fused_topk_head.launches += 1
    return vals, idxs


fused_topk_head.launches = 0
