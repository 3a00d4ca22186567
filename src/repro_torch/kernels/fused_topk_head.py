"""Wrapper of the CUDA top-k comparator head (``csrc/fused_topk_head.cu``).

Replaces the TPU kernel ``repro.kernels.fused_topk_head.fused_topk_head``
(Pallas, ``pallas_call`` at fused_topk_head.py:144): the top-k
``(value, index)`` pairs of ``h @ w`` with the (B, V) logits never
stored, values descending and the lower index first among equal values.

Bound on the H100: memory -- one read of the head weight, as for the
argmax head.  The design splits the vocabulary into a few ranges per SM
(``fused_argmax_head.vocab_splits``, the argmax head's f32 split) with BT
rows of h staged in shared memory (``topk_plan``: the largest BT of {8,
4, 2, 1} up to B that fits the card's shared memory -- 2 at D 18432,
where B 8 reads W four times); each block keeps its range's logits in
shared memory and writes a sorted partial list of k per row; a merge
kernel then reduces each row's lists 32 at a time by trees of pairwise
rank merges in the order "larger value, else lower index"
(``ref.topk_merge_tree`` is its plain model), deterministic and without
atomics.  The source's header says what it leaves for later.

``fused_topk_head.launches`` counts the calls that launched the kernel
pair.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_argmax_head import (DTYPES, H100_SMEM_OPTIN,
                                                   H100_SMS, HeadPlan,
                                                   check_head_operands,
                                                   device_limits,
                                                   pick_row_block,
                                                   staged_bytes,
                                                   vocab_splits)

MAX_K = 64                  # the samplers' MAX_TOP_K
_MAX_ROWS_PER_SPLIT = 2048  # logits a block keeps in shared memory, per row
_LISTS_PER_BLOCK = 32       # lists a merge block takes (csrc: kListsPerBlock)


def topk_plan(b: int, d: int, v: int, dtype: torch.dtype,
              sm_count: int = H100_SMS,
              smem_limit: int = H100_SMEM_OPTIN) -> HeadPlan:
    """Pass 1 of the top-k head for B rows of width D over V ids: the
    argmax head's f32 vocabulary split, widened so that no range holds
    more than 2,048 ids; BT rows per block by ``pick_row_block``, each
    block's shared memory the staged rows plus BT rows of its range's
    logits.  Raises past the merge's two stages (1,024 ranges)."""
    nsplit = max(vocab_splits(v, sm_count), -(-v // _MAX_ROWS_PER_SPLIT))
    if nsplit > _LISTS_PER_BLOCK ** 2:
        raise ValueError(f"V={v}: {nsplit} vocabulary ranges, more than "
                         f"the merge's two stages take "
                         f"({_LISTS_PER_BLOCK ** 2})")
    per = -(-v // nsplit)
    esize = torch.finfo(dtype).bits // 8

    def smem(bt):
        return staged_bytes(d, bt, esize) + bt * per * 4

    bt = pick_row_block(b, smem, smem_limit)
    return HeadPlan("cuda-core", nsplit, per, bt, -(-b // bt), smem(bt))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("fused_topk_head").repro_fused_topk_head
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
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
    plan = topk_plan(b, d, v, h.dtype, *device_limits(h.device.index))
    nsplit = plan.nsplit
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
                plan.row_block, DTYPES[h.dtype],
                torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_head kernel launch failed: CUDA "
                           f"error {err}")
    fused_topk_head.launches += 1
    return vals, idxs


fused_topk_head.launches = 0
