"""Paged (block) KV cache for the serving engine.

Counterpart of ``repro.serve.paged_kv`` for the paged layout: the linear
K/V of every layer lives in two shared pools ``(L, num_blocks, bs, Hkv,
hd)`` in the compute dtype, and each slot owns a block table mapping its
view positions ``[j * bs, (j + 1) * bs)`` to pool blocks.  Blocks are
allocated as a sequence grows and go back to the free list when its
request ends; decode attention reads the pools in place through the
table, over ``ceil((pos + 1) / bs)`` blocks per slot.

``BlockAllocator`` is a copy of the JAX package's refcounted allocator.
The prefix trie and copy-on-write arrive with chunked prefill.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.weights import dtype_of


def pow2(n: int) -> int:
    """Next power of two >= n -- the ONE shape-bucketing rule shared by
    the engine's batch/row-set padding and the block-table column
    padding."""
    return 1 << (n - 1).bit_length()


class BlockAllocator:
    """REFCOUNTED free-list allocator over ``num_blocks`` pool blocks.

    A block may be referenced by several owners at once, so ``free``
    decrements and a block returns to the free list only when its last
    reference drops.  ``incref`` adds a reference to an already-live
    block.

    LIFO reuse (a stack) so recently-freed blocks -- still warm in cache
    -- are handed out first.  Double-free (freeing a block whose refcount
    already reached zero) and foreign-block frees raise.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict = {}            # block id -> live reference count
        self.peak_in_use = 0            # pool high-watermark (capacity obs)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_shared(self) -> int:
        """Blocks currently referenced more than once (prefix sharing)."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: need {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        in_use = self.num_blocks - len(self._free)
        if in_use > self.peak_in_use:
            self.peak_in_use = in_use
        return out

    def incref(self, blocks) -> None:
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"incref of unallocated block {b}")
            self._ref[b] += 1

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"free of unallocated block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


class PagedKVStore:
    """Owns the K/V pools of the engine cache and the per-slot block
    tables (paged layout only)."""

    def __init__(self, cfg: ModelConfig, *, n_slots: int, max_len: int,
                 device, block_size: int = 16,
                 num_blocks: Optional[int] = None):
        if cfg.attention_window is not None:
            raise NotImplementedError(
                "sliding-window configs keep ring-buffer caches, which the "
                "port does not have yet")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_slot = -(-max_len // block_size)
        if num_blocks is None:
            # default: the dense layout's worst-case residency; pass fewer
            # to overcommit (the scheduler defers/preempts on empty).
            num_blocks = n_slots * self.max_blocks_per_slot
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        self.pools = {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
        self.allocator = BlockAllocator(num_blocks)
        self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]

    def cache(self) -> list:
        """The pools as the model's cache tree (one dense segment)."""
        return [{"slot0": {"attn": self.pools}}]

    def usage(self) -> dict:
        """Pool occupancy snapshot (JSON-ready)."""
        a = self.allocator
        return {
            "layout": "paged",
            "block_size": self.block_size,
            "num_blocks": a.num_blocks,
            "blocks_free": a.n_free,
            "blocks_in_use": a.num_blocks - a.n_free,
            "paged_leaves": len(self.pools),
            "dense_leaves": 0,
            "peak_in_use": a.peak_in_use,
            "shared_blocks": a.n_shared,
        }

    # -- block accounting ----------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def _blocks_needed(self, prompt_len: int) -> int:
        """One-shot admission cost: the prompt's block cover plus one
        decode block, capped at a slot's worst case."""
        return min(self.blocks_for(prompt_len) + 1, self.max_blocks_per_slot)

    def can_admit(self, prompt_len: int) -> bool:
        """Enough free blocks to start serving the prompt now: its full
        cover plus one decode block."""
        return self.allocator.n_free >= self._blocks_needed(prompt_len)

    def can_ever_admit(self, prompt_len: int) -> bool:
        """Whether the prompt could be served with EVERY block free --
        False means the engine would MemoryError once it reaches the
        queue head; frontends reject at submit instead."""
        return self.allocator.num_blocks >= self._blocks_needed(prompt_len)

    def prefill_len(self, prompt_len: int) -> int:
        """The block-aligned prompt cover a prefill builds, so its K/V
        reshapes straight into pool blocks."""
        return self.blocks_for(prompt_len) * self.block_size

    # -- slot lifecycle ------------------------------------------------------
    def alloc_blocks(self, slot: int, prompt_len: int) -> List[int]:
        """Allocate the prompt's block cover for ``slot`` ahead of a
        paged prefill (``api.serve_prefill_paged`` writes the prompt K/V
        straight into these blocks)."""
        if self.slot_blocks[slot]:
            raise ValueError(f"slot {slot} still holds blocks "
                             f"{self.slot_blocks[slot]}")
        self.slot_blocks[slot] = self.allocator.alloc(
            self.blocks_for(prompt_len))
        return self.slot_blocks[slot]

    def ensure_capacity(self, slot: int, pos: int,
                        write_start: Optional[int] = None) -> bool:
        """Make sure ``slot`` owns the block covering write index
        ``pos``; the caller is about to write positions [write_start,
        pos] (default: just ``pos``).  Returns False when the pool can't
        supply the growth (the caller defers or preempts); never raises
        mid-write.  ``write_start`` is the JAX signature's: there it
        names the blocks to copy on write, and the port shares no block
        yet, so only ``pos`` matters here."""
        need = pos // self.block_size + 1
        have = len(self.slot_blocks[slot])
        if need <= have:
            return True
        if self.allocator.n_free < need - have:
            return False
        self.slot_blocks[slot].extend(self.allocator.alloc(need - have))
        return True

    def can_grow(self, slot: int, pos: int,
                 write_start: Optional[int] = None) -> bool:
        """Whether ``ensure_capacity(slot, pos, write_start)`` would
        succeed right now, WITHOUT allocating -- the engine sizes a
        speculative draft window to the free pool instead of preempting
        a neighbour just to speculate."""
        grow = max(0, pos // self.block_size + 1
                   - len(self.slot_blocks[slot]))
        return self.allocator.n_free >= grow

    def rewind(self, slot: int, pos: int) -> None:
        """Shrink ``slot``'s block table to the cover of write index
        ``pos`` -- the speculative-decode rewind.  A draft window writes
        K/V up to ``pos + K``; when only part of it is accepted the
        engine just moves the slot's position back (the ``kv_pos <=
        positions[b]`` masks already hide the stale rows, and the next
        step overwrites them) and any block now wholly past the cover
        goes back to the free list."""
        keep = pos // self.block_size + 1
        extra = self.slot_blocks[slot][keep:]
        if extra:
            del self.slot_blocks[slot][keep:]
            self.allocator.free(extra)

    def release(self, slot: int) -> None:
        """Drop ``slot``'s block references (back to the free list)."""
        blocks = self.slot_blocks[slot]
        self.slot_blocks[slot] = []
        self.allocator.free(blocks)

    # -- ragged batch views --------------------------------------------------
    def block_table(self, idxs, positions, *,
                    pad_pow2: bool = True) -> np.ndarray:
        """(B, nb_max) int32 table where row r covers positions
        [0, positions[r]] for slot ``idxs[r]`` -- rows may sit at
        DIFFERENT positions (ragged fused decode).

        Rows shorter than the widest are padded with their own first
        block, and ``pad_pow2`` pads the column count to the next power
        of two the same way; every padded column sits past its row's
        ``positions[r]``, so the per-row kv_pos <= pos mask discards it.
        """
        positions = np.broadcast_to(
            np.asarray(positions, np.int64).reshape(-1), (len(idxs),))
        nbs = positions // self.block_size + 1
        nb_max = int(nbs.max())
        if pad_pow2:
            nb_max = pow2(nb_max)
        rows = []
        for i, nb_i in zip(idxs, nbs):
            own = self.slot_blocks[i][:int(nb_i)]
            if len(own) < nb_i:
                raise ValueError(f"slot {i} owns {len(own)} blocks; position "
                                 f"{int(nb_i * self.block_size - 1)} needs "
                                 f"{int(nb_i)}")
            rows.append(own + [own[0]] * (nb_max - len(own)))
        return np.asarray(rows, np.int32)
