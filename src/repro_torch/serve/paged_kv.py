"""Paged (block) KV cache for the serving engine, and the dense layout.

Counterpart of ``repro.serve.paged_kv``.  The paged layout: the linear
K/V of every attention-bearing layer (``attn``, and ``moe``'s attention)
lives in two shared pools ``(L, num_blocks, bs, Hkv, hd)`` in the compute
dtype, L those layers (``lm.kv_layers``; the model reads each slot of its
block program through a view, ``lm.pool_tree``: llama4's ``(attn, moe)``
unit one half of the stack each), and each slot owns a block table
mapping its view positions ``[j * bs, (j + 1) * bs)`` to pool blocks.
Blocks are allocated as a sequence grows and go back to the free list
when its request ends; decode attention reads the pools in place through the
table, over ``ceil((pos + 1) / bs)`` blocks per slot.

``BlockAllocator`` and ``PrefixTrie`` are copies of the JAX package's.
Chunked prefill allocates as it goes: admission reserves the first
chunk's cover (``can_admit(S, chunk_size)``), each later chunk extends
the table (``ensure_capacity``), and the door check
(``can_ever_admit(S, chunk_size)``) needs only the final residency.
Prefix sharing: a finished, cancelled or preempted request publishes
its full-block token runs into the trie (``release(slot,
publish_tokens=...)``) instead of freeing them, and admission maps the
longest cached run into a new slot's table (``adopt_prefix``), so
requests with a common prefix attend through the same pool blocks and
prefill only their suffix.  Every write path is copy-on-write
(``cow_for_write``, ``ensure_capacity``, ``rewind``): the pools are
written in place, so ``_cow`` copies a shared block on the card (every
layer, K and V) on the current stream, before the step that writes it
is enqueued.  Trie runs no slot maps are LRU-evicted under pressure and
count as free in every admission check.

``layout='dense'`` is the reference's byte-identity oracle: no leaf is
paged, each slot owns a ``max_len`` row of the dense leaves ``(L,
n_slots, max_len, Hkv, hd)``, a one-shot prefill's cache is copied into
it (``admit``) and the decode step writes it in place.  As in the
reference, the block accounting is then empty: nothing is allocated,
every admission and growth check passes, and there is no trie.

A config with an architecture window (every hybrid config the port
serves has one) is never paged, whatever the layout asked (reference
``paged_kv.py:282-291``): its ring buffers are
already O(window) and a recurrent layer's state O(1), so they stay dense
per slot (``lm.init_cache`` over ``n_slots`` rows: K/V rings ``(count,
n_slots, min(max_len, window), Hkv, hd)``, RG-LRU state ``(count,
n_slots, w - 1, lru)`` and ``(count, n_slots, lru)`` f32) and take the
dense layout's admission and accounting.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.weights import dtype_of


def pow2(n: int) -> int:
    """Next power of two >= n -- the ONE shape-bucketing rule shared by
    the engine's batch/row-set padding and the block-table column
    padding."""
    return 1 << (n - 1).bit_length()


def _leaves(tree) -> list:
    """A cache tree's tensors in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


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


class _TrieNode:
    __slots__ = ("key", "block", "parent", "children", "stamp")

    def __init__(self, key, block, parent):
        self.key = key              # the block's token run (len block_size)
        self.block = block
        self.parent = parent
        self.children: dict = {}
        self.stamp = 0


class PrefixTrie:
    """Full-block token-id runs -> cached pool block ids.

    Each node below the root holds ONE block keyed by its
    ``block_size``-token run; the path from the root spells the whole
    prefix, so a node's block caches the K/V of positions
    ``[depth*bs, (depth+1)*bs)`` for exactly that token prefix.  Causal
    attention makes this sound: K/V at position p is a function of
    ``tokens[:p+1]`` alone.

    The trie holds one allocator reference per node.  Eviction is LRU
    over nodes whose block the trie alone references (refcount 1); a
    slot that matched a child also references every ancestor, so
    refcount-1 nodes form whole subtrees and leaf-first eviction never
    strands a referenced child.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _TrieNode(None, None, None)
        self.nodes = 0
        self._clock = 0                 # monotonic LRU stamp source

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match_prefix(self, tokens) -> tuple:
        """Longest cached whole-block run: ``([block ids], matched_len)``.

        Capped at ``(len(tokens) - 1) // block_size`` blocks so an
        admitted request always keeps >= 1 suffix token to prefill -- the
        final chunk's head output is what emits its first token."""
        bs = self.block_size
        node, blocks = self.root, []
        stamp = self._tick()
        for d in range(max(0, (len(tokens) - 1) // bs)):
            child = node.children.get(
                tuple(int(t) for t in tokens[d * bs:(d + 1) * bs]))
            if child is None:
                break
            child.stamp = stamp
            blocks.append(child.block)
            node = child
        return blocks, len(blocks) * bs

    def publish(self, tokens, blocks) -> tuple:
        """Install a finished request's full-block run (``blocks[d]``
        covers ``tokens[d*bs:(d+1)*bs]``).  Returns ``(adopted, dupes)``:
        adopted blocks now live in new trie nodes (the caller's
        reference transfers to the trie); dupes were already cached
        under an existing node, so the caller drops its reference."""
        bs = self.block_size
        stamp = self._tick()
        node, adopted, dupes = self.root, [], []
        for d, b in enumerate(blocks):
            key = tuple(int(t) for t in tokens[d * bs:(d + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, b, node)
                node.children[key] = child
                self.nodes += 1
                adopted.append(b)
            else:
                dupes.append(b)
            child.stamp = stamp
            node = child
        return adopted, dupes

    def n_evictable(self, refcount) -> int:
        """Nodes whose block only the trie references: an exact
        reclaimable-block count (they form whole subtrees)."""
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root and refcount(node.block) == 1:
                n += 1
        return n

    def evict(self, n: int, refcount) -> List[int]:
        """Remove up to ``n`` least-recently-used refcount-1 LEAVES
        (re-scanning as parents become leaves) and return their blocks --
        never a block a slot still maps."""
        out: List[int] = []
        while len(out) < n:
            victim = None
            for node in self._leaves():
                if refcount(node.block) != 1:
                    continue
                if victim is None or node.stamp < victim.stamp:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self.nodes -= 1
            out.append(victim.block)
        return out

    def _leaves(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                if c.children:
                    stack.append(c)
                else:
                    yield c


class PagedKVStore:
    """Owns the K/V pools (paged layout) or the per-slot dense leaves
    (``layout='dense'``, and every windowed config) of the engine cache,
    the per-slot block tables and the prefix trie."""

    def __init__(self, cfg: ModelConfig, *, n_slots: int, max_len: int,
                 device, block_size: int = 16,
                 num_blocks: Optional[int] = None, layout: str = "paged"):
        if layout not in ("paged", "dense"):
            raise ValueError(f"layout={layout!r}: expected 'paged' or "
                             "'dense'")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_slot = -(-max_len // block_size)
        if num_blocks is None:
            # default: the dense layout's worst-case residency; pass fewer
            # to overcommit (the scheduler defers/preempts on empty).
            num_blocks = n_slots * self.max_blocks_per_slot
        self.pools = self.denses = self._views = None
        if self.pages(cfg, layout):
            shape = (lm.kv_layers(cfg), num_blocks, block_size,
                     cfg.n_kv_heads, cfg.head_dim)
            self.pools = {
                name: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
                for name in ("k", "v")}
        else:
            # the model's dense cache tree with one row per slot
            self.denses = lm.init_cache(cfg, n_slots, max_len, device)
        self.allocator = BlockAllocator(num_blocks)
        self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self.prefix_trie = PrefixTrie(block_size)
        self.cow_copies = 0
        self.prefix_evictions = 0

    @staticmethod
    def pages(cfg: ModelConfig, layout: str) -> bool:
        """Whether a store of ``layout`` for ``cfg`` pages its K/V: the
        paged layout of a dense-, vlm- or moe-family config with no
        architecture window (every layer's cache is then linear K/V;
        reference ``paged_kv.py:280-297`` pages every such leaf)."""
        return (layout == "paged" and cfg.family in ("dense", "vlm", "moe")
                and cfg.attention_window is None)

    @property
    def any_paged(self) -> bool:
        return self.pools is not None

    def cache(self) -> list:
        """The pools (as the model's segment / slot tree of views,
        ``lm.pool_tree``) or the dense cache tree, as the model's cache
        argument."""
        if self.any_paged:
            if self._views is None:
                self._views = lm.pool_tree(self.cfg, self.pools)
            return self._views
        return self.denses

    def usage(self) -> dict:
        """Pool occupancy snapshot (JSON-ready)."""
        a = self.allocator
        n_dense = 0 if self.any_paged else len(_leaves(self.denses))
        return {
            "layout": "paged" if self.any_paged else "dense",
            "block_size": self.block_size,
            "num_blocks": a.num_blocks,
            "blocks_free": a.n_free,
            "blocks_in_use": a.num_blocks - a.n_free,
            "paged_leaves": (len(_leaves(self.cache())) if self.any_paged
                             else 0),
            "dense_leaves": n_dense,
            "peak_in_use": a.peak_in_use,
            "shared_blocks": a.n_shared,
            "prefix_blocks": self.prefix_trie.nodes,
            "blocks_reclaimable": self.reclaimable_blocks,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
        }

    # -- block accounting ----------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` positions (0 with nothing paged)."""
        return -(-n_tokens // self.block_size) if self.any_paged else 0

    @property
    def reclaimable_blocks(self) -> int:
        """Trie-held blocks no slot maps -- evictable on demand."""
        return self.prefix_trie.n_evictable(self.allocator.refcount)

    def _effective_free(self) -> int:
        """Blocks available to a new allocation: the free list plus what
        trie eviction can reclaim, so caching a prefix never shrinks the
        pool the scheduler believes it has."""
        return self.allocator.n_free + self.reclaimable_blocks

    def _alloc(self, n: int) -> List[int]:
        """Allocate with trie reclaim: under pool pressure, LRU cached
        prefixes go back to the free list first."""
        short = n - self.allocator.n_free
        if short > 0:
            evicted = self.prefix_trie.evict(short, self.allocator.refcount)
            if evicted:
                self.prefix_evictions += len(evicted)
                self.allocator.free(evicted)
        return self.allocator.alloc(n)

    def _blocks_needed(self, prompt_len: int,
                       chunk_size: Optional[int] = None) -> int:
        """Admission cost, capped at a slot's worst case.  One-shot
        (``chunk_size=None``): the prompt's block cover plus one decode
        block, allocated up front.  Chunked: the FIRST chunk's cover
        only -- later chunks and the decode block allocate as the
        scheduler serves them."""
        if chunk_size is not None:
            return min(self.blocks_for(min(prompt_len, chunk_size)),
                       self.max_blocks_per_slot)
        return min(self.blocks_for(prompt_len) + 1, self.max_blocks_per_slot)

    def can_admit(self, prompt_len: int,
                  chunk_size: Optional[int] = None) -> bool:
        """Enough free (or reclaimable) blocks to start serving the
        prompt now."""
        if not self.any_paged:
            return True
        return self._effective_free() >= self._blocks_needed(prompt_len,
                                                             chunk_size)

    def can_ever_admit(self, prompt_len: int,
                       chunk_size: Optional[int] = None) -> bool:
        """Whether the prompt could be served with EVERY block free --
        False means the engine would MemoryError once it reaches the
        queue head; frontends reject at submit instead.  Chunked
        admission allocates as it goes, so its bound is the final
        residency, the cover of the prompt plus its first decode write
        (``blocks_for(prompt_len + 1)``)."""
        if not self.any_paged:
            return True
        if chunk_size is not None:
            return self.allocator.num_blocks >= min(
                self.blocks_for(prompt_len + 1), self.max_blocks_per_slot)
        return self.allocator.num_blocks >= self._blocks_needed(prompt_len)

    def prefill_len(self, prompt_len: int) -> int:
        """The cache length a prefill builds: paged, the block-aligned
        prompt cover, so its K/V reshapes straight into pool blocks;
        dense, the whole ``max_len`` row."""
        if not self.any_paged:
            return self.max_len
        return self.blocks_for(prompt_len) * self.block_size

    # -- slot lifecycle ------------------------------------------------------
    def alloc_blocks(self, slot: int, prompt_len: int) -> List[int]:
        """Allocate the prompt's block cover for ``slot`` ahead of a
        paged prefill (``api.serve_prefill_paged`` writes the prompt K/V
        straight into these blocks)."""
        if self.slot_blocks[slot]:
            raise ValueError(f"slot {slot} still holds blocks "
                             f"{self.slot_blocks[slot]}")
        self.slot_blocks[slot] = self._alloc(self.blocks_for(prompt_len))
        return self.slot_blocks[slot]

    def admit(self, slot: int, cache: list) -> None:
        """The dense layout's admission: copy a B = 1 prefill cache
        (``api.serve_prefill`` at ``prefill_len``) into ``slot``'s row of
        every dense leaf -- K/V, ring buffers, recurrent state --, on the
        leaves' device."""
        if self.any_paged:
            raise ValueError("admit copies into dense leaves; a paged store "
                             "admits through alloc_blocks and "
                             "api.serve_prefill_paged")
        for dense, row in zip(_leaves(self.denses), _leaves(cache)):
            dense[:, slot].copy_(row[:, 0])

    # -- copy-on-write -------------------------------------------------------
    def _cow(self, slot: int, k: int) -> None:
        """``slot`` is about to WRITE into its k-th table block; if that
        block is shared (a sibling's table or the trie also maps it),
        copy it into a fresh block -- every layer, K and V, on the card
        and on the current stream, so the copy lands before the step that
        writes the slot's new table row -- and repoint the row."""
        old = self.slot_blocks[slot][k]
        if self.allocator.refcount(old) <= 1:
            return
        new = self._alloc(1)[0]
        for pool in self.pools.values():
            pool[:, new].copy_(pool[:, old])
        self.slot_blocks[slot][k] = new
        self.allocator.free([old])
        self.cow_copies += 1

    def _cow_range(self, slot: int, start: int, end: int):
        """Table indices of ``slot``'s EXISTING blocks covering write
        positions [start, end] (inclusive)."""
        if not self.any_paged or end < start or not self.slot_blocks[slot]:
            return range(0)
        bs = self.block_size
        return range(max(start // bs, 0),
                     min(end // bs, len(self.slot_blocks[slot]) - 1) + 1)

    def cow_for_write(self, slot: int, start: int, end: int) -> None:
        """COW every shared block of ``slot`` covering write positions
        [start, end] -- the guard a write path runs before its step."""
        for k in self._cow_range(slot, start, end):
            self._cow(slot, k)

    def ensure_capacity(self, slot: int, pos: int,
                        write_start: Optional[int] = None) -> bool:
        """Make sure ``slot`` owns the block covering write index ``pos``
        and, since the caller is about to write positions [write_start,
        pos] (default: just ``pos``), that none of the covering blocks
        is shared: shared ones are copied here.  Returns False when the
        pool can't supply the growth plus the copies (the caller defers
        or preempts); never raises mid-write."""
        if not self.any_paged:
            return True
        need = pos // self.block_size + 1
        have = len(self.slot_blocks[slot])
        start = pos if write_start is None else write_start
        cow = [k for k in self._cow_range(slot, start, pos)
               if self.allocator.refcount(self.slot_blocks[slot][k]) > 1]
        if self._effective_free() < max(0, need - have) + len(cow):
            return False
        if need > have:
            self.slot_blocks[slot].extend(self._alloc(need - have))
        for k in cow:
            self._cow(slot, k)
        return True

    def can_grow(self, slot: int, pos: int,
                 write_start: Optional[int] = None) -> bool:
        """Whether ``ensure_capacity(slot, pos, write_start)`` would
        succeed right now, WITHOUT allocating -- the engine sizes a draft
        or chunk window to the free pool instead of preempting a
        neighbour."""
        if not self.any_paged:
            return True
        need = pos // self.block_size + 1
        start = pos if write_start is None else write_start
        n_cow = sum(1 for k in self._cow_range(slot, start, pos)
                    if self.allocator.refcount(self.slot_blocks[slot][k]) > 1)
        grow = max(0, need - len(self.slot_blocks[slot]))
        return self._effective_free() >= grow + n_cow

    def rewind(self, slot: int, pos: int) -> None:
        """Shrink ``slot``'s block table to the cover of write index
        ``pos`` -- the speculative-decode rewind.  The engine just moves
        the slot's position back (the ``kv_pos <= positions[b]`` masks
        hide the stale rows, and the next step overwrites them) and any
        block now wholly past the cover goes back to the free list.  The
        next write lands at ``pos``, so a covering block a sibling
        adopted meanwhile is copied here first."""
        if not self.any_paged:
            return
        keep = pos // self.block_size + 1
        extra = self.slot_blocks[slot][keep:]
        if extra:
            del self.slot_blocks[slot][keep:]
            self.allocator.free(extra)
        if self.slot_blocks[slot]:
            self._cow(slot, min(keep, len(self.slot_blocks[slot])) - 1)

    # -- prefix cache --------------------------------------------------------
    def match_prefix(self, tokens) -> tuple:
        """Longest cached whole-block run for ``tokens`` (``([], 0)`` with
        nothing paged)."""
        if not self.any_paged:
            return [], 0
        return self.prefix_trie.match_prefix(tokens)

    def adopt_prefix(self, slot: int, tokens) -> int:
        """Map the longest cached run into ``slot``'s (empty) block
        table, one more reference per block.  Returns the matched token
        count -- the suffix boundary chunked prefill starts at."""
        if self.slot_blocks[slot]:
            raise ValueError(f"slot {slot} still holds blocks "
                             f"{self.slot_blocks[slot]}")
        blocks, hit_len = self.match_prefix(tokens)
        if blocks:
            self.allocator.incref(blocks)
            self.slot_blocks[slot] = list(blocks)
        return hit_len

    def release(self, slot: int,
                publish_tokens: Optional[np.ndarray] = None) -> None:
        """Drop ``slot``'s block references.  With ``publish_tokens``
        (the token history the slot's K/V covers) the full-block prefix
        run goes into the trie instead: the slot's references transfer
        to it, and duplicates of runs already cached are dropped."""
        blocks = self.slot_blocks[slot]
        self.slot_blocks[slot] = []
        if publish_tokens is not None and self.any_paged and blocks:
            nb = min(len(publish_tokens) // self.block_size, len(blocks))
            if nb:
                _, dupes = self.prefix_trie.publish(
                    publish_tokens[:nb * self.block_size], blocks[:nb])
                self.allocator.free(dupes)
            self.allocator.free(blocks[nb:])
        else:
            self.allocator.free(blocks)

    # -- ragged batch views --------------------------------------------------
    def block_table(self, idxs, positions, *,
                    pad_pow2: bool = True) -> Optional[np.ndarray]:
        """(B, nb_max) int32 table where row r covers positions
        [0, positions[r]] for slot ``idxs[r]`` -- rows may sit at
        DIFFERENT positions (ragged fused decode); None with nothing
        paged.

        Rows shorter than the widest are padded with their own first
        block, and ``pad_pow2`` pads the column count to the next power
        of two the same way; every padded column sits past its row's
        ``positions[r]``, so the per-row kv_pos <= pos mask discards it.
        """
        if not self.any_paged:
            return None
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
