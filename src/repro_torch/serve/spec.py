"""Speculative decoding on the reduced comparator: drafters.

A copy of ``repro.serve.spec``.  Greedy speculative verification is
Theorem 1 repeated at K draft positions: accept draft token t_i iff
``argmax(logits_i) == t_i``.  So the whole verification unit is the
reduced comparator bank (``kernels.ops.verify_draft``: the CUDA verify
head on the card, its plain version on the CPU) -- zero softmax
evaluations -- and the engine emits 1..K+1 tokens per fused iteration
instead of one, identical to non-speculative greedy decoding by
construction.

This module holds the HOST side of the subsystem:

  Drafter             the protocol: ``propose(history, k) -> draft ids``
                      (history = prompt + tokens generated so far).
                      Proposals must be deterministic in ``history`` --
                      the engine re-proposes after preemption/re-prefill
                      and the generated tokens must not change.
  PromptLookupDrafter model-free n-gram drafter (prompt lookup): find the
                      most recent earlier occurrence of the sequence's
                      trailing n-gram and propose the tokens that
                      followed it.  Free to compute, and effective on
                      repetitive text (code, structured data, extraction)
                      and on greedy decode loops.

The engine side (multi-token fused step, KV rewind, multi-emission) is
in ``serve/engine.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Drafter(Protocol):
    """Proposes draft tokens for the comparator verification unit."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft token ids continuing ``history`` (prompt +
        generated so far, oldest first).  May return fewer — including
        none — when it has no confident continuation; every returned
        draft costs one verified position in the fused step, so drafters
        should propose only what they believe in.  MUST be a pure
        function of ``history`` (re-proposal after preemption happens)."""
        ...


@dataclasses.dataclass(frozen=True)
class PromptLookupDrafter:
    """Model-free n-gram drafter over the sequence's own history.

    Scans for a PREVIOUS occurrence of the trailing ``ngram`` tokens
    (falling back to shorter n-grams down to ``min_ngram``) and proposes
    the tokens that followed that occurrence — the continuation the
    sequence itself already wrote once.  Among matches the most RECENT
    one with a full ``k``-token continuation wins (recent repetition
    predicts the near future best); when every recent match is truncated
    by the end of history (tight periodic loops, where the nearest match
    overlaps the tail) the longest available continuation wins instead,
    so repeated runs still draft whole windows.  No second model, no
    extra forward passes, no state: drafting cost is an
    O(len(history) * ngram) host scan per step.

    ``max_match_len`` bounds the proposal independently of the caller's
    ``k`` (the engine passes k = the request's remaining spec budget).
    """
    ngram: int = 3
    min_ngram: int = 1
    max_match_len: int = 64

    def __post_init__(self):
        if not 1 <= self.min_ngram <= self.ngram:
            raise ValueError(
                f"need 1 <= min_ngram ({self.min_ngram}) <= ngram "
                f"({self.ngram})")
        if self.max_match_len < 1:
            raise ValueError(f"max_match_len={self.max_match_len}: "
                             "must be >= 1")

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        n_hist = len(hist)
        k = min(k, self.max_match_len)
        if k < 1:
            return []
        for n in range(min(self.ngram, n_hist - 1), self.min_ngram - 1, -1):
            tail = hist[n_hist - n:]
            best: List[int] = []
            for start in range(n_hist - n - 1, -1, -1):
                if hist[start:start + n] == tail:
                    cont = hist[start + n:start + n + k]
                    if len(cont) > len(best):
                        best = cont
                    if len(best) >= k:      # most recent FULL window wins
                        break
            if best:
                return [int(t) for t in best]
        return []
