"""SamplingParams: the typed per-request sampling surface.

A copy of ``repro.serve.params``, so requests carry the same fields in
both packages.  The port's engine serves every field but
``head_mode='sharded'``, which waits for tensor parallelism.

The engine used to take loose kwargs on ``Request`` (``top_k``,
``temperature``, ``max_new_tokens``) with the head choice fixed
engine-wide.  ``SamplingParams`` is the one frozen, hashable object a
caller attaches to a request — and the single thing
``sampler.resolve()`` consumes to pick the head variant:

  top_k == 1        greedy: the reduced comparator (argmax over h @ W,
                    no exp / sum / divide — the paper's unit).
  top_k > 1         the k-winner comparator bus + an O(k) host softmax
                    at ``temperature`` over the survivors.
  head_mode         per-request override of the engine default:
                    'reduced' | 'fused' | 'sharded' | 'softmax' |
                    'temperature' (full-vocab Gumbel-max).  None keeps
                    the engine's head.
  seed              per-request RNG stream: the nth emitted token
                    consumes the nth draw whatever the scheduling
                    (deferral, preemption), so sampled generations are
                    reproducible per request.  None derives the stream
                    from (engine seed, rid).
  stop              stop token SEQUENCES, matched host-side against the
                    generated tail at every emission (partial matches
                    span step boundaries for free); a hit finishes the
                    request with ``finish_reason='stop'``, stop tokens
                    included in the output.
  n_candidates      > 0 ships the top-n "logprob-free" candidate ids
                    from the reduced top-k kernel with every token
                    (``TokenChunk.candidate_ids``) — the comparator-bus
                    answer to logprobs: ranked alternatives, no
                    probabilities anywhere.  Sampling still draws from
                    the first ``top_k`` survivors only.
  spec_k            > 0 enables SPECULATIVE decoding: up to ``spec_k``
                    draft tokens per step (proposed by the engine's
                    Drafter) are verified in ONE forward by the reduced
                    comparator — accept draft t_i iff argmax(logits_i)
                    == t_i, Theorem 1 at K positions, zero softmax — so
                    1..spec_k+1 tokens emit per iteration, bit-identical
                    to spec_k=0.  Greedy-only (requires top_k == 1, a
                    'reduced'/'fused'/'sharded' comparator head and
                    n_candidates == 0: the
                    verification IS the comparator, and faking it under
                    the softmax baseline would poison every A/B claim).
                    Mutually exclusive with an engine's ``host_stride``
                    (enforced at ``engine.submit``, since only the
                    engine knows its stride): both amortize the same
                    per-token host round-trip, and the device loop has
                    no draft-verify group.  On a host_stride engine,
                    ``seed`` pins the per-request JAX PRNG key instead
                    of a numpy stream — still one draw per emitted
                    token, identical across strides; ``n_candidates``
                    is rejected there (the k-winner bus is consumed on
                    device).
  attn_approx       declares the approximate-attention score function
                    this request was written for ('exact' | 'base2' |
                    'pseudo' | 'pwl' | 'maxonly' — the
                    ``core.attn_approx`` catalog).  Attention mode is
                    ENGINE-wide (one fused step serves every slot), so
                    this is an assertion, not a switch: submit raises if
                    it names a different mode than the engine runs.
                    None accepts whatever the engine is configured with.
  prefix_cache      opt-out of PREFIX SHARING for this request (engines
                    with ``chunk_size`` set share whole KV blocks across
                    requests with a common prompt prefix).  False means
                    this request neither adopts cached blocks nor
                    publishes its own on completion — outputs are
                    token-identical either way (the cached blocks hold
                    bit-equal K/V); the knob exists for isolation, e.g.
                    benchmarking the cold path.

Frozen + hashable on purpose: params ride into jit-cache keys via the
resolved Sampler, and a shared default instance is safe.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

StopSpec = Union[int, Sequence[int], Sequence[Sequence[int]], None]


def _normalize_stop(stop: StopSpec) -> Tuple[Tuple[int, ...], ...]:
    """Accept an int, one sequence of ints, or a list of sequences —
    always store a tuple of non-empty int tuples."""
    if stop is None:
        return ()
    ints = (int, np.integer)           # token slices are np.int32 arrays
    if isinstance(stop, ints):
        return ((int(stop),),)
    stop = list(stop)
    if not stop:
        return ()
    if all(isinstance(t, ints) for t in stop):
        stop = [stop]
    out = []
    for s in stop:
        s = (int(s),) if isinstance(s, ints) else tuple(int(t) for t in s)
        if not s:
            raise ValueError("empty stop sequence")
        out.append(s)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (see module docstring for semantics)."""
    max_new_tokens: int = 16
    temperature: float = 1.0
    top_k: int = 1
    seed: Optional[int] = None
    stop: StopSpec = ()
    head_mode: Optional[str] = None
    n_candidates: int = 0
    spec_k: int = 0
    prefix_cache: bool = True
    attn_approx: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "stop", _normalize_stop(self.stop))
        if self.attn_approx is not None:
            from repro_torch.core.attn_approx import CATALOG
            if self.attn_approx not in CATALOG:
                raise ValueError(
                    f"attn_approx={self.attn_approx!r}: unknown score "
                    f"function (choose from {sorted(CATALOG)})")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens}: must be >= 1")
        if self.top_k < 1:
            raise ValueError(f"top_k={self.top_k}: must be >= 1 "
                             "(1 = greedy, the pure comparator)")
        if self.n_candidates < 0:
            raise ValueError(
                f"n_candidates={self.n_candidates}: must be >= 0")
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k}: must be >= 0 "
                             "(0 disables speculative decoding)")
        if self.spec_k > 0:
            # comparator-only verification is exact for GREEDY decoding;
            # anything else would silently change the sampling law (or
            # fake the softmax baseline) — reject loudly.
            if self.top_k != 1 or self.n_candidates != 0:
                raise ValueError(
                    f"spec_k={self.spec_k} requires greedy decoding: "
                    f"top_k == 1 and n_candidates == 0 (got top_k="
                    f"{self.top_k}, n_candidates={self.n_candidates})")
            if self.head_mode not in (None, "reduced", "fused", "sharded"):
                raise ValueError(
                    f"spec_k={self.spec_k} verifies through the reduced "
                    f"comparator; head_mode={self.head_mode!r} is not "
                    "supported (use 'reduced', 'fused' or 'sharded' — "
                    "running it under the softmax baseline would fake "
                    "the A/B)")

    @property
    def greedy(self) -> bool:
        """True when token choice is deterministic argmax — the case
        Theorem 1 covers bit-exactly."""
        if self.head_mode == "temperature":
            return self.temperature <= 0.0
        return self.top_k == 1 or self.temperature <= 0.0
