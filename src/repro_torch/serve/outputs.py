"""Typed serving outputs: per-token chunks and finished-request records.

``TokenChunk`` is the unit of the event-driven engine lifecycle: every
token the engine emits — from the prefill head or a fused decode step —
is delivered to registered consumers as one chunk, with
``finish_reason`` set on the final chunk of a request.  ``candidate_ids``
carries the top-n "logprob-free" alternatives off the reduced top-k
comparator bus when ``SamplingParams.n_candidates > 0``.

``RequestOutput`` is the completed-request record ``LLM.generate``
returns: token ids, why generation stopped ('eos' | 'length' |
'max_len' | 'stop'), and wall-clock timing (queued / prefill / decode
ms, time-to-first-token, tok/s) stamped by the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.serve.params import SamplingParams


@dataclasses.dataclass(frozen=True)
class TokenChunk:
    """One emitted token of one request."""
    rid: int
    token: int
    index: int                              # nth generated token, 0-based
    finish_reason: Optional[str] = None     # set on the request's final chunk
    candidate_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Wall-clock phases of one request (milliseconds).

    queued_ms   submit -> first prefill start (time spent in the FIFO,
                including any deferral; preemption does NOT reset it)
    prefill_ms  prefill start -> first token emitted (TTFT - queued)
    decode_ms   first token -> final token
    ttft_ms     submit -> first token (queued + prefill)
    total_ms    submit -> final token
    tok_s       generated tokens / (total_ms / 1e3)
    """
    queued_ms: float
    prefill_ms: float
    decode_ms: float
    ttft_ms: float
    total_ms: float
    tok_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """A finished request, as returned by ``LLM.generate``."""
    rid: int
    prompt_token_ids: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finish_reason: str
    params: SamplingParams
    timing: RequestTiming

    @classmethod
    def from_request(cls, req) -> "RequestOutput":
        """Build from a finished engine ``Request`` (duck-typed so this
        module never imports the engine)."""
        if not req.done:
            raise ValueError(f"request rid={req.rid} is not finished "
                             f"(finish_reason={req.finish_reason!r})")
        n = len(req.generated)
        total_s = max(req.t_done - req.t_submit, 1e-9)
        timing = RequestTiming(
            queued_ms=(req.t_admit - req.t_submit) * 1e3,
            prefill_ms=(req.t_first - req.t_admit) * 1e3,
            decode_ms=(req.t_done - req.t_first) * 1e3,
            ttft_ms=(req.t_first - req.t_submit) * 1e3,
            total_ms=total_s * 1e3,
            tok_s=n / total_s,
        )
        # preemption folds generated tokens into req.prompt for the
        # re-prefill; orig_prompt (stamped at submit) is the user's.
        prompt = getattr(req, "orig_prompt", None)
        prompt = req.prompt if prompt is None else prompt
        return cls(rid=req.rid,
                   prompt_token_ids=tuple(int(t) for t in prompt),
                   token_ids=tuple(int(t) for t in req.generated),
                   finish_reason=req.finish_reason,
                   params=req.params,
                   timing=timing)

    def as_dict(self) -> dict:
        """JSON-ready form (the HTTP server's non-streamed response)."""
        return {
            "rid": self.rid,
            "token_ids": list(self.token_ids),
            "finish_reason": self.finish_reason,
            "num_prompt_tokens": len(self.prompt_token_ids),
            "timing": self.timing.as_dict(),
        }
