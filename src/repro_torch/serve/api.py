"""The public serving facade: ``LLM.generate()`` / ``LLM.stream()``.

Counterpart of ``repro.serve.api`` over the port's engine.  Entry points
run on the card: ``LLM.from_arch`` builds on ``device="cuda"`` unless the
caller passes ``device="cpu"`` (the plain kernel versions), and raises
when CUDA is absent.

The facade over the continuous-batching engine, for callers who want an
inference API rather than an engine loop:

  llm = LLM.from_arch("qwen3-0.6b", smoke=True)          # on the card
  outs = llm.generate(prompts, SamplingParams(max_new_tokens=16))
  for chunk in llm.stream(prompt, SamplingParams(stop=[(7, 9)])):
      ...                     # TokenChunk per token, incrementally

``generate`` is batched and order-preserving: all prompts are submitted
up front so the engine's continuous batching (paged KV, ONE fused
ragged decode step per iteration, mixed per-request heads) serves them
concurrently; outputs come back in prompt order with per-request timing.

``stream`` submits eagerly and yields ``TokenChunk``s as the engine
emits them — the first chunk arrives while the request (and any other
in-flight traffic) is still running, and pumping the shared engine
between yields advances EVERY in-flight request, so concurrent streams
and batch calls interleave correctly.

Threading: all engine access is serialized through one lock.  A
background pump (``start_pump``) steps the engine whenever work is
pending — the mode the HTTP server runs in, where handler threads only
submit and read per-request queues; without a pump, ``generate`` and
``stream`` drive the engine inline from the calling thread.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.outputs import RequestOutput, TokenChunk
from repro_torch.serve.params import SamplingParams

PromptLike = Union[Sequence[int], np.ndarray]


def _is_single_prompt(prompts) -> bool:
    """True for one token-id sequence (vs a list of them).  Callers
    materialize generators first — this must not consume its input."""
    if isinstance(prompts, np.ndarray):
        return prompts.ndim == 1
    return bool(prompts) and isinstance(prompts[0], (int, np.integer))


class LLM:
    """Facade over ``ServeEngine``: typed params in, typed outputs out.

    Constructor kwargs mirror the engine's (n_slots, max_len, eos_id,
    head_mode, block_size, num_blocks, seed, drafter, ...); ``head_mode``
    is the default head — each request's ``SamplingParams.head_mode`` can
    override it, and ``drafter`` proposes the drafts of speculative
    requests (``SamplingParams(spec_k=K)``; prompt lookup by default).
    Streamed chunks carry ``candidate_ids`` when a request sets
    ``n_candidates``, and ``stats`` the speculation counters (drafted,
    accepted, acceptance_rate).  ``params`` may be float32 master weights; the engine
    casts them to the config's dtype once, on the device they live on.
    """

    def __init__(self, params, cfg, **engine_kwargs):
        self.engine = ServeEngine(params, cfg, **engine_kwargs)
        # the engine may have resolved mode kwargs (attn_approx/
        # attn_window) into a replaced cfg — mirror ITS view
        self.cfg = self.engine.cfg
        self._lock = threading.RLock()
        self._rids = itertools.count()
        self._queues: dict = {}            # rid -> per-stream chunk queue
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        self._pump_error: Optional[BaseException] = None
        self.engine.add_consumer(self._on_chunk)

    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True, seed: int = 0,
                  device="cuda", **engine_kwargs) -> "LLM":
        """Build params + config for a zoo arch and wrap them.  Weights
        come from a ``torch.Generator`` seeded with ``seed`` on
        ``device``; ``smoke=True`` is the tiny config of the same
        family."""
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.weights import init_params

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port's entry points run on the "
                "card (pass device='cpu' to run the plain kernel versions)")
        cfg = get_config(arch)
        if smoke:
            cfg = smoke_config(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cls(init_params(cfg, gen, device), cfg, seed=seed,
                   **engine_kwargs)

    # -- engine event plumbing ----------------------------------------------
    def _on_chunk(self, chunk: TokenChunk) -> None:
        q = self._queues.get(chunk.rid)
        if q is not None:
            q.put(chunk)

    @property
    def _pumping(self) -> bool:
        t = self._pump_thread
        return t is not None and t.is_alive()

    def start_pump(self, idle_wait: float = 0.005) -> None:
        """Run the engine from a background thread: step whenever work
        is pending, nap when idle.  The HTTP server's mode — handler
        threads submit and read queues; nobody steps inline."""
        if self._pumping:
            return
        self._pump_stop.clear()
        self._pump_error = None        # a fresh pump starts healthy

        def loop():
            while not self._pump_stop.is_set():
                try:
                    with self._lock:
                        busy = self.engine.has_work
                        if busy:
                            self.engine.step()
                except BaseException as e:   # surfaced by waiters, not lost
                    self._pump_error = e
                    return
                if not busy:
                    self._pump_stop.wait(idle_wait)

        self._pump_thread = threading.Thread(
            target=loop, name="llm-engine-pump", daemon=True)
        self._pump_thread.start()

    def stop_pump(self) -> None:
        if self._pump_thread is None:
            return
        self._pump_stop.set()
        self._pump_thread.join()
        self._pump_thread = None

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None) -> Request:
        """Queue one prompt; returns the live engine Request (rids are
        assigned by the facade).  Most callers want generate/stream."""
        params = params if params is not None else SamplingParams()
        with self._lock:
            prompt = np.asarray(prompt, np.int32).copy()
            # out-of-range ids would index past the embedding; the
            # frontend rejects them loudly instead
            if prompt.size and (int(prompt.min()) < 0
                                or int(prompt.max()) >= self.cfg.vocab_size):
                raise ValueError(
                    f"prompt token ids must be in [0, "
                    f"{self.cfg.vocab_size}); got "
                    f"[{int(prompt.min())}, {int(prompt.max())}]")
            # a prompt the pool could never cover would reach the queue
            # head and MemoryError the engine (killing a background
            # pump); a long-lived frontend rejects it at submit instead.
            if not self.engine.store.can_ever_admit(len(prompt)):
                store = self.engine.store
                raise ValueError(
                    f"prompt of {len(prompt)} tokens can never be "
                    f"admitted: KV pool is {store.allocator.num_blocks} "
                    f"x {store.block_size}-token blocks")
            req = Request(next(self._rids), prompt, params=params)
            self.engine.submit(req)
            return req

    def _drive_until(self, pred) -> None:
        """Advance the engine until ``pred()``: inline steps when no
        background pump is running, otherwise just wait on it."""
        while not pred():
            if self._pump_error is not None:
                raise RuntimeError(
                    "engine pump thread died") from self._pump_error
            if self._pumping:
                time.sleep(0.001)
                continue
            with self._lock:
                if pred():
                    return
                if not self.engine.has_work:
                    raise RuntimeError(
                        "engine idle with unfinished requests — a "
                        "request was lost (bug) or never submitted")
                self.engine.step()

    # -- the facade ----------------------------------------------------------
    def generate(self, prompts,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
                 sessions=None) -> List[RequestOutput]:
        """Serve prompt(s) to completion; outputs in prompt order.

        ``prompts``: one token-id sequence or a list of them.
        ``params``: one SamplingParams for all, or one per prompt.
        ``sessions``: accepted for API parity with the JAX package's
        ``Router.generate`` (a single engine has nowhere to route, so
        it's a no-op).
        """
        if not isinstance(prompts, np.ndarray):
            prompts = list(prompts)           # materialize generators once
        if _is_single_prompt(prompts):
            prompts = [prompts]
        prompts = list(prompts)
        if params is None or isinstance(params, SamplingParams):
            plist = [params] * len(prompts)
        else:
            plist = list(params)
            if len(plist) != len(prompts):
                raise ValueError(f"{len(plist)} SamplingParams for "
                                 f"{len(prompts)} prompts")
        reqs = [self.submit(p, sp) for p, sp in zip(prompts, plist)]
        self._drive_until(lambda: all(r.done for r in reqs))
        return [RequestOutput.from_request(r) for r in reqs]

    def stream(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               session: Optional[str] = None) -> Iterator[TokenChunk]:
        """Submit one prompt (eagerly) and yield its tokens as emitted.
        ``session`` is accepted for API parity with the JAX package's
        ``Router.stream`` (single engine — nothing to route).

        The final chunk carries ``finish_reason``.  Between yields the
        engine keeps serving every other in-flight request — inline
        steps advance the whole batch, and under a background pump the
        iterator only reads its queue.
        """
        q: "queue.SimpleQueue[TokenChunk]" = queue.SimpleQueue()
        with self._lock:
            req = self.submit(prompt, params)
            self._queues[req.rid] = q
        return self._stream_iter(req, q)

    def _stream_iter(self, req: Request,
                     q: "queue.SimpleQueue") -> Iterator[TokenChunk]:
        try:
            while True:
                try:
                    chunk = q.get_nowait()
                except queue.Empty:
                    if self._pump_error is not None:
                        raise RuntimeError(
                            "engine pump thread died") from self._pump_error
                    if self._pumping:
                        try:
                            chunk = q.get(timeout=0.05)
                        except queue.Empty:
                            continue
                    else:
                        with self._lock:
                            if not q.empty():
                                continue
                            if not self.engine.has_work:
                                raise RuntimeError(
                                    f"stream rid={req.rid}: engine idle "
                                    "before the final chunk (bug)")
                            self.engine.step()
                        continue
                yield chunk
                if chunk.finish_reason is not None:
                    return
        finally:
            self._queues.pop(req.rid, None)
            # iterator abandoned mid-generation (client disconnect,
            # early break): cancel so the engine stops decoding tokens
            # nobody will read and the slot's blocks go back to the pool
            if not req.done:
                with self._lock:
                    self.engine.cancel(req)

    # -- introspection -------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Engine counters plus scheduler state: the raw ``engine.stats``
        dict extended with queue depth, active slots and TTFT
        percentiles (``engine.snapshot()``) — what GET /v1/stats serves."""
        return self.engine.snapshot()

    def kv_usage(self) -> dict:
        return self.engine.store.usage()

    def health(self) -> dict:
        """Liveness payload for GET /healthz — the single-engine form of
        the surface ``serve.router.Router.health`` provides for a fleet
        (the HTTP handler consumes either, duck-typed)."""
        err = self._pump_error
        if err is not None:
            return {"ok": False, "error": f"engine pump died: {err}"}
        return {"ok": True, "pumping": self._pumping,
                "has_work": self.engine.has_work}
