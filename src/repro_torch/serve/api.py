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

Under tensor parallelism the pump runs on rank 0 (``leader``) and every
other rank of the group runs ``follow``.  Each tick of rank 0's pump
broadcasts one control message over the group's control plane --
``"step"``, ``"idle"`` or ``"stop"`` --, and a follower steps its
engine when told to step and returns when told to stop; the step's own
broadcast (``ServeEngine._sync``) carries the new requests.  An idle
pump still sends ``"idle"`` every quarter of the group's timeout, so a
follower waiting on the next message never reaches that timeout while
rank 0 lives, and does within it once rank 0 is gone.
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


def check_prompt(engine: ServeEngine, prompt: PromptLike) -> np.ndarray:
    """The prompt as an int32 copy, or ``ValueError`` for one the engine
    must never see: ids outside the vocabulary (they would index past
    the embedding), or a prompt the pool could never cover (it would
    reach the queue head and MemoryError the engine, killing a
    background pump).  The pool bound is chunk-aware: chunked admission
    allocates as it goes, so only the final residency must fit."""
    prompt = np.asarray(prompt, np.int32).copy()
    vocab = engine.cfg.vocab_size
    if prompt.size and (int(prompt.min()) < 0 or int(prompt.max()) >= vocab):
        raise ValueError(
            f"prompt token ids must be in [0, {vocab}); got "
            f"[{int(prompt.min())}, {int(prompt.max())}]")
    if not engine.store.can_ever_admit(len(prompt), engine.chunk_size):
        store = engine.store
        raise ValueError(
            f"prompt of {len(prompt)} tokens can never be admitted: KV pool "
            f"is {store.allocator.num_blocks} x {store.block_size}-token "
            "blocks"
            + ("" if engine.chunk_size is not None else
               " (one-shot admission; a chunk_size= engine admits up to "
               "one block more)"))
    return prompt


class LLM:
    """Facade over ``ServeEngine``: typed params in, typed outputs out.

    Constructor kwargs mirror the engine's (n_slots, max_len, eos_id,
    head_mode, kv_layout, block_size, num_blocks, prefill_per_step,
    scheduler, chunk_size, token_budget, host_stride, prefix_cache, seed,
    drafter, tp, group, ...); under ``tp`` every rank builds this facade
    and makes the same calls (SPMD, ``ServeEngine``'s docstring): rank 0's
    requests are served and every rank returns the same outputs;
    ``head_mode``
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
        self._wake = threading.Event()     # a submission for the pump
        self.engine.add_consumer(self._on_chunk)

    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True, seed: int = 0,
                  device="cuda", tp: Optional[int] = None,
                  dtype: Optional[str] = None,
                  **engine_kwargs) -> "LLM":
        """Build params + config for a zoo arch and wrap them.  Weights
        are ``weights.seeded_params(cfg, seed, ...)``: drawn leaf by leaf
        on the host from ``seed`` and moved to ``device``, so one seed
        gives one tree on the CPU and on the card, whatever ``tp`` or the
        head mode.  ``smoke=True`` is the tiny config of the same family;
        ``dtype`` (``"float32"`` / ``"bfloat16"``) replaces the config's
        compute dtype.

        Without ``tp`` the tree is drawn in the compute dtype
        (``seeded_params(dtype=...)``: each chunk cast on the host as it
        is drawn, the same bits as casting the f32 masters), since the
        engine serves the cast tree and keeps no master: internvl2-26b's
        f32 masters (79.45 GB) and their cast would not fit one card.
        With ``tp`` > 1 (one process per rank, the group torchrun
        describes, ``comm.Group.from_env``) the f32 tree stays on the host
        and the engine keeps the rank's slice of it, so no rank holds the
        whole tree on the card."""
        import dataclasses

        from repro_torch.configs import get_config, smoke_config
        from repro_torch.parallel import comm
        from repro_torch.weights import dtype_of, seeded_params

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port's entry points run on the "
                "card (pass device='cpu' to run the plain kernel versions)")
        cfg = get_config(arch)
        if smoke:
            cfg = smoke_config(cfg)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        group = None
        if tp is not None and tp > 1:
            group = comm.Group.from_env(device=device)
        if group is None:
            params = seeded_params(cfg, seed, device, dtype=dtype_of(cfg))
        else:
            params = seeded_params(cfg, seed, torch.device("cpu"))
        return cls(params, cfg, seed=seed, tp=tp, group=group,
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

    @property
    def leader(self) -> bool:
        """Whether this process runs the pump: always, but on a rank of
        several only rank 0 (the others ``follow``)."""
        return not self.engine._spmd or self.engine.group.rank == 0

    def start_pump(self, idle_wait: float = 0.005) -> None:
        """Run the engine from a background thread: step whenever work
        is pending, nap when idle.  The HTTP server's mode — handler
        threads submit and read queues; nobody steps inline.  On a rank
        of several, rank 0's pump also tells the other ranks each tick
        (the module docstring); they run ``follow``."""
        if self._pumping:
            return
        if not self.leader:
            raise RuntimeError(
                f"rank {self.engine.group.rank} of a tp group steps when "
                "rank 0's pump says: call follow(), not start_pump()")
        self._pump_stop.clear()
        self._pump_error = None        # a fresh pump starts healthy
        group = self.engine.group if self.engine._spmd else None

        def loop():
            beat = None if group is None else group.timeout_s / 4
            last = time.monotonic()
            while not self._pump_stop.is_set():
                try:
                    with self._lock:
                        busy = self.engine.has_work
                        if group is not None and (
                                busy or time.monotonic() - last >= beat):
                            group.broadcast_object("step" if busy
                                                   else "idle")
                            last = time.monotonic()
                        if busy:
                            self.engine.step()
                except BaseException as e:   # surfaced by waiters, not lost
                    self._pump_error = e
                    return
                if busy:
                    continue
                if group is None:
                    self._pump_stop.wait(idle_wait)
                else:
                    # woken by a submission or stop_pump, else at the beat
                    self._wake.wait(max(0.0, beat - (time.monotonic()
                                                     - last)))
                    self._wake.clear()
            if group is not None:
                try:
                    with self._lock:
                        group.broadcast_object("stop")
                except BaseException as e:
                    self._pump_error = e

        self._pump_thread = threading.Thread(
            target=loop, name="llm-engine-pump", daemon=True)
        self._pump_thread.start()

    def stop_pump(self) -> None:
        """Stop the pump; on a rank of several its last message tells
        the followers to return."""
        if self._pump_thread is None:
            return
        self._pump_stop.set()
        self._wake.set()
        self._pump_thread.join()
        self._pump_thread = None

    def follow(self) -> None:
        """A rank other than 0 of a tp group, while rank 0 runs the pump:
        step the engine whenever rank 0's pump says ``"step"``, wait again
        on ``"idle"``, return on ``"stop"``.  A collective that reaches
        the group's timeout (rank 0 gone) raises."""
        if self.leader:
            raise RuntimeError("follow() is for ranks other than 0 of a tp "
                               "group; rank 0 runs start_pump()")
        group = self.engine.group
        while True:
            op = group.broadcast_object(None)
            if op == "stop":
                return
            if op == "step":
                with self._lock:
                    self.engine.step()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None) -> Request:
        """Queue one prompt; returns the live engine Request (rids are
        assigned by the facade).  Most callers want generate/stream."""
        params = params if params is not None else SamplingParams()
        with self._lock:
            prompt = check_prompt(self.engine, prompt)
            req = Request(next(self._rids), prompt, params=params)
            self.engine.submit(req)
            self._wake.set()
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

    def stats_payload(self) -> dict:
        """The GET /v1/stats shape: the engine's snapshot and the pool's
        usage, plus a per-replica breakdown.  A single LLM is a
        one-replica fleet, so the aggregate equals its one replica's
        stats (the JAX package's ``serve.router`` aggregates several)."""
        with self._lock:
            snap = self.engine.snapshot()
            usage = self.engine.store.usage()
        return {"engine": snap, "kv": usage,
                "replicas": [{"replica": 0, "engine": snap, "kv": usage,
                              "healthy": self._pump_error is None,
                              "draining": False}]}
