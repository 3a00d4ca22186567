"""Multi-replica router: N serving engines behind one admission surface.

Counterpart of ``repro.serve.router``.  A ``Router`` owns N ``LLM``
replicas -- each a full continuous-batching engine with its own KV pool,
prefix trie and background pump -- and routes every incoming request to
exactly one of them:

  1. SESSION AFFINITY: a request tagged with a ``session`` id goes to the
     replica that served that session before (the sticky map is set on
     first sight and cleared when the replica drains), so a conversation
     keeps hitting the KV prefixes it already built.
  2. PREFIX AFFINITY: otherwise each candidate's prefix trie is probed
     with the prompt (``store.match_prefix``, the lookup admission uses)
     and the replica with the longest cached run wins: the request adopts
     those pool blocks and prefills only its suffix.
  3. LEAST LOADED: no cached prefix anywhere -> the replica with the
     fewest queued + active requests, ties to the lowest index.

Replicas are health-checked (no pump error) and DRAINABLE: ``drain(i)``
stops routing new work to replica ``i`` while its in-flight requests run
to completion.  If every replica is draining or unhealthy, submission
raises.

Replicas here are unsharded ``LLM``s in one process, each on the
caller's device, sharing one cast copy of the weights.  ``Router(tp > 1)``
raises ``NotImplementedError``: replicas made of rank groups need routing
decisions agreed across the groups' processes.

Stats aggregate across replicas with explicit merge rules (the shape GET
/v1/stats serves, ``aggregate_engine_stats``): counters SUM, peaks take
the MAX, ratios are recomputed from the summed numerators and
denominators, and latency percentiles from the POOLED per-request
samples.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.serve.api import LLM, PromptLike, _is_single_prompt
from repro_torch.serve.outputs import RequestOutput, TokenChunk
from repro_torch.serve.params import SamplingParams
from repro_torch.weights import cast_params

# engine counters that SUM across replicas (independent event counts);
# the gauges queue_depth/active_slots sum too: the work in the fleet
_SUM_KEYS = (
    "prefills", "prefill_chunks", "decode_steps", "iterations",
    "fused_rows", "completed", "deferred", "preemptions", "cancelled",
    "drafted", "accepted", "host_syncs", "emitted_tokens",
    "prefix_hits", "prefix_hit_tokens", "prefill_tokens",
    "queue_depth", "active_slots", "cow_copies", "shared_blocks",
)
# peaks take the max: the worst single pool seen, never a fleet total
# (the pools are disjoint, their high-watermarks never coexisted)
_MAX_KEYS = ("peak_in_use",)


def aggregate_engine_stats(snaps: Sequence[dict],
                           ttft_pools: Optional[Sequence[Sequence[float]]]
                           = None) -> dict:
    """Merge per-replica ``engine.snapshot()`` dicts: counters and work
    gauges sum; peaks max; ``acceptance_rate`` and ``tokens_per_dispatch``
    are recomputed from the summed terms (an idle replica must not dilute
    a busy one); TTFT percentiles come from the pooled raw samples when
    ``ttft_pools`` is given, else None (a percentile of percentiles would
    be wrong).  The engine-wide mode fields come from the first replica."""
    if not snaps:
        return {}
    agg = {k: sum(int(s.get(k, 0)) for s in snaps) for k in _SUM_KEYS}
    for k in _MAX_KEYS:
        agg[k] = max(int(s.get(k, 0)) for s in snaps)
    agg["acceptance_rate"] = (agg["accepted"] / agg["drafted"]
                              if agg["drafted"] else 0.0)
    agg["tokens_per_dispatch"] = (agg["emitted_tokens"]
                                  / max(agg["host_syncs"], 1))
    agg["attn_approx"] = snaps[0].get("attn_approx")
    agg["attn_window"] = snaps[0].get("attn_window")
    samples = [t for pool in (ttft_pools or ()) for t in pool]
    if samples:
        t = np.asarray(samples)
        agg["ttft_ms_p50"] = float(np.percentile(t, 50))
        agg["ttft_ms_p99"] = float(np.percentile(t, 99))
    else:
        agg["ttft_ms_p50"] = agg["ttft_ms_p99"] = None
    return agg


def aggregate_kv(usages: Sequence[dict]) -> dict:
    """Merge per-replica ``store.usage()`` dicts: block counts sum (the
    pools are disjoint), ``peak_in_use`` maxes, layout and block size come
    from the first replica."""
    if not usages:
        return {}
    out = {"layout": usages[0]["layout"],
           "block_size": usages[0]["block_size"]}
    for k in ("num_blocks", "blocks_free", "blocks_in_use", "paged_leaves",
              "dense_leaves", "shared_blocks", "prefix_blocks",
              "blocks_reclaimable", "cow_copies", "prefix_evictions"):
        out[k] = sum(int(u.get(k, 0)) for u in usages)
    out["peak_in_use"] = max(int(u.get("peak_in_use", 0)) for u in usages)
    return out


class Replica:
    """One engine replica plus its router-side state."""

    def __init__(self, idx: int, llm: LLM):
        self.idx = idx
        self.llm = llm
        self.draining = False
        self.served = 0               # requests routed here

    @property
    def healthy(self) -> bool:
        """Healthy while its engine can make progress: no pump error (a
        pump never started steps inline, which is not unhealthy)."""
        return self.llm._pump_error is None

    def load(self) -> int:
        """In-flight work: queued + active requests (read without the
        engine lock; a stale-by-one count only moves a tie-break)."""
        eng = self.llm.engine
        return len(eng.queue) + sum(s is not None for s in eng.slots)

    def prefix_hit(self, prompt) -> int:
        """The longest cached prefix (tokens) this replica's trie holds
        for ``prompt``: the affinity signal."""
        with self.llm._lock:
            _, hit = self.llm.engine.store.match_prefix(prompt)
        return hit


class Router:
    """N ``LLM`` replicas behind one submit/generate/stream surface.

    ``Router(params, cfg, replicas=N, **engine_kwargs)`` builds N
    identical engines over one cast copy of the weights (each owns its KV
    store).  A drop-in for ``LLM`` in ``serve/server.py``: the same
    ``generate``/``stream``/``start_pump``/``health``/``stats_payload``
    surface."""

    def __init__(self, params, cfg, *, replicas: int = 2,
                 tp: Optional[int] = None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: must be >= 1")
        if tp is not None and tp > 1:
            raise NotImplementedError(
                f"Router(tp={tp}): replicas made of rank groups need routing "
                "decisions agreed across the groups' processes; the port's "
                "replicas are unsharded engines in one process")
        if engine_kwargs.get("group") is not None:
            raise NotImplementedError(
                "Router(group=...): a replica is one unsharded engine")
        # one compute-dtype copy shared by every replica (read-only)
        params = cast_params(params, cfg)
        self.replicas = [Replica(r, LLM(params, cfg, **engine_kwargs))
                         for r in range(replicas)]
        self.cfg = self.replicas[0].llm.cfg
        self._route_lock = threading.Lock()
        self._sessions: dict = {}          # session id -> replica idx

    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True, seed: int = 0,
                  device="cuda", **kwargs) -> "Router":
        """Params + config for a zoo arch (as ``LLM.from_arch``) behind
        ``replicas`` engines."""
        import torch

        from repro_torch.configs import get_config, smoke_config
        from repro_torch.weights import seeded_params

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port's entry points run on the "
                "card (pass device='cpu' to run the plain kernel versions)")
        cfg = get_config(arch)
        if smoke:
            cfg = smoke_config(cfg)
        return cls(seeded_params(cfg, seed, device), cfg, seed=seed,
                   **kwargs)

    # -- routing -------------------------------------------------------------
    def _candidates(self) -> List[Replica]:
        up = [r for r in self.replicas if r.healthy and not r.draining]
        if not up:
            raise RuntimeError(
                "no healthy replica accepting work: "
                + ", ".join(f"replica {r.idx}: "
                            + ("draining" if r.draining else "pump died")
                            for r in self.replicas))
        return up

    def route(self, prompt: PromptLike,
              session: Optional[str] = None) -> int:
        """The replica index for this request: session, then prefix, then
        least load (the module docstring)."""
        with self._route_lock:
            cands = self._candidates()
            ok = {r.idx for r in cands}
            if session is not None and self._sessions.get(session) in ok:
                return self._sessions[session]
            prompt = np.asarray(prompt, np.int32)
            hits = [(r.prefix_hit(prompt), r) for r in cands]
            best_hit = max(h for h, _ in hits)
            pool = [r for h, r in hits if h == best_hit] if best_hit > 0 \
                else cands
            pick = min(pool, key=lambda r: (r.load(), r.idx))
            if session is not None:
                self._sessions[session] = pick.idx
            pick.served += 1
            return pick.idx

    # -- the LLM surface -----------------------------------------------------
    def submit(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               session: Optional[str] = None):
        """Route + submit; returns ``(Request, replica index)``."""
        idx = self.route(prompt, session)
        return self.replicas[idx].llm.submit(prompt, params), idx

    def generate(self, prompts, params=None,
                 sessions=None) -> List[RequestOutput]:
        """Serve prompt(s) across the fleet; outputs in prompt order."""
        if not isinstance(prompts, np.ndarray):
            prompts = list(prompts)
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
        slist = [None] * len(prompts) if sessions is None else list(sessions)
        reqs = [self.submit(p, sp, session=s)[0]
                for p, sp, s in zip(prompts, plist, slist)]
        self._drive_until(lambda: all(r.done for r in reqs))
        return [RequestOutput.from_request(r) for r in reqs]

    def stream(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               session: Optional[str] = None) -> Iterator[TokenChunk]:
        idx = self.route(prompt, session)
        return self.replicas[idx].llm.stream(prompt, params)

    def _drive_until(self, pred) -> None:
        """Advance every replica with work until ``pred()``: inline
        round-robin steps when no pump runs (each replica under its own
        lock), else wait on the pumps."""
        while not pred():
            for r in self.replicas:
                if r.llm._pump_error is not None:
                    raise RuntimeError(
                        f"replica {r.idx} engine pump died"
                    ) from r.llm._pump_error
            if any(r.llm._pumping for r in self.replicas):
                time.sleep(0.001)
                continue
            progressed = False
            for r in self.replicas:
                with r.llm._lock:
                    if r.llm.engine.has_work:
                        r.llm.engine.step()
                        progressed = True
            if not progressed and not pred():
                raise RuntimeError(
                    "router idle with unfinished requests: a request was "
                    "lost (bug) or never submitted")

    # -- lifecycle -----------------------------------------------------------
    def start_pump(self, idle_wait: float = 0.005) -> None:
        for r in self.replicas:
            r.llm.start_pump(idle_wait)

    def stop_pump(self) -> None:
        for r in self.replicas:
            r.llm.stop_pump()

    def drain(self, idx: int, wait: bool = False,
              timeout: float = 60.0) -> None:
        """Stop routing new work to replica ``idx``; its in-flight
        requests run to completion.  ``wait=True`` blocks until it is
        idle (stepping it inline when no pump runs)."""
        rep = self.replicas[idx]
        rep.draining = True
        with self._route_lock:
            self._sessions = {s: i for s, i in self._sessions.items()
                              if i != idx}
        if wait:
            deadline = time.monotonic() + timeout
            while rep.llm.engine.has_work:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {idx} still busy after {timeout}s")
                if not rep.llm._pumping:
                    with rep.llm._lock:
                        if rep.llm.engine.has_work:
                            rep.llm.engine.step()
                else:
                    time.sleep(0.005)

    def undrain(self, idx: int) -> None:
        self.replicas[idx].draining = False

    # -- introspection (the server surface) ----------------------------------
    def health(self) -> dict:
        reps = [{"replica": r.idx, "ok": r.healthy,
                 "draining": r.draining,
                 "pumping": r.llm._pumping,
                 "has_work": r.llm.engine.has_work,
                 **({} if r.llm._pump_error is None else
                    {"error": f"engine pump died: {r.llm._pump_error}"})}
                for r in self.replicas]
        # the fleet is OK while at least one replica can take new work
        ok = any(r["ok"] and not r["draining"] for r in reps)
        return {"ok": ok, "replicas": reps}

    def stats_payload(self) -> dict:
        """The /v1/stats shape: aggregate engine and kv (the merge rules
        of ``aggregate_engine_stats``) plus the per-replica breakdown."""
        snaps, usages, pools, reps = [], [], [], []
        for r in self.replicas:
            with r.llm._lock:
                snap = r.llm.engine.snapshot()
                usage = r.llm.engine.store.usage()
                pool = list(r.llm.engine._ttft_ms)
            snaps.append(snap)
            usages.append(usage)
            pools.append(pool)
            reps.append({"replica": r.idx, "engine": snap, "kv": usage,
                         "healthy": r.healthy, "draining": r.draining,
                         "routed": r.served})
        return {"engine": aggregate_engine_stats(snaps, pools),
                "kv": aggregate_kv(usages),
                "replicas": reps}

    @property
    def stats(self) -> dict:
        """Aggregate engine counters (the LLM-compatible property)."""
        return self.stats_payload()["engine"]

    def kv_usage(self) -> dict:
        return aggregate_kv([r.llm.engine.store.usage()
                             for r in self.replicas])
