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
caller's device, sharing one cast copy of the weights -- or, with ``tp``
> 1, rank groups (``RankRouter``, which ``Router(tp=T, group=world)``
builds): a world of ``replicas x tp`` processes, one a rank, cut into
one group of ``tp`` consecutive ranks a replica
(``parallel.comm.Group.split``), each group one sharded engine.  World
rank 0 makes every routing decision and tells every rank over the
world's control plane; the RankRouter docstring has the protocol.

Stats aggregate across replicas with explicit merge rules (the shape GET
/v1/stats serves, ``aggregate_engine_stats``): counters SUM, peaks take
the MAX, ratios are recomputed from the summed numerators and
denominators, and latency percentiles from the POOLED per-request
samples.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.serve.api import LLM, PromptLike, _is_single_prompt, \
    check_prompt
from repro_torch.serve.engine import Request, ServeEngine
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

    def __new__(cls, *args, tp: Optional[int] = None, **kwargs):
        # replicas made of rank groups: one process a rank (RankRouter)
        if cls is Router and tp is not None and tp > 1:
            cls = RankRouter
        return super().__new__(cls)

    def __init__(self, params, cfg, *, replicas: int = 2,
                 tp: Optional[int] = None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: must be >= 1")
        if engine_kwargs.get("group") is not None:
            raise NotImplementedError(
                "Router(group=...) without tp > 1: a replica is one "
                "unsharded engine in this process")
        # one compute-dtype copy shared by every replica (read-only)
        params = cast_params(params, cfg)
        self.replicas = [Replica(r, LLM(params, cfg, **engine_kwargs))
                         for r in range(replicas)]
        self.cfg = self.replicas[0].llm.cfg
        self._route_lock = threading.Lock()
        self._sessions: dict = {}          # session id -> replica idx

    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True, seed: int = 0,
                  device="cuda", tp: Optional[int] = None,
                  **kwargs) -> "Router":
        """Params + config for a zoo arch (as ``LLM.from_arch``) behind
        ``replicas`` engines.  With ``tp`` > 1 every process of the world
        torchrun describes (``comm.Group.from_env``, ``replicas x tp``
        ranks) draws the host tree and its rank group's engine keeps the
        rank's slice."""
        import torch

        from repro_torch.configs import get_config, smoke_config
        from repro_torch.parallel import comm
        from repro_torch.weights import seeded_params

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port's entry points run on the "
                "card (pass device='cpu' to run the plain kernel versions)")
        cfg = get_config(arch)
        if smoke:
            cfg = smoke_config(cfg)
        if tp is not None and tp > 1:
            group = comm.Group.from_env(device=device)
            return cls(seeded_params(cfg, seed, torch.device("cpu")), cfg,
                       seed=seed, tp=tp, group=group, **kwargs)
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
            sticky = self._sticky(cands, session)
            if sticky is not None:
                return sticky
            prompt = np.asarray(prompt, np.int32)
            return self._pick(cands, {r.idx: r.prefix_hit(prompt)
                                      for r in cands},
                              {r.idx: r.load() for r in cands}, session)

    def _sticky(self, cands, session) -> Optional[int]:
        """The replica a session is pinned to, while it takes work."""
        if session is not None and self._sessions.get(session) in {
                r.idx for r in cands}:
            return self._sessions[session]
        return None

    def _pick(self, cands, hits: dict, loads: dict, session) -> int:
        """The routing rule after session affinity: the longest cached
        prefix, then the least load, then the lowest index; pins the
        session and counts the request."""
        best_hit = max(hits[r.idx] for r in cands)
        pool = [r for r in cands if hits[r.idx] == best_hit] \
            if best_hit > 0 else cands
        pick = min(pool, key=lambda r: (loads[r.idx], r.idx))
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


class RankReplica:
    """World rank 0's record of one rank-group replica: what routing
    reads (health, load, whether it has work), from the group's last
    report, beside the router-side state."""

    def __init__(self, idx: int):
        self.idx = idx
        self.draining = False
        self.served = 0               # requests routed here
        self.error: Optional[str] = None
        self.busy = False             # had work at its last report

    @property
    def healthy(self) -> bool:
        return self.error is None


class RankRouter(Router):
    """``Router(tp > 1)``: replicas made of rank groups, one process a
    rank (``Router(params, cfg, replicas=N, tp=T, group=world)`` builds
    it, every rank of the ``N x T`` world making the same call).

    Replica r is the ranks ``[r * T, (r + 1) * T)`` (``group.split(T)``),
    one sharded ``ServeEngine`` whose rank 0 fronts its control plane
    (``ServeEngine._sync``).  World rank 0 holds the fleet's surface:
    submissions, a proxy ``Request`` per request, the streams' queues,
    and every routing decision.  The world advances by TICKS, each a
    sequence of collectives over the world's control group that every
    rank reaches in the same order, none of them inside a replica's
    step:

      1. rank 0 broadcasts the tick: its op (``"step"``, ``"idle"``,
         ``"stats"``, ``"return"`` or ``"stop"``), the requests submitted
         since the last tick (rid, prompt, params, session) and the rids
         to cancel;
      2. with new requests: each group's rank 0 reports its replica's
         load and prefix hits for them (one object gather), rank 0
         applies ``Router.route``'s rule to each in order -- session,
         prefix, least load, a pick adding one to its replica's load --
         and broadcasts where each goes; each rank submits only those of
         its own replica, so every rank of a group sees the same
         requests in the same order;
      3. on ``"step"`` each rank steps its own engine if it has work, so
         a replica's step runs its own group's collectives only;
      4. on ``"step"`` and ``"stats"`` each group's rank 0 reports the
         tokens its engine emitted and the requests it finished (with a
         snapshot, the pool's usage and its TTFT samples on
         ``"stats"``), gathered to rank 0, which fills the proxies and
         the queues; a ``"stats"`` tick then broadcasts the aggregate.

    No rank but world rank 0 chooses anything: rids come from its one
    counter, so a request unseeded or seeded draws the same stream on
    whichever replica serves it (``params.seed``, else (engine seed,
    rid)).  Inline (no pump), every rank makes the same calls: rank 0's
    ``generate`` ticks until its requests are done and ends with a
    ``"return"`` tick carrying the outputs, which the other ranks'
    ``generate`` returns; ``stats_payload`` likewise.  Under the pump
    (the HTTP server) rank 0's pump thread ticks -- ``"idle"`` every
    quarter of the world's timeout when there is nothing to do -- and
    every other rank runs ``follow`` until ``"stop"``.  Stamps cross
    processes as ``time.perf_counter`` values, comparable on one host."""

    def __init__(self, params, cfg, *, replicas: int = 2,
                 tp: Optional[int] = None, group=None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: must be >= 1")
        if group is None or group.world != replicas * tp:
            raise ValueError(
                f"Router(replicas={replicas}): tp={tp} needs group=, a "
                f"world of {replicas * tp} ranks, one process a rank; got "
                f"{group!r}")
        self.world = group
        self.tp = tp
        self.index = group.rank // tp              # this rank's replica
        self.sub = group.split(tp)
        self.engine = ServeEngine(params, cfg, tp=tp, group=self.sub,
                                  **engine_kwargs)
        self.cfg = self.engine.cfg
        self.replicas = [RankReplica(r) for r in range(replicas)]
        self._sessions: dict = {}
        self._lock = threading.RLock()
        self._rids = itertools.count()
        self._new: list = []          # rank 0: submitted, not yet routed
        self._cancels: List[int] = []  # rank 0: rids to cancel
        self._proxies: dict = {}      # rank 0: rid -> unfinished proxy
        self._queues: dict = {}       # rank 0: rid -> a stream's queue
        self._waiters: list = []      # rank 0: (event, box) for a stats tick
        self._mine: dict = {}         # this replica's requests by rid
        self._emitted: List[TokenChunk] = []
        self._error: Optional[BaseException] = None   # this engine's
        if self.sub.rank == 0:
            self.engine.add_consumer(self._emitted.append)
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        self._pump_error: Optional[BaseException] = None
        self._wake = threading.Event()

    @property
    def leader(self) -> bool:
        """World rank 0: the fleet's surface and every decision."""
        return self.world.rank == 0

    @property
    def _pumping(self) -> bool:
        t = self._pump_thread
        return t is not None and t.is_alive()

    # -- one tick (every rank, in the same order) ---------------------------
    def _message(self, op: str, **extra) -> dict:
        with self._lock:
            msg = {"op": op, "new": self._new, "cancel": self._cancels,
                   **extra}
            self._new, self._cancels = [], []
        return msg

    def _tick(self, op: Optional[str] = None, **extra):
        """One tick; rank 0 names its ``op``.  Returns (the message, the
        stats payload of a ``"stats"`` tick or None)."""
        msg = self.world.broadcast_object(
            self._message(op, **extra) if self.leader else None)
        if msg["new"]:
            self._route_new(msg["new"])
        for rid in msg["cancel"]:
            req = self._mine.get(rid)
            if req is not None:
                self.engine.cancel(req)
        if msg["op"] == "step" and self._error is None \
                and self.engine.has_work:
            try:
                self.engine.step()
            except Exception as e:    # this replica stops; the world goes on
                self._error = e
        payload = None
        if msg["op"] in ("step", "stats"):
            reports = self.world.gather_object(
                self._report(msg["op"] == "stats") if self.sub.rank == 0
                else None)
            if self.leader:
                reports = reports[::self.tp]
                self._apply(reports)
                if msg["op"] == "stats":
                    payload = self._payload(reports)
            if msg["op"] == "stats":
                payload = self.world.broadcast_object(payload)
        return msg, payload

    def _route_new(self, new: list) -> None:
        probe = None
        if self.sub.rank == 0:
            eng = self.engine
            probe = {"load": (len(eng.queue) + len(eng._outbox)
                              + sum(s is not None for s in eng.slots)),
                     "hits": [eng.store.match_prefix(
                         np.asarray(p, np.int32))[1] for _, p, _, _ in new],
                     "error": (None if self._error is None
                               else repr(self._error))}
        probes = self.world.gather_object(probe)
        dest = None
        if self.leader:
            probes = probes[::self.tp]
            for r, pr in zip(self.replicas, probes):
                r.error = pr["error"]
            loads = {r.idx: pr["load"] for r, pr in
                     zip(self.replicas, probes)}
            dest = []
            for n, (rid, _, _, session) in enumerate(new):
                cands = [r for r in self.replicas
                         if r.healthy and not r.draining]
                if not cands:           # nobody takes work: cancelled
                    dest.append(-1)
                    continue
                pick = self._sticky(cands, session)
                if pick is None:
                    pick = self._pick(cands, {r.idx: probes[r.idx]["hits"][n]
                                              for r in cands}, loads,
                                      session)
                loads[pick] += 1
                dest.append(pick)
        dest = self.world.broadcast_object(dest)
        for (rid, prompt, params, _), d in zip(new, dest):
            if d == self.index:
                req = Request(rid, np.asarray(prompt, np.int32).copy(),
                              params=params)
                self._mine[rid] = req
                self.engine.submit(req)
            elif d == -1 and self.leader:
                self._finish(rid, "cancelled", None, None, None)

    def _report(self, full: bool) -> dict:
        done = [(rid, r.finish_reason, r.t_admit, r.t_first, r.t_done)
                for rid, r in self._mine.items() if r.done]
        for rid, *_ in done:
            del self._mine[rid]
        eng = self.engine
        rep = {"chunks": list(self._emitted), "done": done,
               "busy": self._error is None and eng.has_work,
               "error": None if self._error is None else repr(self._error)}
        self._emitted.clear()
        if full:
            rep.update(snap=eng.snapshot(), kv=eng.store.usage(),
                       ttft=list(eng._ttft_ms))
        return rep

    def _apply(self, reports: list) -> None:
        with self._lock:
            for r, rep in zip(self.replicas, reports):
                r.error, r.busy = rep["error"], rep["busy"]
                for c in rep["chunks"]:
                    px = self._proxies.get(c.rid)
                    if px is not None:
                        px.generated.append(c.token)
                        q = self._queues.get(c.rid)
                        if q is not None:
                            q.put(c)
                for rid, reason, t_admit, t_first, t_done in rep["done"]:
                    self._finish(rid, reason, t_admit, t_first, t_done)

    def _finish(self, rid: int, reason, t_admit, t_first, t_done) -> None:
        with self._lock:
            px = self._proxies.pop(rid, None)
            if px is None:
                return
            now = time.perf_counter()
            px.finish_reason = reason
            px.t_admit = now if t_admit is None else t_admit
            px.t_first = px.t_admit if t_first is None else t_first
            px.t_done = now if t_done is None else t_done
            px.done = True

    def _payload(self, reports: list) -> dict:
        reps = [{"replica": r.idx, "engine": rep["snap"], "kv": rep["kv"],
                 "healthy": r.healthy, "draining": r.draining,
                 "routed": r.served, "has_work": rep["busy"],
                 **({} if r.error is None else {"error": r.error})}
                for r, rep in zip(self.replicas, reports)]
        return {"engine": aggregate_engine_stats(
                    [rep["snap"] for rep in reports],
                    [rep["ttft"] for rep in reports]),
                "kv": aggregate_kv([rep["kv"] for rep in reports]),
                "replicas": reps}

    # -- the surface: world rank 0 ------------------------------------------
    def route(self, prompt: PromptLike, session: Optional[str] = None):
        raise NotImplementedError(
            "a rank-group router routes inside its ticks, where every "
            "replica's load and prefix hits are gathered")

    def submit(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               session: Optional[str] = None):
        """Queue one prompt for the next tick's routing (world rank 0);
        returns ``(proxy Request, None)``: the replica is chosen at the
        tick, ``replicas[i].served`` counts it then."""
        if not self.leader:
            raise RuntimeError("submit on world rank 0 only")
        params = params if params is not None else SamplingParams()
        with self._lock:
            self._candidates()            # raises when nobody takes work
            prompt = check_prompt(self.engine, prompt)
            px = Request(next(self._rids), prompt, params=params)
            # the submit gates (params, sampler, modes) on a throwaway
            # copy: a bad request fails here, not in a replica's step
            self.engine._prepare(Request(px.rid, prompt.copy(),
                                         params=params))
            px.orig_prompt = prompt.copy()
            px.t_submit = time.perf_counter()
            self._proxies[px.rid] = px
            self._new.append((px.rid, prompt, params, session))
            self._wake.set()
        return px, None

    def _drive_until(self, pred) -> None:
        """Rank 0: tick until ``pred()`` (inline), or wait on the pump."""
        while not pred():
            if self._pump_error is not None:
                raise RuntimeError("router pump died") from self._pump_error
            if self._pumping:
                time.sleep(0.001)
                continue
            had_new = bool(self._new or self._cancels)
            self._tick("step")
            if not (pred() or had_new
                    or any(r.busy for r in self.replicas)):
                raise RuntimeError(
                    "router idle with unfinished requests: a request was "
                    "lost (bug) or never submitted")

    def _follow(self, until: str) -> dict:
        """Any rank but 0: run rank 0's ticks until one of op ``until``
        (or ``"stop"``); returns (its message, its payload)."""
        while True:
            msg, payload = self._tick()
            if msg["op"] in (until, "stop"):
                return msg, payload

    def generate(self, prompts, params=None,
                 sessions=None) -> List[RequestOutput]:
        """Every rank makes the call (inline), or rank 0 alone under the
        pump: rank 0 serves the prompts across the fleet and every rank
        returns its outputs, in prompt order."""
        if not self.leader:
            return self._follow("return")[0]["out"]
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
        outs = [RequestOutput.from_request(r) for r in reqs]
        if not self._pumping:
            self._tick("return", out=outs)
        return outs

    def stream(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               session: Optional[str] = None) -> Iterator[TokenChunk]:
        """Rank 0 under the pump (the HTTP server's mode): submit now and
        yield the tokens as the owning replica's reports bring them."""
        if not (self.leader and self._pumping):
            raise RuntimeError("a rank-group router streams from world rank "
                               "0 under its pump (start_pump)")
        q: "queue.SimpleQueue[TokenChunk]" = queue.SimpleQueue()
        with self._lock:
            px, _ = self.submit(prompt, params, session)
            self._queues[px.rid] = q
        return self._stream_iter(px, q)

    def _stream_iter(self, px: Request, q) -> Iterator[TokenChunk]:
        try:
            while True:
                if self._pump_error is not None:
                    raise RuntimeError("router pump died") \
                        from self._pump_error
                try:
                    chunk = q.get(timeout=0.05)
                except queue.Empty:
                    if px.done:           # finished with no final chunk
                        return
                    continue
                yield chunk
                if chunk.finish_reason is not None:
                    return
        finally:
            with self._lock:
                self._queues.pop(px.rid, None)
                if not px.done:           # abandoned: cancel at the tick
                    self._cancels.append(px.rid)
                    self._wake.set()

    # -- lifecycle -----------------------------------------------------------
    def start_pump(self, idle_wait: float = 0.005) -> None:
        """World rank 0: tick from a background thread -- ``"step"``
        while anything is pending or a replica has work, a ``"stats"``
        tick for a waiting ``stats_payload``, else ``"idle"`` every
        quarter of the world's timeout -- and ``"stop"`` at
        ``stop_pump``.  Every other rank runs ``follow``."""
        if self._pumping:
            return
        if not self.leader:
            raise RuntimeError(f"world rank {self.world.rank} follows rank "
                               "0's pump: call follow(), not start_pump()")
        self._pump_stop.clear()
        self._pump_error = None
        beat = self.world.timeout_s / 4

        def loop():
            last = time.monotonic()
            try:
                while not self._pump_stop.is_set():
                    with self._lock:
                        waiters, self._waiters = self._waiters, []
                        busy = bool(self._new or self._cancels) or any(
                            r.busy for r in self.replicas)
                    if waiters:
                        _, payload = self._tick("stats")
                        for ev, box in waiters:
                            box.append(payload)
                            ev.set()
                    elif busy or time.monotonic() - last >= beat:
                        self._tick("step" if busy else "idle")
                    else:
                        self._wake.wait(max(0.0, beat - (time.monotonic()
                                                         - last)))
                        self._wake.clear()
                        continue
                    last = time.monotonic()
                self._tick("stop")
            except BaseException as e:    # surfaced by waiters, not lost
                self._pump_error = e
                with self._lock:
                    for ev, _ in self._waiters:
                        ev.set()

        self._pump_thread = threading.Thread(
            target=loop, name="router-pump", daemon=True)
        self._pump_thread.start()

    def stop_pump(self) -> None:
        if self._pump_thread is None:
            return
        self._pump_stop.set()
        self._wake.set()
        self._pump_thread.join()
        self._pump_thread = None

    def follow(self) -> None:
        """Any rank but world rank 0, while rank 0 runs the pump: take
        part in every tick until ``"stop"``."""
        if self.leader:
            raise RuntimeError("world rank 0 runs start_pump(), not follow()")
        self._follow("stop")

    def drain(self, idx: int, wait: bool = False,
              timeout: float = 60.0) -> None:
        """Stop routing new work to replica ``idx`` (a decision of world
        rank 0's); ``wait`` ticks (or waits on the pump) until its last
        report had no work -- inline every rank makes the call, and rank
        0's ends with a ``"return"`` tick the others follow to."""
        if not self.leader:
            if wait and not self._pumping:
                self._follow("return")
            return
        rep = self.replicas[idx]
        rep.draining = True
        with self._lock:
            self._sessions = {s: i for s, i in self._sessions.items()
                              if i != idx}
        if not wait:
            return
        deadline = time.monotonic() + timeout
        try:
            while rep.busy:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {idx} still busy after {timeout}s")
                if self._pumping:
                    time.sleep(0.005)
                else:
                    self._tick("step")
        finally:
            if not self._pumping:
                self._tick("return", out=None)

    # -- introspection (the server surface) ----------------------------------
    def stats_payload(self) -> dict:
        """One ``"stats"`` tick: each replica's snapshot, pool usage and
        TTFT samples gathered from its group's rank 0 to world rank 0
        and merged by ``aggregate_engine_stats`` / ``aggregate_kv``; every
        rank returns it (inline every rank calls; under the pump rank 0's
        handler waits for the pump's tick)."""
        if not self.leader:
            return self._follow("stats")[1]
        if not self._pumping:
            return self._tick("stats")[1]
        ev, box = threading.Event(), []
        with self._lock:
            self._waiters.append((ev, box))
            self._wake.set()
        while not ev.wait(0.05):
            if not self._pumping:
                break
        if not box:
            raise RuntimeError("router pump died") from self._pump_error
        return box[0]

    def health(self) -> dict:
        """The fleet is ok while a replica can take new work; each
        replica's record comes from the same gather as ``stats_payload``."""
        reps = [{"replica": r["replica"], "ok": r["healthy"],
                 "draining": r["draining"], "pumping": self._pumping,
                 "has_work": r["has_work"],
                 **({"error": r["error"]} if "error" in r else {})}
                for r in self.stats_payload()["replicas"]]
        ok = self._pump_error is None and any(
            r["ok"] and not r["draining"] for r in reps)
        return {"ok": ok, "replicas": reps}

    def kv_usage(self) -> dict:
        return self.stats_payload()["kv"]
