"""Serving engine: continuous batching over a paged KV cache, with the
reduced softmax unit as the decode head.

Counterpart of ``repro.serve.engine`` on its default path:

  - fixed ``n_slots`` decode slots over a SHARED, BLOCK-PAGED KV pool
    (``serve/paged_kv.py``); slots free their blocks on eos / length /
    stop and are refilled from the queue;
  - admission is ONE-SHOT and paged: a queued request gets its prompt's
    block cover, one prefill writes the prompt's K/V straight into those
    blocks and its head emits the first token.  Admission defers at the
    queue head while the pool cannot cover the prompt plus one decode
    block; a dry pool mid-decode preempts the youngest slot back to the
    queue (it re-prefills later with its tokens so far);
  - decode is RAGGED and FUSED: each engine iteration runs ONE decode
    step over all active slots, every row at its own position, then one
    head per distinct ``sampler.device_form()`` over its rows -- so
    ``stats['decode_steps'] == stats['iterations']`` whenever a slot is
    active.  Batch and block-table widths are padded to powers of two
    (padding rows repeat row 0: the same K/V lands on the same cell).
    On the card the step's device half is one CUDA graph per shape
    bucket (``serve/step_graph.py``, the counterpart of the reference's
    ``_jitted_step``); it runs eagerly on the CPU, inside
    ``step_graph.eager_steps()`` and while the probe's tap is set;
  - sampling is a ``Sampler``: ``Greedy`` is the reduced softmax unit
    (the fused argmax comparator), ``TopK`` the k-winner comparator bus
    with an O(k) host softmax (and the ``n_candidates`` candidate ids),
    ``Temperature`` Gumbel-max over the logit row, ``SoftmaxBaseline``
    the full unit for A/B runs;
  - decode is SPECULATIVE on request (``SamplingParams(spec_k=K)``): the
    engine's Drafter (``serve/spec.py``; model-free prompt lookup by
    default) proposes up to K draft tokens per slot, the step widens to
    T = pow2(widest window) and runs the trunk over each row's (last
    token + drafts) window at per-(row, query) positions, and the
    COMPARATOR verifies every position at once (accept draft t_i iff
    argmax(logits_i) == t_i -- Theorem 1, repeated;
    ``kernels.ops.verify_draft``), emitting 1..K+1 tokens per iteration,
    identical to non-speculative greedy.  Rejected drafts rewind in O(1):
    the slot position does not advance over them (the kv_pos <= positions
    masks hide the stale pool rows) and surplus whole blocks go back to
    the free list (``store.rewind``).  Rows without drafts ride along,
    their padding queries repeating their last (token, position).

  - attention's score function is engine-wide: ``attn_approx`` (the
    ``core.attn_approx`` catalog) and ``attn_window`` replace the cfg's
    and reach every decode layer's paged attention; the one-shot prefill
    attends exactly over the whole prompt, as in the JAX package.

The JAX engine's other modes are refused, not ignored: ``chunk_size``,
``token_budget``, ``host_stride``, ``tp``/``mesh``, ``scheduler='cohort'``,
``kv_layout='dense'`` and ``prefix_cache`` raise ``NotImplementedError``
(or ``ValueError`` for values that are wrong in both packages).
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attn_approx as approx
from repro_torch.kernels import ops
from repro_torch.models import api, lm
from repro_torch.serve import sampler as sampler_mod
from repro_torch.serve import step_graph
from repro_torch.serve.outputs import TokenChunk
from repro_torch.serve.paged_kv import PagedKVStore, pow2 as _pow2
from repro_torch.serve.params import SamplingParams
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.spec import PromptLookupDrafter
from repro_torch.weights import cast_params


def _to_host(out):
    """One device->host copy per head group; tuple outputs (the k-winner
    bus, the verify group) leaf by leaf."""
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    top_k: int = 1                     # 1 = greedy (the pure comparator)
    temperature: float = 1.0
    # the typed sampling surface; None -> synthesized at submit from the
    # legacy kwargs above.  When given, params IS the source of truth.
    params: Optional[SamplingParams] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # why generation stopped: 'eos' | 'length' | 'stop' | 'max_len' |
    # 'cancelled'
    finish_reason: Optional[str] = None
    # per-request numpy RNG, seeded (params.seed, or (engine seed, rid))
    # at submit: the nth sampled token consumes the nth draw whatever the
    # scheduling (deferral, preemption).  The greedy heads never draw.
    rng: Optional[np.random.Generator] = None
    sampler: Optional[Sampler] = None
    # the prompt as submitted (preemption folds generated tokens into
    # ``prompt`` for the re-prefill; this keeps the user's original).
    orig_prompt: Optional[np.ndarray] = None
    # wall-clock stamps (time.perf_counter seconds): submit / first
    # prefill start / first token / final token.
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass
class StepPlan:
    """The host half of one fused decode step (``ServeEngine._plan_step``).

    ``padded`` the slot of each padded row (the first ``n_real`` real);
    ``drafts`` each slot's draft tokens; ``where`` each padded row's
    (head group, offset) or (None, offset in the verify group);
    ``order`` the head groups in ``canonical_order``; ``arrays`` the
    device body's operands on the host -- tokens (B, T) int64, positions
    (B,) or (B, T) int32, block tables (B, nb) int32, one (B,) int64 row
    vector per group, then the verify group's (B,) rows and (B, T-1)
    int32 draft ids when ``spec`` (B, its padded row count) is not 0;
    ``key`` the ``step_graph.bucket_key``."""
    n_real: int
    padded: list
    drafts: dict
    where: list
    order: list
    arrays: tuple
    spec: int
    key: tuple


class ServeEngine:
    def __init__(self, params: dict, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 head_mode: str = "reduced", kv_layout: str = "paged",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 scheduler: str = "fused", mesh=None, seed: int = 0,
                 drafter=None, chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 host_stride: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 attn_approx: Optional[str] = None,
                 attn_window: Optional[int] = None,
                 tp: Optional[int] = None):
        if scheduler not in ("fused", "cohort"):
            raise ValueError(f"scheduler={scheduler!r}: expected 'fused' "
                             "(one step per iteration) or 'cohort'")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout={kv_layout!r}: expected 'paged' "
                             "or 'dense'")
        refused = {
            "chunk_size": chunk_size, "token_budget": token_budget,
            "host_stride": host_stride, "mesh": mesh,
            "prefix_cache": prefix_cache,
            "tp": None if tp in (None, 1) else tp,
            "scheduler": None if scheduler == "fused" else scheduler,
            "kv_layout": None if kv_layout == "paged" else kv_layout,
        }
        for name, value in refused.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}={value!r}: the port serves one-shot paged "
                    "prefill and the fused ragged decode step on one device "
                    "only so far")
        # the kwargs override the cfg's modes (None keeps the cfg's);
        # 'exact' + None replace to an equal cfg
        if attn_approx is not None or attn_window is not None:
            mode, win = approx.resolve(
                attn_approx if attn_approx is not None else cfg.attn_approx,
                attn_window if attn_window is not None else cfg.attn_window)
            cfg = dataclasses.replace(cfg, attn_approx=mode,
                                      attn_window=win)
        # f32 master weights -> the compute dtype, ONCE (the JAX package
        # casts inside every jitted step)
        self.params = cast_params(params, cfg)
        self.device = self.params["embed"].device
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.head_mode = head_mode
        self.scheduler = scheduler
        self.seed = seed
        sampler_mod.resolve(head_mode, cfg=cfg)      # refuse bad heads now
        # the draft proposer for speculative requests (spec_k > 0);
        # model-free prompt lookup by default -- any serve.spec.Drafter.
        self.drafter = drafter if drafter is not None \
            else PromptLookupDrafter()
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)   # next write position
        self.admit_order: List[int] = []              # admission recency
        self.store = PagedKVStore(cfg, n_slots=n_slots, max_len=max_len,
                                  device=self.device, block_size=block_size,
                                  num_blocks=num_blocks)
        # every layer's param views, built once (lm.layer_params); the
        # decode step's CUDA graphs, one per shape bucket (step_graph)
        self._layers = lm.layer_params(self.params, cfg)
        self.graphs = step_graph.StepGraphs()
        # decode_steps counts decode calls, iterations engine loop turns
        # (decode_steps == iterations whenever a slot is active);
        # fused_rows counts real (non-padding) rows over those calls;
        # prefills counts one-shot prompt prefills; host_syncs every
        # dispatch with a device->host read (prefills + decode steps);
        # emitted_tokens every token through _emit_token.  prefill_ms and
        # decode_ms sum the host wall clock of the prefill calls and the
        # decode steps, each up to its head output on the host (which
        # waits for the device).  drafted/accepted count speculative draft
        # tokens proposed / accepted by the comparator, acceptance_rate
        # their ratio.  head_calls counts head calls by sampler kind
        # ('Greedy', 'TopK', ...; 'verify' for a step's speculative
        # group): one head call is one kernel launch on the card.
        self.stats = {"prefills": 0, "decode_steps": 0, "iterations": 0,
                      "fused_rows": 0, "completed": 0, "deferred": 0,
                      "preemptions": 0, "cancelled": 0, "host_syncs": 0,
                      "emitted_tokens": 0, "prefill_tokens": 0,
                      "prefill_ms": 0.0, "decode_ms": 0.0,
                      "drafted": 0, "accepted": 0, "acceptance_rate": 0.0,
                      "head_calls": {}}
        # repro_torch.probe.run_probe's report, when a caller parks one
        # here; snapshot() surfaces it as 'attn_probe'
        self.probe_report: Optional[dict] = None
        self._ttft_ms: List[float] = []
        self._consumers: List[Callable[[TokenChunk], None]] = []

    # -- event consumers -----------------------------------------------------
    def add_consumer(self, fn: Callable[[TokenChunk], None]) -> None:
        self._consumers.append(fn)

    def remove_consumer(self, fn: Callable[[TokenChunk], None]) -> None:
        self._consumers.remove(fn)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def snapshot(self) -> dict:
        """The counters plus derived scheduler state (JSON-ready): queue
        depth, active slots, and TTFT percentiles over every first token
        emitted so far."""
        s = dict(self.stats)
        s["head_calls"] = dict(self.stats["head_calls"])
        s["queue_depth"] = len(self.queue)
        s["active_slots"] = sum(sl is not None for sl in self.slots)
        s["attn_approx"] = self.cfg.attn_approx
        s["attn_window"] = self.cfg.attn_window
        if self.probe_report is not None:
            s["attn_probe"] = self.probe_report
        s["tokens_per_dispatch"] = (
            s["emitted_tokens"] / max(s["host_syncs"], 1))
        s["peak_in_use"] = self.store.allocator.peak_in_use
        if self._ttft_ms:
            t = np.asarray(self._ttft_ms)
            s["ttft_ms_p50"] = float(np.percentile(t, 50))
            s["ttft_ms_p99"] = float(np.percentile(t, 99))
        else:
            s["ttft_ms_p50"] = s["ttft_ms_p99"] = None
        return s

    # -- queue management ----------------------------------------------------
    def submit(self, req: Request):
        if req.params is None:
            req.params = SamplingParams(max_new_tokens=req.max_new_tokens,
                                        temperature=req.temperature,
                                        top_k=req.top_k)
        else:
            req.max_new_tokens = req.params.max_new_tokens
            req.top_k = req.params.top_k
            req.temperature = req.params.temperature
        if req.sampler is None:
            req.sampler = sampler_mod.resolve(
                req.params, cfg=self.cfg, default_head_mode=self.head_mode)
        else:
            req.sampler.validate(self.cfg)
        if req.params.spec_k > 0 and not (
                isinstance(req.sampler, sampler_mod.Greedy)
                and req.sampler.head_mode in ("reduced", "fused")):
            raise ValueError(
                f"spec_k={req.params.spec_k} requires the reduced "
                f"comparator head (engine head_mode={self.head_mode!r} "
                f"resolved to {req.sampler})")
        if req.params.attn_approx is not None \
                and req.params.attn_approx != self.cfg.attn_approx:
            raise ValueError(
                f"params.attn_approx={req.params.attn_approx!r} but this "
                f"engine runs attn_approx={self.cfg.attn_approx!r}; "
                "attention mode is engine-wide")
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if len(req.prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds max_len-1="
                f"{self.max_len - 1}")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            warnings.warn(
                f"request rid={req.rid}: prompt ({len(req.prompt)} tokens) "
                f"+ max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_len={self.max_len}; generation will stop early "
                "with finish_reason='max_len'", stacklevel=2)
        if req.rng is None:
            req.rng = np.random.default_rng(
                req.params.seed if req.params.seed is not None
                else [self.seed, req.rid])
        if req.orig_prompt is None:
            req.orig_prompt = np.asarray(req.prompt, np.int32).copy()
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def cancel(self, req: Request) -> bool:
        """Abort an unfinished request: free its slot's blocks (or drop it
        from the queue) and finish it with ``finish_reason='cancelled'``."""
        if req.done:
            return False
        for i, s in enumerate(self.slots):
            if s is req:
                self._release_slot(i)
                break
        else:
            try:
                self.queue.remove(req)
            except ValueError:
                return False              # unknown request
        req.finish_reason = "cancelled"
        req.t_done = time.perf_counter()
        req.done = True
        self.stats["cancelled"] += 1
        return True

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def _admit(self):
        """One-shot paged prefill of queued requests into free slots.

        Admission defers while the pool cannot cover the queue HEAD's
        prompt plus one decode block -- later requests never jump a
        deferred head, so FIFO admission is starvation-free."""
        for i in self._free_slots():
            if not self.queue:
                break
            req = self.queue[0]
            S = len(req.prompt)
            if not self.store.can_admit(S):
                self.stats["deferred"] += 1
                break
            self.queue.popleft()
            t0 = time.perf_counter()
            if req.t_admit is None:       # re-prefill keeps the first stamp
                req.t_admit = t0
            blocks = self.store.alloc_blocks(i, S)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None]
            out = api.serve_prefill_paged(
                self.params, self.cfg, tokens, self.store.prefill_len(S),
                req.sampler.device_form(), pools=self.store.pools,
                blocks=torch.as_tensor(blocks, dtype=torch.int64,
                                       device=self.device))
            out = _to_host(out)
            self._count_head(type(req.sampler).__name__)
            self.stats["prefill_ms"] += (time.perf_counter() - t0) * 1e3
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += S
            self.stats["host_syncs"] += 1
            self.slots[i] = req
            self.slot_pos[i] = S
            self.admit_order.append(i)
            self._emit(i, req, out, 0)

    def _preempt_youngest(self, keep: int) -> bool:
        """Pool exhausted mid-decode: push the most recently admitted slot
        (except ``keep``) back to the queue, freeing its blocks.  The
        request re-prefills later with its tokens so far as the prompt."""
        for i in reversed(self.admit_order):
            if i == keep or self.slots[i] is None:
                continue
            req = self.slots[i]
            # fold from ORIG_PROMPT: after a second preemption req.prompt
            # already holds the first fold's tokens
            req.prompt = np.concatenate(
                [np.asarray(req.orig_prompt, np.int32),
                 np.asarray(req.generated, np.int32)])
            self._release_slot(i)
            self.queue.appendleft(req)
            self.stats["preemptions"] += 1
            return True
        return False

    # -- main loop ------------------------------------------------------------
    def step(self):
        """One engine iteration: admit, then ONE fused ragged decode step
        over every active slot."""
        self.stats["iterations"] += 1
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            if self.queue and not self.store.can_admit(
                    len(self.queue[0].prompt)):
                # nothing is running, so every block is free -- if the head
                # request still doesn't fit it never will: fail loudly.
                req = self.queue[0]
                raise MemoryError(
                    f"request rid={req.rid} ({len(req.prompt)}-token "
                    f"prompt) can never be admitted: pool of "
                    f"{self.store.allocator.num_blocks} x "
                    f"{self.store.block_size}-token blocks is too small")
            return bool(self.queue)
        # capacity pass at each slot's OWN position; a later slot's ensure
        # may have PREEMPTED an earlier accepted one: re-validate after.
        active = [i for i in active
                  if self._ensure_blocks(i, int(self.slot_pos[i]))]
        active = [i for i in active if self.slots[i] is not None]
        if not active:
            return True
        self._decode_rows(active)
        return True

    def _count_head(self, kind: str) -> None:
        calls = self.stats["head_calls"]
        calls[kind] = calls.get(kind, 0) + 1

    def _propose(self, i: int) -> list:
        """Draft tokens for slot ``i`` this step (possibly none): ask the
        Drafter for up to the request's remaining speculation budget,
        then shrink the window to what the cache ceiling and the free
        block pool can hold -- speculation never preempts a neighbour,
        it just drafts less."""
        req = self.slots[i]
        k = req.params.spec_k
        if k <= 0:
            return []
        pos = int(self.slot_pos[i])
        # a draft window writes K/V at pos..pos+k and can emit up to
        # k+1 tokens: clamp to the remaining token budget and to the
        # max_len-1 cache ceiling.
        k = min(k, req.max_new_tokens - len(req.generated) - 1,
                self.max_len - 1 - pos)
        if k < 1:
            return []
        history = [int(t) for t in req.orig_prompt] \
            + [int(t) for t in req.generated]
        drafts = []
        for t in self.drafter.propose(history, k)[:k]:
            if not 0 <= int(t) < self.cfg.vocab_size:
                break             # a bad drafter id can never be accepted
            drafts.append(int(t))
        while drafts and not self.store.can_grow(i, pos + len(drafts),
                                                 write_start=pos):
            drafts.pop()
        if drafts and not self.store.ensure_capacity(i, pos + len(drafts),
                                                     write_start=pos):
            return []             # lost a race with another slot's growth
        return drafts

    def _decode_rows(self, rows: List[int]):
        """One fused decode step over the given slot rows -- ragged
        positions, mixed samplers, per-row draft widths: the host plan
        (``_plan_step``), the device body (``_step_body``, a CUDA graph
        replay on the card, ``step_graph``), then emission on the host.

        Rows with draft tokens this step (``_propose``) join the
        COMPARATOR-VERIFY group (``ops.verify_draft`` over their (T, D)
        hidden states); every other row rides along at width 1 and its
        head reads the last column, which is its real query.  The
        verified rows then emit their accepted run plus the comparator's
        correction token one at a time, so stop/eos/length/consumer
        semantics are those of non-speculative decoding; the position
        never advances over a rejected tail (``store.rewind`` returns
        surplus blocks)."""
        t0 = time.perf_counter()
        plan = self._plan_step(rows)
        _, outs = self._run_step(plan)
        for s in plan.order:
            self._count_head(type(s).__name__)
        if plan.spec:
            self._count_head("verify")
        self.stats["decode_steps"] += 1
        self.stats["host_syncs"] += 1
        self.stats["fused_rows"] += plan.n_real
        # one device->host copy per head group, not per slot
        host = {s: _to_host(o) for s, o in zip(plan.order, outs)}
        spec_host = _to_host(outs[-1]) if plan.spec else None
        self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
        for r in range(plan.n_real):
            i = plan.padded[r]
            dev, off = plan.where[r]
            req = self.slots[i]
            if dev is None:
                # speculative row: emit the accepted run plus the
                # correction token, one at a time (stop/eos/length fire
                # exactly as they would have, mid-run included)
                ids, acc = spec_host
                w = len(plan.drafts[i])
                m = min(int(acc[off]), w)
                self.stats["drafted"] += w
                self.stats["accepted"] += m
                for tok in ids[off, :m + 1]:
                    self.slot_pos[i] += 1
                    self._emit_token(i, req, int(tok))
                    if req.done:
                        break
                if not req.done:
                    # the rejected tail: the position never advanced over
                    # it; surplus whole blocks go back to the free list
                    self.store.rewind(i, int(self.slot_pos[i]))
            else:
                self.slot_pos[i] += 1
                self._emit(i, req, host[dev], off)
        if self.stats["drafted"]:
            self.stats["acceptance_rate"] = (
                self.stats["accepted"] / self.stats["drafted"])

    def _plan_step(self, rows: List[int]) -> StepPlan:
        """The host half of one fused step: drafts, padded rows, tokens,
        positions, block tables, the head groups' row vectors and the
        verify group's rows and draft ids, as numpy operands.

        Rows are padded to a power of two by repeating row 0 (identical
        compute; the duplicate K/V write lands the same value on the same
        cell) and block-table columns to a power of two with each row's
        own first block (past its position, so the mask discards them).
        Each head group's row-index vector, and the verify group's, is
        padded to B rows the same way: a bucket's key then follows B, not
        how its rows split between groups, so a speculative run's steps
        share few graphs (the argmax and verify heads stream W once per
        64 rows, so their padding rows cost next to nothing).  A
        draft row widens the step to T = pow2(widest window): it carries
        its last token plus its drafts at consecutive positions; the
        other rows' padding queries repeat their last (token, position)
        -- a cache no-op."""
        n_real = len(rows)
        drafts = {i: self._propose(i) for i in rows}
        T = _pow2(max(1 + len(drafts[i]) for i in rows))
        padded = rows + [rows[0]] * (_pow2(n_real) - n_real)
        groups: Dict[Sampler, list] = {}
        spec_group: list = []            # padded-row indices that verify
        # row r -> (its head group, offset), or (None, offset in the
        # verify group) for a draft row; a mid-prefill chunk row, when
        # chunked prefill is ported, is (None, None): it joins no group.
        where = []
        for r, i in enumerate(padded):
            if drafts[i]:
                where.append((None, len(spec_group)))
                spec_group.append(r)
            else:
                dev = self.slots[i].sampler.device_form()
                lst = groups.setdefault(dev, [])
                where.append((dev, len(lst)))
                lst.append(r)
        order = sampler_mod.canonical_order(groups)
        toks = np.zeros((len(padded), T), np.int64)
        posm = np.zeros((len(padded), T), np.int32)
        for r, i in enumerate(padded):
            win = [self.slots[i].generated[-1]] + drafts[i]
            w = len(win)
            base = int(self.slot_pos[i])
            toks[r, :w] = win
            toks[r, w:] = win[-1]        # repeat last (token, position):
            posm[r, :w] = base + np.arange(w)
            posm[r, w:] = base + w - 1   # identical value, identical cell
        btab = self.store.block_table(padded, posm[:, -1])
        b = len(padded)
        group_rows = [np.asarray(g + [g[0]] * (b - len(g)), np.int64)
                      for g in (groups[s] for s in order)]
        arrays = [toks, posm if T > 1 else np.ascontiguousarray(posm[:, 0]),
                  btab, *group_rows]
        spec = 0
        if spec_group:
            sg = spec_group + [spec_group[0]] * (b - len(spec_group))
            cand = np.full((len(sg), T - 1), -1, np.int32)
            for o, r in enumerate(sg):
                d = drafts[padded[r]]
                cand[o, :len(d)] = d
            arrays += [np.asarray(sg, np.int64), cand]
            spec = len(sg)
        key = step_graph.bucket_key(order, toks.shape, btab.shape,
                                    [len(g) for g in group_rows], spec)
        return StepPlan(n_real, padded, drafts, where, order, tuple(arrays),
                        spec, key)

    def _run_step(self, plan: StepPlan):
        """The device half of ``plan``: (h, head outputs) -- a graph
        replay of its bucket on the card (``step_graph.graphed``), else
        ``_step_body`` eagerly."""
        body = functools.partial(self._step_body, tuple(plan.order))
        if step_graph.graphed(self.device):
            return self.graphs.run(plan.key, body, plan.arrays, self.device)
        return body(*step_graph.to_device(plan.arrays, self.device))

    def _step_body(self, order: tuple, toks, pos, btab, *rest):
        """The fused step on the card: the trunk ONCE over all rows (the
        pools written in place), then one head per group in ``order``
        over its rows (``rest``'s first vectors), then, when ``rest``
        also holds the verify group's rows and draft ids, the comparator
        verify over their (T, D) hidden states.  It reads its inputs only
        from the tensors it is handed, so a captured body replays over
        new ones.  Returns (h, outputs), the verify group's last."""
        h, _ = lm.decode_step(self.params, self.cfg, toks,
                              self.store.cache(), pos, block_tables=btab,
                              layers=self._layers)
        hl = h[:, -1] if h.dim() == 3 else h   # each row's last real query
        outs = [s.head(self.params, self.cfg, hl[r])
                for s, r in zip(order, rest)]
        if len(rest) > len(order):
            srows, cand = rest[len(order):]
            outs.append(ops.verify_draft(
                h[srows], lm.lm_head_weight(self.params, self.cfg), cand))
        return h, tuple(outs)

    def _ensure_blocks(self, i: int, pos: int) -> bool:
        """Grow slot i's block table to cover ``pos``; preempt the
        youngest other slot if the pool is dry."""
        if self.slots[i] is None:      # preempted earlier this iteration
            return False
        while not self.store.ensure_capacity(i, pos):
            if not self._preempt_youngest(keep=i):
                raise MemoryError(
                    "paged KV pool too small for a single sequence: "
                    f"pos={pos} block_size={self.store.block_size} "
                    f"num_blocks={self.store.allocator.num_blocks}")
        return self.slots[i] is not None

    def _release_slot(self, i: int):
        self.store.release(i)
        self.slots[i] = None
        self.admit_order.remove(i)

    def _emit(self, i: int, req: Request, host_out, off: int):
        """One token emission off a sampler head output: pick on the host
        (plus the candidate ids of the k-winner bus when the request asks
        for them), then the shared emission path."""
        tok = req.sampler.pick(host_out, off, req.rng)
        cands = None
        if self._consumers and req.params.n_candidates:
            c = req.sampler.candidate_ids(host_out, off)
            if c is not None:
                cands = tuple(int(x) for x in c[:req.params.n_candidates])
        self._emit_token(i, req, int(tok), cands)

    def _emit_token(self, i: int, req: Request, tok: int, cands=None):
        """The shared per-token emission path (sampler picks and verified
        speculative runs alike): stop-sequence match, completion check,
        then a TokenChunk to every consumer (with finish_reason set when
        this token finished the request)."""
        req.generated.append(tok)
        self.stats["emitted_tokens"] += 1
        if req.t_first is None:
            req.t_first = time.perf_counter()
            self._ttft_ms.append((req.t_first - req.t_submit) * 1e3)
        for s in req.params.stop:
            if len(req.generated) >= len(s) \
                    and tuple(req.generated[-len(s):]) == s:
                req.finish_reason = "stop"
                break
        self._check_done(i)
        if self._consumers:
            chunk = TokenChunk(rid=req.rid, token=int(tok),
                               index=len(req.generated) - 1,
                               finish_reason=req.finish_reason,
                               candidate_ids=cands)
            for fn in list(self._consumers):
                fn(chunk)

    def _check_done(self, i: int):
        req = self.slots[i]
        if req is None:
            return
        if req.finish_reason == "stop":
            pass                      # a params.stop sequence matched
        elif req.generated and req.generated[-1] == self.eos_id:
            req.finish_reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "length"
        elif self.slot_pos[i] >= self.max_len - 1:
            # cache ceiling: the request is TRUNCATED short of its
            # max_new_tokens (submit warned about this combination)
            req.finish_reason = "max_len"
        else:
            return
        # stamp BEFORE done=True: unsynchronized readers poll req.done
        req.t_done = time.perf_counter()
        req.done = True
        self.stats["completed"] += 1
        self._release_slot(i)     # blocks back to the free list

    def run(self, max_iters: int = 1000):
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self.step()
            it += 1
        return self.stats
