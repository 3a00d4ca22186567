"""Serving engine: continuous batching over a paged KV cache, with the
reduced softmax unit as the decode head.

Counterpart of ``repro.serve.engine`` on its default path:

  - fixed ``n_slots`` decode slots over a SHARED, BLOCK-PAGED KV pool
    (``serve/paged_kv.py``); slots free their blocks on eos / length /
    stop and are refilled from the queue;
  - admission is ONE-SHOT and paged by default: a queued request gets
    its prompt's block cover, one prefill writes the prompt's K/V
    straight into those blocks and its head emits the first token.
    Admission defers at the queue head while the pool cannot cover the
    prompt plus one decode block; a dry pool mid-decode preempts the
    youngest slot back to the queue (it re-prefills later with its
    tokens so far).  At most ``prefill_per_step`` admissions an
    iteration;
  - prefill is CHUNKED on request (``chunk_size=C``): admission only
    assigns the slot and reserves its first chunk's blocks, and the
    prompt enters ``C`` tokens at a time as PREFILL-CHUNK ROWS of the
    same fused step that serves the decode rows (on the card, inside its
    graph).  A mid-prefill chunk row only writes K/V and joins no head
    group; a FINAL chunk's last position feeds the row's sampler head
    and emits the first token.  ``token_budget`` caps the real tokens a
    step carries (chunks narrow, every prefilling slot keeps >= 1
    token); admissions after the queue head are packed by LENGTH BUCKET
    (pow-2 first-chunk width, ``pack_lookahead`` past the head).  Chunk
    rows attend with the engine's ``attn_approx`` and ``attn_window``;
  - PREFIX SHARING rides chunked admission (``prefix_cache``, on by
    default, inert without ``chunk_size``): a released request
    publishes its full-block token runs into the store's trie, a new
    request adopts the longest cached run and prefills only its suffix,
    and every write to a shared block copies it first on the card
    (``serve/paged_kv.py``);
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

  - decode is DEVICE-RESIDENT on request (``host_stride=K``): one
    dispatch runs up to K fused T-1 iterations on the device, each
    sampling with per-request keys (``Sampler.sample_device``,
    ``repro_torch.prng``) and feeding the sampled token to the next
    (``models.api.serve_decode_multi``); the host drains the (B, K)
    token block through the per-token emission path, trimming at a stop
    sequence or a cancel and rewinding the surplus blocks.  On the card
    the iteration is one CUDA graph replayed K times with no host sync
    between replays (``step_graph.StepGraphs.run_loop``).  Iterations
    that carry a mid-prefill chunk row run the single fused step, keyed.
    Every keyed draw of such an engine (the loop's, a prefill's first
    token, a chunk iteration's) runs on the engine's device, so the
    tokens do not depend on the stride;

  - attention's score function is engine-wide: ``attn_approx`` (the
    ``core.attn_approx`` catalog) and ``attn_window`` replace the cfg's
    and reach every decode and chunk row's paged attention; the one-shot
    prefill attends exactly over the whole prompt, as in the JAX package.

The HYBRID family (recurrentgemma: RG-LRU ``rec`` layers between
windowed ``attn`` layers) is served through the dense per-slot store
whatever ``kv_layout`` asks: ring buffers of ``min(max_len, window)``
rows and the recurrent state, one row a slot, written in place by the
step (a step gathers every row's old state before it writes any, so a
padding row repeating a live slot writes the same new state twice, never
advances it twice).  As in the reference, it has no speculation
(``spec_k`` is refused at submit: a ring or a recurrence cannot rewind a
rejected draft), and ``chunk_size`` and ``host_stride`` warn and fall
back to one-shot admission and per-token dispatch (``spec_capable``,
``chunk_capable``, ``multistep_capable``); prefix sharing is off with
chunking.  On the card its T = 1 step is captured per bucket like the
dense layout's.  The SSM family (rwkv6: every layer an ``rwkv`` time-mix
+ channel-mix with per-slot ``shift1`` / ``shift2`` / ``wkv`` state, no
attention) takes the same store, gates and graphs; its step builds no
RoPE table and no cache cells.  The MOE family (phi3.5-moe, llama4-
maverick) pages its K/V like the dense family (each slot of its block
program a view of the pools, ``lm.pool_tree``) and takes the same gates
as the recurrent families: its capacity-dropping routing makes a token's
output depend on the rest of the step's batch, padding rows included,
so a draft window would shift the capacity ranks (``spec_k`` refused),
and chunking and the device loop fall back; its T = 1 step (the
``scatter`` executor: routing, ranks and the spare row all on the
device) is captured per bucket like the dense one.  The VLM family
(internvl2) is the dense family to the engine: token prompts, paged,
every path open; its image prefix enters through ``lm.prefill`` only, as
the reference's engine takes no image embeddings.  An ENC-DEC config
(seamless) is refused at construction: the reference's engine takes
token prompts only and fails at its first prefill without source
embeddings.

``kv_layout='dense'`` keeps the reference's per-slot ``max_len`` cache,
the byte-identity oracle of the paged path: admission is a dense
prefill copied into the slot's row (``api.serve_prefill``,
``PagedKVStore.admit``), and the step's trunk writes the rows in place
and attends over them in plain torch (``layers._dense_attention``); the
approximate score modes, chunking and prefix sharing need the paged
layout.  ``scheduler='cohort'`` is the reference's baseline scheduler:
one step per (position, device-form sampler) group of the active slots,
so ``decode_steps`` exceeds ``iterations``; it has no multi-token step
(no chunking, no speculation) and no device loop.  Both run on the card
as the fused paged step does, graphed per bucket.

TENSOR PARALLELISM (``tp=N`` with ``group=``, a ``parallel.comm.Group``
of world N; the counterpart of the reference's ``tp=``/``mesh=``).  The
process model, decided once:

  - SPMD, not a single controller: one process per rank, each building
    this same engine over its Megatron slice of the weights
    (``weights.shard_params``: heads whole, column-parallel QKV and
    up/gate, row-parallel ``wo``/``w_out`` each followed by an
    all-reduce, the vocabulary split along V; a ``rec`` layer's RG-LRU
    gate blocks and an ``rwkv`` layer's heads whole too) and its
    kv-head slice of the paged pools, or its channels of the per-slot
    recurrent states (``sharding.local_config``; ``self.cfg`` is the
    rank's view, the vocabulary whole).  Every served family splits so:
    dense, vlm, moe, hybrid and ssm; a hybrid or ssm engine stays
    unpaged and not ``spec_capable`` under tp, as it is unsharded.  Every rank runs the same host
    scheduler and steps together.  The comparator heads run on the
    rank's vocabulary slice and one all-gather of (val, idx) tables picks
    the winner (``core.reduced_softmax``), so ``reduced``/``fused`` are
    upgraded to ``sharded`` as in the reference; speculative verify goes
    through ``sharded_verify_draft``.  ``head_mode='sharded'`` on a group
    with ``tp`` None keeps the trunk whole and shards only the head.
  - Every rank makes the same plan.  Rank 0 owns the front: ``submit``
    and ``cancel`` there queue for the next iteration, whose first act is
    one pickled broadcast of the new requests and cancels over the
    group's CPU control group (``_sync``); the other ranks' ``submit``
    only names the ``Request`` object rank 0's copy will fill, matched by
    rid.  So every rank's queue, allocator, prefix trie and numpy
    sampling streams see the same inputs in the same order.  Then each
    plan -- the admitted requests, every one-shot prefill, every step's
    rows, positions, block tables and head groups -- is hashed to one
    int64 and all-gathered (``comm.Group.agree``): ranks that differ
    raise ``RuntimeError`` together instead of deadlocking a later
    collective or corrupting the cache without a word.
  - A dead rank fails the others within the group's timeout (every
    collective has one).
  - A long-lived front (the HTTP server) steps rank 0's engine from
    ``serve.api.LLM``'s pump, whose control message each tick tells the
    other ranks to step too (``LLM.follow``); a rank-group
    ``serve.router.Router`` routes between such groups.
  - Devices: rank r takes ``cuda:(LOCAL_RANK % device_count)``; several
    ranks share one card over gloo, which stages through the host.
  - Graphs: a step whose collectives go through gloo cannot be captured,
    so a sharded engine runs the eager step body (and an eager
    ``host_stride`` loop, the same tokens); ``engine.graphs`` counts no
    capture.  Capturing the step over NCCL is left for several cards.

``mesh=`` is refused (``NotImplementedError``: the port's counterpart is
``group=``), and values wrong in both packages raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attn_approx as approx
from repro_torch.core import reduced_softmax
from repro_torch.kernels import ops
from repro_torch.models import api, lm
from repro_torch.parallel import sharding
from repro_torch.serve import sampler as sampler_mod
from repro_torch.serve import step_graph
from repro_torch.serve.outputs import TokenChunk
from repro_torch.serve.paged_kv import PagedKVStore, pow2 as _pow2
from repro_torch.serve.params import SamplingParams
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.spec import PromptLookupDrafter
from repro_torch.weights import cast_params, detached, shard_params


def _to_device(tree, device):
    """A param tree's leaves (tensors or numpy arrays) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


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
    # the keyed counterpart on a host_stride engine: a (2,) int64 key
    # (``repro_torch.prng``), key(params.seed) or fold_in(key(engine
    # seed), rid), split once per token its sampler draws
    prng_key: Optional[torch.Tensor] = None
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
    ``drafts`` each slot's draft tokens; ``chunks`` each prefilling
    slot's chunk window (start, width); ``where`` each padded row's
    (head group, offset), (None, offset in the verify group) for a draft
    row, or (None, None) for a mid-prefill chunk row;
    ``order`` the head groups in ``canonical_order``; ``arrays`` the
    device body's operands on the host -- tokens (B, T) int64, positions
    (B,) or (B, T) int32, the cache index (``ServeEngine._kv_index``:
    block tables (B, nb) int32, or each row's slot (B,) int64 on the
    dense layout), one (B,) int64 row
    vector per group, then the verify group's (B,) rows and (B, T-1)
    int32 draft ids when ``spec`` (B, its padded row count) is not 0;
    ``key`` the ``step_graph.bucket_key``."""
    n_real: int
    padded: list
    drafts: dict
    chunks: dict
    where: list
    order: list
    arrays: tuple
    spec: int
    key: tuple


@dataclasses.dataclass
class LoopPlan:
    """The host half of one device-resident dispatch
    (``ServeEngine._plan_multi``): ``padded`` the slot of each padded row
    (the first ``n_real`` real), ``order`` the full samplers of the
    groups, ``arrays`` the loop's operands on the host -- the carry
    (``api.MultiCarry``'s fields in order: last tokens (B,) int64, next
    write positions (B,) int32, keys (B, 2) int64, emitted, halted, the
    (B, K) out block, the step index, the emit caps), the cache index
    (as ``StepPlan``'s) and each group's (B,) int64 rows; ``steps`` the
    iterations a graph replays (the largest cap); ``key`` the
    ``step_graph.loop_key``."""
    n_real: int
    padded: list
    order: list
    arrays: tuple
    steps: int
    key: tuple


class ServeEngine:
    def __init__(self, params: dict, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 head_mode: str = "reduced", kv_layout: str = "paged",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_per_step: Optional[int] = None,
                 scheduler: str = "fused", mesh=None, seed: int = 0,
                 drafter=None, chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 host_stride: Optional[int] = None,
                 prefix_cache: bool = True,
                 attn_approx: Optional[str] = None,
                 attn_window: Optional[int] = None,
                 tp: Optional[int] = None, group=None):
        if scheduler not in ("fused", "cohort"):
            raise ValueError(f"scheduler={scheduler!r}: expected 'fused' "
                             "(one step per iteration) or 'cohort'")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout={kv_layout!r}: expected 'paged' "
                             "or 'dense'")
        if cfg.n_encoder_layers:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder config is not served -- the "
                "reference's engine takes token prompts only and has no "
                "source embeddings to encode (run lm.prefill / "
                "lm.decode_step with src_embeds instead)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the port runs one process per rank; pass group= (a "
                "repro_torch.parallel.comm.Group) and tp=")
        if tp is not None and tp < 1:
            raise ValueError(f"tp={tp}: must be >= 1 (or None)")
        tp = 1 if tp is None else int(tp)
        if tp > 1 and (group is None or group.world != tp):
            raise ValueError(
                f"tp={tp} needs a process group of world {tp} (group=); got "
                f"{group!r}")
        if head_mode == "sharded" and group is None:
            raise ValueError("head_mode='sharded' requires group= (the "
                             "ranks the vocabulary is split over)")
        if tp > 1 and head_mode in ("reduced", "fused"):
            head_mode = "sharded"
        if prefill_per_step is not None and prefill_per_step < 1:
            raise ValueError(
                f"prefill_per_step={prefill_per_step}: must be >= 1 "
                "(or None for unlimited); 0 would serve nothing forever")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size={chunk_size}: must be >= 1 "
                             "(or None for one-shot prefill)")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget={token_budget}: must be >= 1 "
                             "(or None for unlimited)")
        if host_stride is not None and host_stride < 1:
            raise ValueError(f"host_stride={host_stride}: must be >= 1 "
                             "(or None for per-token host dispatch)")
        # the kwargs override the cfg's modes (None keeps the cfg's);
        # 'exact' + None replace to an equal cfg
        if attn_approx is not None or attn_window is not None:
            mode, win = approx.resolve(
                attn_approx if attn_approx is not None else cfg.attn_approx,
                attn_window if attn_window is not None else cfg.attn_window)
            cfg = dataclasses.replace(cfg, attn_approx=mode,
                                      attn_window=win)
        # a windowed config (the hybrid family's ring buffers) is never
        # paged, whatever kv_layout asks (PagedKVStore.pages)
        pages = PagedKVStore.pages(cfg, kv_layout)
        # the approximate score functions and the mask window live in the
        # paged decode path only: on a dense store they would never run
        if (cfg.attn_approx != "exact" or cfg.attn_window is not None) \
                and not pages:
            raise ValueError(
                f"attn_approx={cfg.attn_approx!r} / attn_window="
                f"{cfg.attn_window!r} need the paged decode path; "
                f"kv_layout={kv_layout!r} on this config has no paged "
                "layers, so the mode would never run")
        # speculation rewrites per-token cache state by position masks,
        # which only linear-attention KV supports: a ring buffer loses
        # history on overwrite and recurrent state cannot rewind a
        # rejected draft (reference engine.py:432-433)
        self.spec_capable = (cfg.attention_window is None and all(
            k == "attn" for k in lm.layer_types(cfg)))
        # chunked prefill rides the same multi-token step, plus a paged
        # store (chunks allocate as they go) and the fused scheduler; the
        # device loop re-runs halted rows at their last (token, position),
        # an idempotent rewrite only for linear attention.  Either falls
        # back, loudly, as in the reference.
        self.chunk_capable = (self.spec_capable and pages
                              and scheduler == "fused")
        if chunk_size is not None and not self.chunk_capable:
            warnings.warn(
                f"chunk_size={chunk_size} ignored: chunked prefill needs "
                "pure linear-attention decode, a paged KV layout and "
                "scheduler='fused'; falling back to one-shot admission",
                stacklevel=2)
            chunk_size = None
        self.multistep_capable = self.spec_capable and scheduler == "fused"
        if host_stride is not None and not self.multistep_capable:
            warnings.warn(
                f"host_stride={host_stride} ignored: the device-resident "
                "decode loop needs pure linear-attention decode and "
                "scheduler='fused'; falling back to per-token dispatch",
                stacklevel=2)
            host_stride = None
        if group is not None:
            dev = group.device
            if tp > 1 or head_mode == "sharded":
                # the rank's slice, cut on the host before it goes to the
                # card; cfg becomes the rank's view (cfg.shard the split)
                split = sharding.plan(
                    cfg, group.rank, group.world, trunk=tp > 1, group=group,
                    max_bytes_per_rank=(torch.cuda.get_device_properties(
                        dev).total_memory if dev.type == "cuda" else None))
                params = shard_params(params, cfg, split)
                cfg = sharding.local_config(cfg, split)
            params = _to_device(params, dev)
        # f32 master weights -> the compute dtype, ONCE (the JAX package
        # casts inside every jitted step); detached, so masters a training
        # step made serve without autograd (the kernels have no backward)
        self.params = cast_params(detached(params), cfg)
        self.device = self.params["embed"].device
        self.tp = tp
        self.group = group
        # several ranks: the control plane and the plan digests run
        self._spmd = group is not None and group.world > 1
        self._outbox: List["Request"] = []    # rank 0: not yet broadcast
        self._cancels: List[int] = []         # rank 0: rids to cancel
        self._expect: Dict[int, "Request"] = {}  # other ranks: by rid
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.head_mode = head_mode
        self.scheduler = scheduler
        self.seed = seed
        self.prefill_per_step = prefill_per_step
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        self.host_stride = host_stride
        # prefix sharing needs chunked admission: a trie hit starts the
        # prefill at the suffix boundary mid-prompt, which only chunk
        # rows can do (a one-shot prefill writes from position 0)
        self.prefix_cache = bool(prefix_cache) and chunk_size is not None
        # bounded lookahead past the queue head for length-bucketed
        # chunked admission (1 = strict FIFO)
        self.pack_lookahead = 8
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
                                  num_blocks=num_blocks, layout=kv_layout)
        # every layer's param views, built once (lm.layer_params); the
        # decode step's CUDA graphs, one per shape bucket (step_graph)
        self._layers = lm.layer_params(self.params, cfg)
        self.graphs = step_graph.StepGraphs()
        # decode_steps counts decode calls, iterations engine loop turns
        # (decode_steps == iterations whenever a slot is active),
        # decode_iterations the trunk passes the decode calls ran (one a
        # step, up to host_stride a device-resident dispatch);
        # fused_rows counts real (non-padding) rows over those calls;
        # prefills counts completed prompt prefills (one-shot calls or
        # final chunks), prefill_chunks the chunk rows served,
        # prefill_tokens the prompt tokens actually prefilled, and
        # prefix_hits / prefix_hit_tokens the admissions that adopted a
        # cached run and the tokens they skipped; host_syncs every
        # dispatch with a device->host read (prefills + decode steps, a
        # host_stride loop of K iterations counting one of each);
        # emitted_tokens every token through _emit_token, so
        # tokens_per_dispatch (snapshot) is what a stride amortised.
        # prefill_ms and decode_ms sum the host wall clock of the prefill calls and the
        # decode steps, each up to its head output on the host (which
        # waits for the device).  drafted/accepted count speculative draft
        # tokens proposed / accepted by the comparator, acceptance_rate
        # their ratio.  head_calls counts head calls by sampler kind
        # ('Greedy', 'TopK', ...; 'verify' for a step's speculative
        # group): one head call is one kernel launch on the card.
        self.stats = {"prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
                      "decode_iterations": 0, "iterations": 0,
                      "fused_rows": 0, "completed": 0,
                      "deferred": 0, "preemptions": 0, "cancelled": 0,
                      "host_syncs": 0, "emitted_tokens": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      "prefill_tokens": 0,
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
        return (bool(self.queue) or any(s is not None for s in self.slots)
                or bool(self._outbox) or bool(self._expect))

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
        # tensor parallelism: the split, the data backend, and the bytes
        # each kind of collective left on this rank (comm.Group.bytes)
        s["tp"] = self.tp
        s["backend"] = None if self.group is None else self.group.backend
        s["collective_bytes"] = ({} if self.group is None
                                 else dict(self.group.bytes))
        s["cow_copies"] = self.store.cow_copies
        s["shared_blocks"] = self.store.allocator.n_shared
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
        """Validate ``req`` and queue it.  On a rank of several, rank 0's
        request joins the queue at the next iteration's broadcast and
        another rank's names the object rank 0's copy fills (by rid)."""
        self._prepare(req)
        if not self._spmd:
            self._enqueue(req)
        elif self.group.rank == 0:
            self._outbox.append(req)
        else:
            self._expect[req.rid] = req

    def _prepare(self, req: Request) -> None:
        """The submit gates: params, sampler, modes, lengths."""
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
        if req.params.attn_approx is not None \
                and req.params.attn_approx != self.cfg.attn_approx:
            raise ValueError(
                f"params.attn_approx={req.params.attn_approx!r} but this "
                f"engine runs attn_approx={self.cfg.attn_approx!r}; "
                "attention mode is engine-wide")
        if self.host_stride is not None:
            self._gate_keyed(req)
        if req.params.spec_k > 0 and not (
                isinstance(req.sampler, sampler_mod.Greedy)
                and req.sampler.head_mode in ("reduced", "fused",
                                              "sharded")):
            raise ValueError(
                f"spec_k={req.params.spec_k} requires the reduced "
                f"comparator head (engine head_mode={self.head_mode!r} "
                f"resolved to {req.sampler})")
        if req.params.spec_k > 0 and not self.spec_capable:
            raise ValueError(
                f"spec_k={req.params.spec_k}: speculative decoding needs "
                "pure linear-attention decode (no sliding window or "
                "recurrent state — rejected drafts cannot be rewound; no "
                "capacity-dropping MoE routing — draft tokens would shift "
                "expert capacity and break bit-exactness); the "
                f"{self.cfg.family!r} config does not qualify")
        if req.params.spec_k > 0 and self.scheduler != "fused":
            raise ValueError(
                f"spec_k={req.params.spec_k} requires scheduler='fused' "
                "(the cohort baseline has no multi-token step)")
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

    def _enqueue(self, req: Request) -> None:
        """Seed the request's stream and join the queue."""
        if req.rng is None:
            req.rng = np.random.default_rng(
                req.params.seed if req.params.seed is not None
                else [self.seed, req.rid])
        if req.orig_prompt is None:
            req.orig_prompt = np.asarray(req.prompt, np.int32).copy()
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _gate_keyed(self, req: Request) -> None:
        """A host_stride engine's submit gates, then the request's key:
        what the device loop cannot run is refused (draft windows, the
        candidate bus, samplers with no device form)."""
        if req.params.spec_k > 0:
            raise ValueError(
                f"spec_k={req.params.spec_k} and host_stride="
                f"{self.host_stride} are mutually exclusive: both amortize "
                "the per-token host round-trip and the device loop has no "
                "draft-verify group")
        if req.params.n_candidates > 0:
            raise ValueError(
                f"n_candidates={req.params.n_candidates} is not available "
                "on a host_stride engine: the device loop consumes the "
                "k-winner bus on the device and ships only token ids")
        if type(req.sampler).sample_device is Sampler.sample_device:
            raise ValueError(
                f"{req.sampler} has no device sampling form "
                "(Sampler.sample_device) and cannot ride a host_stride "
                "engine")
        if req.prng_key is None:
            # the keyed analogue of req.rng: params.seed pins the stream,
            # (engine seed, rid) keeps requests distinct
            req.prng_key = (prng.key(req.params.seed)
                            if req.params.seed is not None
                            else prng.fold_in(prng.key(self.seed), req.rid))

    def cancel(self, req: Request) -> bool:
        """Abort an unfinished request: free its slot's blocks (or drop it
        from the queue) and finish it with ``finish_reason='cancelled'``.
        On a rank of several this takes effect at the next iteration's
        broadcast, and only rank 0's call counts."""
        if self._spmd:
            if req.done:
                return False
            if self.group.rank == 0:
                self._cancels.append(req.rid)
            return True
        return self._cancel_now(req)

    def _cancel_now(self, req: Request) -> bool:
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

    def _prefilling(self, i: int) -> bool:
        """Whether slot ``i`` is mid-chunked-prefill: its write cursor
        (``slot_pos``) has not yet covered its prompt.  Only ever True
        under ``chunk_size``: one-shot admission writes the whole prompt
        before the slot is visible."""
        req = self.slots[i]
        return req is not None and int(self.slot_pos[i]) < len(req.prompt)

    def _admit(self):
        """Prefill queued requests into free slots, at most
        ``prefill_per_step`` an iteration.

        Admission defers while the pool cannot cover the queue HEAD's
        prompt plus one decode block -- later requests never jump a
        deferred head, so FIFO admission is starvation-free.  Under
        ``chunk_size`` admission only assigns the slot
        (``_admit_chunked``); the step writes the prompt chunk by
        chunk."""
        if self.chunk_size is not None:
            return self._admit_chunked()
        budget = self.prefill_per_step
        for i in self._free_slots():
            if not self.queue or budget == 0:
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
            prompt = np.asarray(req.prompt, np.int64)
            tokens = torch.as_tensor(prompt, device=self.device)[None]
            plen = self.store.prefill_len(S)
            if self.store.any_paged:
                blocks = self.store.alloc_blocks(i, S)
                self._agree("a one-shot prefill", i, req.rid, prompt,
                            np.asarray(blocks, np.int64))
                # the prefill writes [0, S) in place, so a shared cover
                # would have to be copied here; one-shot slots only hold
                # the fresh blocks just allocated (adoption is
                # chunked-only), so this is the enforced no-op form of the
                # copy-on-write rule
                self.store.cow_for_write(i, 0, S - 1)
                dev_out = api.serve_prefill_paged(
                    self.params, self.cfg, tokens, plen,
                    req.sampler.device_form(), pools=self.store.pools,
                    blocks=torch.as_tensor(blocks, dtype=torch.int64,
                                           device=self.device))
            else:
                self._agree("a one-shot prefill", i, req.rid, prompt)
                dev_out, cache1 = api.serve_prefill(
                    self.params, self.cfg, tokens, plen,
                    req.sampler.device_form())
                self.store.admit(i, cache1)
            out = _to_host(dev_out)
            self._count_head(type(req.sampler).__name__)
            self.stats["prefill_ms"] += (time.perf_counter() - t0) * 1e3
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += S
            self.stats["host_syncs"] += 1
            self.slots[i] = req
            self.slot_pos[i] = S
            self.admit_order.append(i)
            self._emit(i, req, out, 0, dev_out)
            if budget is not None:
                budget -= 1

    def _admit_chunked(self):
        """Chunked admission: assign free slots and reserve each
        request's FIRST chunk cover; the fused step writes the chunks.

        The queue HEAD is always offered first and deferral stops there,
        as in one-shot admission.  Admissions after the head within one
        iteration are packed by LENGTH BUCKET: within ``pack_lookahead``
        of the head, the first admissible request whose pow-2
        first-chunk width matches the bucket this iteration already pays
        for, so one short prompt beside a long one does not widen T for
        every row.  A skipped request keeps (or reaches) the head."""
        budget = self.prefill_per_step
        bucket = None
        for i in self._free_slots():
            if not self.queue or budget == 0:
                break
            if not self.store.can_admit(len(self.queue[0].prompt),
                                        self.chunk_size):
                self.stats["deferred"] += 1
                break
            pick = 0
            if bucket is not None:
                for j in range(min(self.pack_lookahead, len(self.queue))):
                    cand = self.queue[j]
                    if (_pow2(min(self.chunk_size, len(cand.prompt)))
                            == bucket
                            and self.store.can_admit(len(cand.prompt),
                                                     self.chunk_size)):
                        pick = j
                        break
            req = self.queue[pick]
            del self.queue[pick]
            if req.t_admit is None:       # re-prefill keeps the first stamp
                req.t_admit = time.perf_counter()
            hit = 0
            if self.prefix_cache and req.params.prefix_cache:
                # map the longest cached whole-block run into the slot's
                # table; the prefill starts at the suffix boundary.
                # Adoption precedes the reserve so that eviction under
                # pressure cannot reclaim the run first.
                hit = self.store.adopt_prefix(i, req.prompt)
                if hit:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += hit
            width = min(self.chunk_size, len(req.prompt) - hit)
            bucket = _pow2(width)
            # reserve the first chunk's cover now, so this iteration's
            # later can_admit checks see the honest free count
            self.store.ensure_capacity(i, hit + width - 1, write_start=hit)
            self.slots[i] = req
            self.slot_pos[i] = hit        # write cursor: suffix starts here
            self.admit_order.append(i)
            if budget is not None:
                budget -= 1

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

    # -- the control plane (several ranks) -----------------------------------
    def _sync(self) -> None:
        """Rank 0's new requests and cancels, broadcast and applied in the
        same order on every rank; the admitted requests' content is then
        agreed (a rank handed a different request fails the group)."""
        rank0 = self.group.rank == 0
        msg = None
        if rank0:
            msg = ([(r.rid, np.asarray(r.prompt), r.params, r.sampler)
                    for r in self._outbox], list(self._cancels))
        new, cancels = self.group.broadcast_object(msg)
        seen = []
        for n, (rid, prompt, params, smp) in enumerate(new):
            if rank0:
                req = self._outbox[n]
            else:
                req = self._expect.pop(rid, None)
                if req is None:          # a rank with no caller of its own
                    req = Request(rid, np.asarray(prompt, np.int32).copy(),
                                  params=params, sampler=smp)
                    self._prepare(req)
            seen.append((rid, np.asarray(req.prompt, np.int32).tobytes(),
                         req.params, req.sampler))
            self._enqueue(req)
        self._outbox.clear()
        self._cancels.clear()
        if seen:
            self._agree("the requests admitted", seen)
        for rid in cancels:
            live = [r for r in self.slots if r is not None and r.rid == rid]
            live += [r for r in self.queue if r.rid == rid]
            if live:
                self._cancel_now(live[0])

    def _agree(self, what: str, *parts) -> None:
        """Several ranks: hash ``parts`` (numpy arrays by their bytes,
        anything else by its repr) to one int64 and all-gather it; ranks
        that differ raise ``RuntimeError`` together."""
        if not self._spmd:
            return
        h = hashlib.blake2b(digest_size=8)
        for p in parts:
            h.update(np.ascontiguousarray(p).tobytes()
                     if isinstance(p, np.ndarray) else repr(p).encode())
        self.group.agree(int.from_bytes(h.digest(), "little", signed=True),
                         what)

    def _graphed(self) -> bool:
        """Whether the device half runs as a CUDA graph: on the card, and
        only when no collective runs inside the step (gloo syncs with the
        host; a sharded head gathers)."""
        return step_graph.graphed(self.device) and self.cfg.shard is None

    # -- main loop ------------------------------------------------------------
    def step(self):
        """One engine iteration: admit, then ONE fused ragged step over
        every active slot -- decode rows, draft windows and prefill-chunk
        rows alike."""
        if self._spmd:
            self._sync()
        self.stats["iterations"] += 1
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            if self.queue and not self.store.can_admit(
                    len(self.queue[0].prompt), self.chunk_size):
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
        if self.scheduler == "cohort":
            # the reference's baseline: one step per (position, device
            # form) group, in sorted order
            parts: Dict[tuple, list] = {}
            for i in active:
                dev = self.slots[i].sampler.device_form()
                parts.setdefault((int(self.slot_pos[i]), repr(dev)),
                                 []).append(i)
            for key in sorted(parts):
                self._decode_rows(parts[key])
        elif (self.host_stride is not None
                and not any(self._prefilling(i) for i in active)):
            # the device-resident loop: one host sync for up to
            # host_stride tokens a row.  An iteration with a mid-prefill
            # slot runs the single step instead (the loop has no chunk
            # rows), still keyed, so generations stay stride-invariant.
            self._decode_multi(active)
        else:
            self._decode_rows(active)
        return True

    def _count_head(self, kind: str, times: int = 1) -> None:
        calls = self.stats["head_calls"]
        calls[kind] = calls.get(kind, 0) + times

    def _propose(self, i: int) -> list:
        """Draft tokens for slot ``i`` this step (possibly none): ask the
        Drafter for up to the request's remaining speculation budget,
        then shrink the window to what the cache ceiling and the free
        block pool can hold -- speculation never preempts a neighbour,
        it just drafts less."""
        req = self.slots[i]
        k = req.params.spec_k
        if k <= 0 or self._prefilling(i):
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

    def _plan_chunks(self, rows: List[int], n_decode_tokens: int) -> dict:
        """This iteration's prefill-chunk windows: ``{slot: (start,
        width)}`` for every mid-prefill slot in ``rows``.

        Width = min(chunk_size, remaining prompt), narrowed to the
        ``token_budget`` left after the decode and draft tokens (which
        are always served) and to the free pool (``can_grow``: a chunk
        narrows rather than preempt a neighbour, as a draft window does).
        Oldest-admitted slots plan first and every prefilling slot keeps
        >= 1 token, so prefill progress is monotone whatever the
        budget."""
        chunks: dict = {}
        pre = [i for i in rows if self._prefilling(i)]
        if not pre:
            return chunks
        recency = {slot: n for n, slot in enumerate(self.admit_order)}
        pre.sort(key=lambda j: recency.get(j, 0))
        avail = None
        if self.token_budget is not None:
            avail = max(self.token_budget - n_decode_tokens, len(pre))
        for n, i in enumerate(pre):
            start = int(self.slot_pos[i])
            w = min(self.chunk_size, len(self.slots[i].prompt) - start)
            if avail is not None:
                later = len(pre) - n - 1       # reserve 1 token each
                w = max(1, min(w, avail - later))
                avail -= w
            while w > 1 and not self.store.can_grow(i, start + w - 1,
                                                    write_start=start):
                w -= 1
            self.store.ensure_capacity(i, start + w - 1, write_start=start)
            chunks[i] = (start, w)
        return chunks

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
        chunks = plan.chunks
        _, outs = self._run_step(plan)
        for s in plan.order:
            self._count_head(type(s).__name__)
        if plan.spec:
            self._count_head("verify")
        self.stats["decode_steps"] += 1
        self.stats["decode_iterations"] += 1
        self.stats["host_syncs"] += 1
        self.stats["fused_rows"] += plan.n_real
        # one device->host copy per head group, not per slot; a keyed draw
        # reads the device copy (``_emit``)
        dev_outs = dict(zip(plan.order, outs))
        host = {s: _to_host(o) for s, o in dev_outs.items()}
        spec_host = _to_host(outs[-1]) if plan.spec else None
        self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
        for r in range(plan.n_real):
            i = plan.padded[r]
            dev, off = plan.where[r]
            req = self.slots[i]
            if i in chunks:
                # a prefill chunk served: advance the write cursor over
                # it; a FINAL chunk's head output emits the first token
                start, w = chunks[i]
                self.slot_pos[i] = start + w
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += w
                if start + w == len(req.prompt):
                    self.stats["prefills"] += 1
                    self._emit(i, req, host[dev], off, dev_outs[dev])
                continue
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
                self._emit(i, req, host[dev], off, dev_outs[dev])
        if self.stats["drafted"]:
            self.stats["acceptance_rate"] = (
                self.stats["accepted"] / self.stats["drafted"])

    def _plan_step(self, rows: List[int]) -> StepPlan:
        """The host half of one fused step: drafts, chunk windows
        (``_plan_chunks``), padded rows, tokens, positions, block tables,
        the head groups' row vectors and the verify group's rows and
        draft ids, as numpy operands.

        Rows are padded to a power of two by repeating row 0 (identical
        compute; the duplicate K/V write lands the same value on the same
        cell -- behind a capacity-dropping MoE layer the padding row, last
        in rank order, can lose choices row 0 keeps, and every duplicate
        then writes row 0's K/V, ``layers.write_sources``) and
        block-table columns to a power of two with each row's
        own first block (past its position, so the mask discards them).
        Each head group's row-index vector, and the verify group's, is
        padded to B rows the same way: a bucket's key then follows B, not
        how its rows split between groups, so a speculative run's steps
        share few graphs (the argmax and verify heads stream W once per
        64 rows, so their padding rows cost next to nothing).  A draft
        or chunk row widens the step to T = pow2(widest window): a draft
        row carries its last token plus its drafts at consecutive
        positions, a chunk row its next prompt tokens at their absolute
        positions (its earlier chunks are read through the block table);
        the other rows' padding queries repeat their last (token,
        position) -- a cache no-op.  A mid-prefill chunk row joins no
        head group; a final chunk joins its sampler's group, whose head
        reads its last column, the prompt's last position."""
        n_real = len(rows)
        drafts = {i: self._propose(i) for i in rows}
        n_decode_tokens = sum(1 + len(drafts[i]) for i in rows
                              if not self._prefilling(i))
        chunks = self._plan_chunks(rows, n_decode_tokens)
        T = _pow2(max([1 + len(drafts[i]) for i in rows]
                      + [w for _, w in chunks.values()]))
        padded = rows + [rows[0]] * (_pow2(n_real) - n_real)
        groups: Dict[Sampler, list] = {}
        spec_group: list = []            # padded-row indices that verify
        # row r -> (its head group, offset), (None, offset in the verify
        # group) for a draft row, or (None, None) for a mid-prefill
        # chunk row, whose logits nothing reads
        where = []
        for r, i in enumerate(padded):
            ch = chunks.get(i)
            if ch is not None and ch[0] + ch[1] < len(self.slots[i].prompt):
                where.append((None, None))
            elif drafts[i]:
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
            if i in chunks:
                base, w = chunks[i]
                win = [int(t) for t in self.slots[i].prompt[base:base + w]]
            else:
                win = [self.slots[i].generated[-1]] + drafts[i]
                w = len(win)
                base = int(self.slot_pos[i])
            toks[r, :w] = win
            toks[r, w:] = win[-1]        # repeat last (token, position):
            posm[r, :w] = base + np.arange(w)
            posm[r, w:] = base + w - 1   # identical value, identical cell
        kv = self._kv_index(padded, posm[:, -1])
        b = len(padded)
        group_rows = [np.asarray(g + [g[0]] * (b - len(g)), np.int64)
                      for g in (groups[s] for s in order)]
        arrays = [toks, posm if T > 1 else np.ascontiguousarray(posm[:, 0]),
                  kv, *group_rows]
        spec = 0
        if spec_group:
            sg = spec_group + [spec_group[0]] * (b - len(spec_group))
            cand = np.full((len(sg), T - 1), -1, np.int32)
            for o, r in enumerate(sg):
                d = drafts[padded[r]]
                cand[o, :len(d)] = d
            arrays += [np.asarray(sg, np.int64), cand]
            spec = len(sg)
        key = step_graph.bucket_key(order, toks.shape, self._table_shape(kv),
                                    [len(g) for g in group_rows], spec)
        return StepPlan(n_real, padded, drafts, chunks, where, order,
                        tuple(arrays), spec, key)

    def _run_step(self, plan: StepPlan):
        """The device half of ``plan``: (h, head outputs) -- a graph
        replay of its bucket on the card (``step_graph.graphed``), else
        ``_step_body`` eagerly."""
        self._agree("a step's plan", plan.key, plan.chunks, *plan.arrays)
        body = functools.partial(self._step_body, tuple(plan.order))
        if self._graphed():
            return self.graphs.run(plan.key, body, plan.arrays, self.device)
        return body(*step_graph.to_device(plan.arrays, self.device))

    def _kv_index(self, padded: list, last_pos) -> np.ndarray:
        """A step's cache index for the padded rows: the (B, nb) block
        tables covering each row up to ``last_pos`` (paged), or each
        row's slot as (B,) int64 (dense)."""
        if self.store.any_paged:
            return self.store.block_table(padded, last_pos)
        return np.asarray(padded, np.int64)

    def _table_shape(self, kv: np.ndarray):
        """The block tables' shape for a graph key; None (dense)."""
        return kv.shape if self.store.any_paged else None

    def _kv_kwargs(self, kv) -> dict:
        """``lm.decode_step``'s keyword for a ``_kv_index``."""
        if self.store.any_paged:
            return {"block_tables": kv}
        return {"cache_rows": kv}

    def _step_body(self, order: tuple, toks, pos, kv, *rest):
        """The fused step on the card: the trunk ONCE over all rows (the
        cache written in place), then one head per group in ``order``
        over its rows (``rest``'s first vectors), then, when ``rest``
        also holds the verify group's rows and draft ids, the comparator
        verify over their (T, D) hidden states.  It reads its inputs only
        from the tensors it is handed, so a captured body replays over
        new ones.  Returns (h, outputs), the verify group's last."""
        h, _ = lm.decode_step(self.params, self.cfg, toks,
                              self.store.cache(), pos, layers=self._layers,
                              **self._kv_kwargs(kv))
        hl = h[:, -1] if h.dim() == 3 else h   # each row's last real query
        outs = [s.head(self.params, self.cfg, hl[r])
                for s, r in zip(order, rest)]
        if len(rest) > len(order):
            srows, cand = rest[len(order):]
            outs.append(self._verify(h[srows], cand))
        return h, tuple(outs)

    def _verify(self, h: torch.Tensor, cand: torch.Tensor):
        """The comparator verify of a step's draft rows: the verify head,
        or on a sharded head ``sharded_verify_draft`` (one (val, idx) pair
        per position per rank crosses the group)."""
        w = lm.lm_head_weight(self.params, self.cfg)
        sh = self.cfg.shard
        if sh is not None:
            return reduced_softmax.sharded_verify_draft(
                h, w, cand, sh.group, v_lo=sh.vocab[0])
        return ops.verify_draft(h, w, cand)

    def _decode_multi(self, rows: List[int]):
        """One device-resident dispatch over the given slot rows: up to
        ``host_stride`` fused T-1 iterations with keyed sampling on the
        device (a graph replayed back to back on the card, the eager loop
        ``api.serve_decode_multi`` elsewhere), then a host drain of the
        (B, K) token block through the per-token emission path.

        Every stop the device can evaluate is folded into a per-row EMIT
        CAP before the dispatch: the remaining ``max_new_tokens``, the
        ``max_len - 1`` cache ceiling and the block cover, grown here up
        to the cap's last write (the cap shrinks rather than preempt a
        neighbour, as a draft or chunk window does).  ``eos_id`` halts a
        row inside the loop, after emitting it.  Stop SEQUENCES are
        matched on the host during the drain: a match (or a consumer's
        cancel) finishes the request mid-block and the rest of its block
        is trimmed -- never emitted, its K/V behind the position masks,
        its surplus blocks rewound.  Groups key on the FULL sampler (the
        temperature acts on the device); the keys ride the loop's carry
        and the advanced keys are adopted, so draw n stays a function of
        (request key, n) whatever the stride."""
        t0 = time.perf_counter()
        plan = self._plan_multi(rows)
        out, emitted, keys, ran = self._run_multi(plan)
        for s in plan.order:
            self._count_head(type(s).__name__, ran)
        self.stats["decode_steps"] += 1
        self.stats["decode_iterations"] += ran
        self.stats["host_syncs"] += 1
        self.stats["fused_rows"] += plan.n_real
        # one device->host copy of the block, the counts and the keys
        out_h, emitted_h, keys_h = (x.cpu().numpy()
                                    for x in (out, emitted, keys))
        self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
        for r in range(plan.n_real):
            i = plan.padded[r]
            req = self.slots[i]
            if req is None:
                # a consumer cancelled this slot while an earlier row
                # drained: its tokens are dropped, its blocks already free
                continue
            req.prng_key = torch.from_numpy(keys_h[r].copy())
            for tok in out_h[r, :int(emitted_h[r])]:
                self.slot_pos[i] += 1
                self._emit_token(i, req, int(tok))
                if req.done:
                    # stop / eos / length / cancel mid-block: the rest of
                    # the block is trimmed
                    break
            if not req.done:
                # the cover past the cursor goes back to the free list: a
                # live slot covers exactly its next write
                self.store.rewind(i, int(self.slot_pos[i]))

    def _plan_multi(self, rows: List[int]) -> LoopPlan:
        """The host half of one device-resident dispatch: each row's emit
        cap (its block cover grown to the cap's last write), the padded
        rows, the groups of full samplers and the loop's operands."""
        K = self.host_stride
        caps: Dict[int, int] = {}
        for i in rows:
            req = self.slots[i]
            pos = int(self.slot_pos[i])
            cap = max(1, min(K, req.max_new_tokens - len(req.generated),
                             self.max_len - 1 - pos))
            while cap > 1 and not self.store.can_grow(i, pos + cap - 1,
                                                      write_start=pos):
                cap -= 1
            if cap > 1 and not self.store.ensure_capacity(
                    i, pos + cap - 1, write_start=pos):
                cap = 1           # lost a race; ``pos`` itself is covered
            caps[i] = cap
        n_real = len(rows)
        padded = rows + [rows[0]] * (_pow2(n_real) - n_real)
        b = len(padded)
        groups: Dict[Sampler, list] = {}
        for r, i in enumerate(padded):
            groups.setdefault(self.slots[i].sampler, []).append(r)
        order = sampler_mod.canonical_order(groups)
        group_rows = [np.asarray(g + [g[0]] * (b - len(g)), np.int64)
                      for g in (groups[s] for s in order)]
        pos = np.asarray([int(self.slot_pos[i]) for i in padded], np.int32)
        # a padding row never emits (cap 0) and rewrites row 0's first
        # cell; each row's table covers its last emitting write
        emit_caps = np.zeros(b, np.int32)
        emit_caps[:n_real] = [caps[i] for i in rows]
        kv = self._kv_index(
            padded, pos + np.asarray([caps[i] for i in padded]) - 1)
        arrays = (np.asarray([self.slots[i].generated[-1] for i in padded],
                             np.int64), pos,
                  np.stack([self.slots[i].prng_key.numpy() for i in padded]),
                  np.zeros(b, np.int32), np.zeros(b, bool),
                  np.full((b, K), -1, np.int64), np.zeros(1, np.int64),
                  emit_caps, kv, *group_rows)
        table = self._table_shape(kv)
        key = step_graph.loop_key(order, b, None if table is None
                                  else table[1], K,
                                  [len(g) for g in group_rows])
        return LoopPlan(n_real, padded, order, arrays, int(emit_caps.max()),
                        key)

    def _run_multi(self, plan: LoopPlan):
        """The device half of ``plan``: (out, emitted, keys, iterations
        run) on the device -- a graph of one iteration replayed
        ``plan.steps`` times on the card (``step_graph.StepGraphs.
        run_loop``), else the eager loop ``api.serve_decode_multi``,
        which leaves once no row is active."""
        self._agree("a dispatch's plan", plan.key, *plan.arrays)
        if self._graphed():
            body = functools.partial(self._loop_body, tuple(plan.order))
            ops = self.graphs.run_loop(plan.key, body, plan.arrays,
                                       plan.steps, self.device)
            return ops[5], ops[3], ops[2], plan.steps
        tok, pos, keys, _, _, _, _, caps, kv, *rows = step_graph.to_device(
            plan.arrays, self.device)
        return api.serve_decode_multi(
            self.params, self.cfg, tok, self.store.cache(), pos, keys, caps,
            rows, steps=self.host_stride, eos_id=self._eos(),
            samplers=plan.order, layers=self._layers,
            **self._kv_kwargs(kv))

    def _loop_body(self, order: tuple, *operands):
        """One loop iteration over a ``LoopPlan``'s operands on the device
        (the carry's fields, the cache index, each group's rows), in
        place -- the body a graph captures."""
        carry = api.MultiCarry(*operands[:8])
        kv, rows = operands[8], operands[9:]
        api.decode_multi_step(self.params, self.cfg, carry,
                              self.store.cache(), rows, eos_id=self._eos(),
                              samplers=order, layers=self._layers,
                              **self._kv_kwargs(kv))

    def _eos(self) -> int:
        """The eos id the loop halts on (-1: none)."""
        return -1 if self.eos_id is None else int(self.eos_id)

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
        req = self.slots[i]
        publish = None
        if self.prefix_cache and req is not None and req.params.prefix_cache:
            # the slot's K/V rows [0, slot_pos) hold exactly this token
            # history (original prompt ++ emissions; re-prefills and spec
            # rewinds keep it so), whatever ends the slot: completion,
            # cancel or preemption.  A preempted request then re-adopts
            # its own run and re-prefills only the tail.
            publish = np.concatenate(
                [np.asarray(req.orig_prompt, np.int32),
                 np.asarray(req.generated, np.int32)]
            )[:int(self.slot_pos[i])]
        self.store.release(i, publish_tokens=publish)
        self.slots[i] = None
        self.admit_order.remove(i)

    def _emit(self, i: int, req: Request, host_out, off: int, dev_out):
        """One token emission off a sampler head output: pick on the host
        (plus the candidate ids of the k-winner bus when the request asks
        for them), then the shared emission path.  On a host_stride
        engine a sampler that draws picks KEYED -- one split of the
        request's key, drawn by ``pick_keyed`` over ``dev_out``, the
        output on the engine's device, with the ops the device loop runs
        -- so a token emitted here (a prefill's, a chunk iteration's) is
        the one the loop would have drawn."""
        if self.host_stride is not None and req.sampler.draws:
            nxt, use = prng.split(req.prng_key)
            tok = req.sampler.pick_keyed(dev_out, off, use)
            req.prng_key = nxt
        else:
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
        while self.has_work and it < max_iters:
            self.step()
            it += 1
        return self.stats
