"""The fused decode step as one program on the card: a CUDA graph per
shape bucket.

Counterpart of ``repro.serve.engine._jitted_step``.  The reference
compiles the trunk, every head group and the speculative verify into one
XLA program, cached per (cfg, sampler tuple, ...) and per operand shape,
with the row-index vectors as traced operands.  Here the engine's device
body (``ServeEngine._step_body``) is captured once per bucket --
``bucket_key``: (B, nb, T, the canonical tuple of device-form samplers,
each group's padded row count, the spec group's or 0; the engine pads
every group to B, so a key does not follow how rows split) --
and replayed for every later step of the bucket, its inputs copied into
the graph's static buffers.  The engine already pads every shape to a
power of two, and each kernel's launch plan reads shapes only
(``paged_attention.plan_split``, ``fused_argmax_head.head_plan``,
``fused_topk_head.topk_plan``), so one capture serves every batch of its
bucket: which rows belong to which head, their positions and block ids
are operands.

The first step of a bucket runs eagerly.  It is a real step (its tokens
are emitted) and warms what a capture must not do for the first time:
the nvcc build, the score-mode table upload (``paged_attention._rom``),
the heads' shared-memory opt-in (``fused_argmax_head.device_limits``),
cuBLAS's handles and workspaces.  The bucket's second step captures the
body on a side stream into the engine's one memory pool, over static
input buffers, and replays it; later steps copy their inputs into them
from pinned staging and replay.  A bucket that comes once stays eager
and pays no capture (a capture costs several eager steps).
Every ``torch.empty`` of a kernel wrapper comes from that pool during
the capture.  The graphs of one engine share the pool and may reuse each
other's scratch, so a replay may overwrite another bucket's outputs: the
engine copies a step's outputs to the host at once and never hands them
to a caller.  The KV pools and the params are allocated once, outside
the pool, so the addresses a graph holds stay valid.

Launch counters (``paged_attention.launches`` and the others) count on
the host, in lines a replay never runs, and during a capture they count
launches that did not run.  So a capture takes its delta back out, and
every replay adds it again (``read_counts``, ``count_delta``,
``add_counts``): a counter reads what ran on the card.

A step stays eager on the CPU, while the probe's tap
(``models.layers._ATTN_TAP``) is set -- it must see every call -- and
inside ``eager_steps()``, the port's ``jax.disable_jit``.  There is no
fallback: a capture or replay that fails raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_argmax_head as _fah
from repro_torch.kernels import fused_topk_head as _ftk
from repro_torch.kernels import fused_xent as _fx
from repro_torch.kernels import online_softmax as _os
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models import layers

# A process-wide switch, as ``jax.disable_jit`` is; ``eager_steps`` sets
# it and puts back what it found, so the blocks nest.
_EAGER = False

# the counter attributes a kernel wrapper may carry: an int, or a dict of
# ints by score mode or route
COUNTERS = ("launches", "launches_by_mode", "launches_by_route")


@contextlib.contextmanager
def eager_steps():
    """Run every decode step eagerly inside the block, on any device:
    nothing is captured or replayed (the graphs already captured stay)."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def graphed(device) -> bool:
    """Whether a decode step on ``device`` runs as a graph now: on a CUDA
    device, outside ``eager_steps()``, with no probe tap set."""
    return (torch.device(device).type == "cuda" and not _EAGER
            and layers._ATTN_TAP is None)


def bucket_key(order: Sequence, toks_shape, table_shape,
               group_sizes: Sequence[int], spec_size: int) -> tuple:
    """The graph cache's key for one step: (B, nb, T, samplers, group
    sizes, spec size) from the (B, T) tokens' and (B, nb) block tables'
    shapes, the canonical tuple of device-form samplers ``order``, each
    group's padded row count and the verify group's (0 without one) --
    the shapes and static arguments of the reference's compiled step."""
    (b, t), nb = toks_shape, table_shape[1]
    return (b, nb, t, tuple(order), tuple(group_sizes), spec_size)


def kernel_wrappers() -> dict:
    """The kernel wrappers by name, each with its launch counters."""
    return {"paged_attention": _pa.paged_attention,
            "fused_argmax_head": _fah.fused_argmax_head_with_value,
            "fused_verify_head": _fah.fused_verify_head,
            "fused_topk_head": _ftk.fused_topk_head,
            "flash_attention": _fa.flash_attention,
            "softmax_stats": _os.softmax_stats,
            "online_softmax": _os.online_softmax,
            "fused_xent": _fx.fused_xent}


def read_counts(wrappers: dict) -> dict:
    """Every launch counter of ``wrappers`` as ``{(name, counter, key):
    count}``; ``key`` is None for a plain count, else the mode or route
    of a dict of counts."""
    out = {}
    for name, fn in wrappers.items():
        for attr in COUNTERS:
            c = getattr(fn, attr, None)
            if isinstance(c, dict):
                out.update({(name, attr, k): v for k, v in c.items()})
            elif c is not None:
                out[(name, attr, None)] = c
    return out


def count_delta(before: dict, after: dict) -> dict:
    """The counters that moved from ``before`` to ``after`` (two
    ``read_counts``), by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_counts(wrappers: dict, delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters of ``wrappers``, read
    afresh (a caller may have replaced a dict of counts)."""
    for (name, attr, key), d in delta.items():
        fn = wrappers[name]
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + times * d)
        else:
            getattr(fn, attr)[key] += times * d


def to_device(arrays: Sequence[np.ndarray], device) -> tuple:
    """The step's host operands as tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    static: tuple          # the graph's input buffers on the card
    staging: tuple         # pinned host buffers, one per input
    copied: "torch.cuda.Event"   # the last copy out of ``staging``
    out: object            # the body's outputs, rewritten by each replay
    counts: dict           # the launches one replay stands for


class StepGraphs:
    """One engine's captured decode steps, by ``bucket_key``, in one
    memory pool.  ``seen`` holds every bucket that has run a step;
    ``captures``, ``replays`` and ``capture_ms`` count what it did, as
    the wrappers count launches."""

    def __init__(self):
        self.wrappers = kernel_wrappers()
        self.graphs: Dict[tuple, _Captured] = {}
        self.seen: set = set()
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0

    def __len__(self) -> int:
        return len(self.graphs)

    def run(self, key: tuple, body, arrays: Sequence[np.ndarray], device):
        """One step of bucket ``key``: ``body(*operands)`` over the host
        ``arrays``.  A bucket's first step runs eagerly, its second
        captures ``body`` and replays it, later steps replay it.  The
        outputs are valid until the next step of any bucket."""
        if key not in self.seen:
            self.seen.add(key)
            return body(*to_device(arrays, device))
        if key not in self.graphs:
            self.capture(key, body, arrays, device)
        return self.replay(key, arrays)

    def capture(self, key: tuple, body, arrays: Sequence[np.ndarray],
                device) -> None:
        """Capture ``body`` for bucket ``key`` over static buffers shaped
        and typed as ``arrays`` (nothing runs on the card)."""
        static = to_device(arrays, device)
        staging = tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory() for a in arrays)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = read_counts(self.wrappers)
        t0 = time.perf_counter()
        try:
            # "thread_local": the engine may be stepped from LLM's pump
            # thread while other threads keep using the card (a caller's
            # synchronize or copy); under "global" their calls would
            # invalidate this capture and fail themselves.  This thread's
            # own unsafe calls (a sync inside the body) still raise.
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = body(*static)
        finally:
            delta = count_delta(before, read_counts(self.wrappers))
            add_counts(self.wrappers, delta, -1)   # nothing ran
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        self.graphs[key] = _Captured(graph, static, staging,
                                     torch.cuda.Event(), out, delta)
        self.captures += 1

    def replay(self, key: tuple, arrays: Sequence[np.ndarray]):
        """Copy ``arrays`` into bucket ``key``'s static buffers and replay
        its graph on the current stream; returns its outputs."""
        g = self.graphs[key]
        g.copied.synchronize()           # staging free to write again
        for host, stage, dev in zip(arrays, g.staging, g.static):
            stage.numpy()[...] = host
            dev.copy_(stage, non_blocking=True)
        g.copied.record()
        g.graph.replay()
        add_counts(self.wrappers, g.counts)
        self.replays += 1
        return g.out

    def pool_bytes(self) -> int:
        """Bytes the caching allocator has reserved for the graph pool."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))
