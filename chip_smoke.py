#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card's name and power limit (``nvidia-smi``);
  2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once);
  3. holds each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerance, and times the kernel, the
     plain version and one PyTorch library call computing the same
     function (a yardstick only), beside the bound computed from the
     bytes and flops of these inputs: paged attention (T = 1, 4 and 32
     over 8 ragged rows, the last 64 query rows per KV head, and T = 1
     over one 1000-token row; each call's split into chunks printed; the
     kernels each (dtype, mode) ran, by their names in a profiler trace:
     bf16 on the tensor cores in every mode, base2 and pwl after a row-max
     pre-pass; in every mode a row's output bitwise equal alone and beside
     a 1000-token row, and at T = 1 and in every column of T = 8 with its
     position repeated), head dim 192 (paged
     attention at T = 1 and 32 in every mode, flash attention over 512
     tokens), the argmax head (B 1, 8 and 64; the pass-1 kernel each
     dtype ran, by its name in a profiler trace: bf16 on the tensor-core
     tile), the top-k head
     (planted ties across vocabulary splits; its two passes timed apart
     from a profiler trace at k 8 and 64; k 64 bitwise equal to
     ``ref.topk_select`` on exact integer logits), the speculative verify
     head (ragged -1 padded drafts; B 8 at T 2, 8 and 32, B 1 at T 32), a
     row's head result bitwise equal alone, in B 8 and B 64 and in the
     verify head at T 8 and 32, the three heads at nemotron-4-340b's
     width (D 18432, V 256000), flash attention (prompts of 71 and
     512 tokens, g 2 and 8, causal and windowed) and the softmax unit's
     stats, softmax and cross-entropy kernels ((12, 151936) f32,
     (512, 151936) bf16 and, stats and cross-entropy, (4096, 151936)
     bf16 rows -- one 4k-token training sequence -- and 70,000 rows of
     1,000 -- more than grid.y's 65,535; each call's plan and route and
     the device kernels it ran, from a profiler trace: one for
     softmax_stats and fused_xent at every B; stats and loss against
     their split models; an empty launch timed on the same ruler; a
     row's stats and probabilities bitwise equal alone, in B 12 and in B
     64, across both routes, and its loss alone and in B 12, 64 and
     4,096; the cross-entropy's backward at 4,096 bf16 rows within 4.0
     GB beyond its inputs); then paged attention's four exp-free
     score modes (base2, pseudo, pwl, maxonly) at the main path's shapes
     (T = 1 and 4, window None and 128), each timed beside exact (at T = 1
     each launch apart, from a profiler trace), base2, pseudo and pwl
     again at those shapes with each query's best key in its first
     visible 32-key slice, in f32 at rounding level and each mode's gap to
     exact as large as the plain version's, and base2 and pwl in f32 at
     those shapes with nothing pinned, at rounding level (base2 plus the
     effect of the LUT bins a score's rounding may flip).  The kernel
     flash attention ran per (dtype, head dim), by its name in a
     profiler trace, is printed (bf16 on the tensor cores), and two
     calls of each redesigned kernel (paged and flash attention) must
     give the same bits;
  4. drives the main path -- ``LLM.from_arch("qwen3-0.6b", smoke=False)``
     then ``LLM.generate``, greedy, at the model's full width with random
     seeded weights -- once inside ``step_graph.eager_steps()`` and then
     graphed three times (the decode step as one CUDA graph per shape
     bucket: a bucket's first step runs eagerly, its second captures;
     the third run replays every bucket), the four runs' tokens equal,
     and checks in each run that every prompt prefill layer went
     through the flash-attention kernel, every decode layer through the
     paged-attention kernel and every head through the argmax kernel
     (a replay adds its capture's launches to the counters); it prints
     the graph cache's captures, replays, capture ms and pool MB;
  4b. a mixed sampled workload on the same engine (greedy, top-k at
     temperature 0.8, ``n_candidates``, Gumbel-max temperature), eager
     and graphed with equal tokens: every top-k head call went through
     the top-k kernel, candidate ids are well formed, and the greedy
     rows keep the greedy-only tokens;
  4c. speculation on the same engine (repetitive prompts, ``spec_k=4``,
     plus one request at ``spec_k=20``): the tokens of ``spec_k=0``, and
     every step with a draft row went through the verify kernel, each
     run eager and graphed with equal tokens; spec_k=4 graphed three
     times, the third replaying every bucket, whose step must be faster
     than the eager one; then a profile of pure decode steps, eager and
     graphed (wall and device-busy ms per step, the busy share, kernels
     per step; paged attention's, the argmax head's and the f64 norm
     mean's device ms per step), which launch no flash kernel -- the
     graphed step must be the faster, and in both the traced
     paged-attention and argmax-head kernels must be twice the launches
     the counters add up (2 x 28 and 2 a step);
  4f. the step as one program: in three buckets (greedy B 8 T 1; Greedy
     + TopK + Temperature groups; the verify group at T 8) a replay of
     the bucket's graph gives the eager step's hidden states and head
     outputs bit for bit on the same operands; the greedy bucket's
     replay timed beside its eager body and the step's bound; the
     Temperature head's memory beyond its inputs (<= 64 MB) and device
     ms beside the f32 copy of W it replaced;
  4d. the unit path: the f32 logits of the 12 prompts' final hidden
     states at V = 151936 through ``ops.softmax_stats``,
     ``ops.online_softmax`` and ``ops.softmax_xent`` forward and backward
     (labels: phase 4's first tokens), each against its plain version,
     each kernel's launches equal to its calls (every ``online_softmax``
     call also runs ``softmax_stats``' fold and merge, and counts in
     both; the backward calls ``online_softmax``), and Theorem 1 through
     the full unit:
     ``argmax(online_softmax)`` is phase 4's first token;
  4e. the divergence probe (``repro_torch.probe.run_probe``, eager) on
     the 12 prompts, 32 new tokens: all five score modes at window None,
     then
     pseudo and maxonly at window 128, every decode layer of each arm
     through the paged-attention kernel in that arm's mode, and per-layer
     score errors from the tap;
  5. Theorem 1 on the card, graphed: the softmax-baseline head gives the
     same token streams;
  6. the small-input reference, graphed: the smoke config's tokens on
     the card equal those of the plain versions on the CPU, from the
     same weights.

Token streams that should be equal may part only at a near-tie of the
two best f32 logits (gap within 1e-3 of the max): the batch composition
changes the order of the bf16 sums in the trunk's matrix products.

It prints one JSON object with the kernels' numbers on the line before
the last, and ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero without either when CUDA is absent or ``src/repro_torch``
is not beside it.  It imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: HBM bandwidth and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores

PA_TOL = 2e-2          # paged attention, bf16: atol = rtol
MAXONLY_BAND = 1e-3    # maxonly: a key within this of the best f32 score
PIN_TOL = 1e-5         # paged modes at a pinned max, f32: atol = rtol
PIN_GAP = 0.1          # ... kernel's gap to exact vs the plain one's
BF16_STEP = 2.0 ** -8  # one bf16 step, relative
FA_TOL = 2e-2          # flash attention, bf16 output: atol = rtol
HEAD_RTOL = 1e-3       # head value rtol; idx must match past this gap
UNIT_RTOL = 2e-5       # softmax unit kernels vs plain: split sum order
UNIT_ATOL = 1e-7       # stats, probabilities and gradient
XENT_ATOL = 1e-6       # cross-entropy (m + log l - x: cancellation)


def kernel_modules():
    """The kernels' wrappers by kernel name (each has a ``launches``
    count), as the port's step graphs count them."""
    from repro_torch.serve import step_graph

    return step_graph.kernel_wrappers()


def reset_launches():
    for fn in kernel_modules().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = dict.fromkeys(fn.launches_by_mode, 0)
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_modules().items()}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """SM clock now and its maximum, power draw and temperature: a card
    held below its clocks runs every kernel slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return "clocks.sm, clocks.max.sm, power.draw, temperature: " + \
        out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """CUDA-event time of one call, averaged over ``iters`` runs, with
    the 50 MB L2 flushed before each run (the decode step finds each
    layer's operands cold).  ``timer(fn)`` is the call's time; a timed
    kernel and its library call get three readings (``readings``):

    - ``ms``, the call's time: the events also catch the host's Python
      in front of the call's first launch where it outlasts the flush
      (the one reading this script took before it took all three);
    - ``device_ms``, the card's time: the card spins for HOLD_CYCLES
      while the host records the start event and enqueues the call, so
      the events bracket the card's work alone;
    - ``host_ms``, the host's time to enqueue the call (wall clock, in
      the held runs, where no launch waits for the card)."""

    HOLD_CYCLES = 1_000_000          # ~0.5 ms at the H100's 1,980 MHz

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def _run(self, fn, hold, iters=20, warmup=3):
        """(mean event ms, mean host ms) over ``iters`` calls."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = host = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(self.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters, host * 1e3 / iters

    def __call__(self, fn) -> float:
        return self._run(fn, hold=False)[0]

    def readings(self, fn, prefix="") -> dict:
        """``fn``'s call, device and host ms under the keys ``prefix`` +
        ``ms``, ``device_ms`` and ``host_ms``."""
        device, host = self._run(fn, hold=True)
        return {f"{prefix}ms": self(fn), f"{prefix}device_ms": device,
                f"{prefix}host_ms": host}


NO_LIBRARY = dict.fromkeys(("library_ms", "library_device_ms",
                            "library_host_ms"))
# the timing keys of a kernel's row and of its entry in the kernels line
TIMES = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
         *NO_LIBRARY)


def shown(row, prefix="") -> str:
    """A row's three readings as printed."""
    if row[f"{prefix}ms"] is None:
        return "none"
    return (f"{row[f'{prefix}ms']:.4f} ms (device "
            f"{row[f'{prefix}device_ms']:.4f}, host "
            f"{row[f'{prefix}host_ms']:.4f})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_case(torch, rng, t, *, b=8, hq=16, hkv=8, hd=128, bs=16,
               dtype=None):
    """The main path's decode shapes: ragged contexts of 1..1000 tokens,
    permuted pool blocks, tables padded to a power of two with each row's
    own first block, bf16 (or ``dtype``).  One row (b = 1) holds 1000."""
    from repro_torch.serve.paged_kv import pow2

    ctx = rng.integers(1, 1001, size=b)
    ctx[:2] = (1, 1000) if b > 1 else 1000    # both ends of the range
    last = ctx - 1
    nbs = last // bs + 1
    nb = pow2(int(nbs.max()))
    nblocks = int(nbs.sum()) + 8
    perm = rng.permutation(nblocks)
    table, k0 = np.empty((b, nb), np.int32), 0
    for r, n in enumerate(nbs):
        table[r, :n] = perm[k0:k0 + n]
        table[r, n:] = perm[k0]
        k0 += n
    if t == 1:
        pos = last.astype(np.int32)
    else:
        pos = np.maximum(last[:, None] - np.arange(t - 1, -1, -1), 0
                         ).astype(np.int32)
    qshape = (b, hq, hd) if t == 1 else (b, t, hq, hd)
    dev, bf = "cuda", (torch.bfloat16 if dtype is None else dtype)
    q = torch.from_numpy(rng.standard_normal(qshape, np.float32)).to(dev, bf)
    kp = torch.from_numpy(rng.standard_normal(
        (nblocks, bs, hkv, hd), np.float32)).to(dev, bf)
    vp = torch.from_numpy(rng.standard_normal(
        (nblocks, bs, hkv, hd), np.float32)).to(dev, bf)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev))


def paged_work(q, kp, bt, pos, window):
    """(bytes, flops) a paged-attention call must move and do on these
    inputs: q read and out written once, each row's K/V span read once
    (from its first visible position to its last query's), the table and
    positions; 4*hd flops per visible (query head, key) pair."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    pos2 = pos.reshape(b, tq).long()
    hi = pos2.max(dim=1).values
    lo = (pos2.min(dim=1).values - window + 1).clamp(min=0) \
        if window is not None else hi * 0
    el = q.element_size()
    nbytes = (2 * q.numel() * el + 2 * (hi - lo + 1).sum().item() * hkv * hd
              * el + bt.numel() * 4 + pos.numel() * 4)
    seen = pos2 + 1 if window is None else (pos2 + 1).clamp(max=window)
    return nbytes, 4 * hd * hq * seen.sum().item()


def sdpa_on_gathered_view(torch, q, kp, vp, bt, pos, window, scale):
    """The library yardstick of paged attention: SDPA at ``scale`` over the
    gathered (dense) K/V view with the causal (and window) mask, as a
    call to time."""
    import torch.nn.functional as F

    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    kd = kp[bt.long()].reshape(b, -1, hkv, hd).transpose(1, 2)
    vd = vp[bt.long()].reshape(b, -1, hkv, hd).transpose(1, 2)
    qd = q.reshape(b, tq, hq, hd).transpose(1, 2)
    pos2 = pos.reshape(b, tq).long()
    kv = torch.arange(kd.shape[2], device=q.device)
    mask = kv[None, None, :] <= pos2[:, :, None]
    if window is not None:
        mask &= kv[None, None, :] > pos2[:, :, None] - window
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None], scale=scale, enable_gqa=True)


def split_line(pa, q, kp, bt) -> str:
    """The split the paged-attention wrapper takes for these operands (the
    same in every score mode)."""
    n, ck = pa.split_for(q, kp, bt)
    return (f"{n} chunks of {ck} keys, combine in chunk order" if n > 1
            else f"1 chunk of {ck} keys, no combine")


def check_repeatable(torch, fn, what):
    """Two calls of a kernel on the same inputs give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    print(f"{what}: two calls {'bitwise equal' if same else 'DIFFER'}",
          flush=True)
    check(same, f"{what}: two calls on the same inputs differ")


def check_paged_attention(torch, timer, rng):
    """Exact paged attention at T = 1, 4 and 32 over 8 ragged rows, and
    at T = 1 over one 1000-token row (B 1, the single-row latency case
    the split is for)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    # T = 32 at g = 2: 64 query rows per head
    for key, t, b in ((1, 1, 8), (4, 4, 8), (32, 32, 8), ("B1", 1, 1)):
        q, kp, vp, bt, pos = paged_case(torch, rng, t, b=b)
        hd = q.shape[-1]
        tag = f"B={b} T={t}"
        out = pa.paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        want = ref.paged_attention(q, kp, vp, bt, pos)
        check(bool(torch.isfinite(out).all()), f"paged {tag}: non-finite")
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=PA_TOL,
                            rtol=PA_TOL)
        print(f"paged_attention {tag}: {split_line(pa, q, kp, bt)}; "
              f"max_abs_err {err:.6g} vs plain (atol = rtol = {PA_TOL}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"paged attention {tag} disagrees with its plain version")
        check_repeatable(torch, lambda: pa.paged_attention(
            q, kp, vp, bt, pos), f"paged_attention {tag}")

        kern = timer.readings(lambda: pa.paged_attention(
            q, kp, vp, bt, pos))
        plain_ms = timer(lambda: ref.paged_attention(q, kp, vp, bt, pos))
        lib = timer.readings(sdpa_on_gathered_view(
            torch, q, kp, vp, bt, pos, None, 1 / math.sqrt(hd)), "library_")
        nbytes, flops = paged_work(q, kp, bt, pos, None)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        print(f"paged_attention {tag}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, sdpa(gathered view) "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.3f} MB)", flush=True)
        rows[key] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, **lib,
                         chunks=pa.split_for(q, kp, bt)[0])
    return rows


def visible_scores(torch, q, kp, bt, pos, window):
    """The f32 scores of every (row, query, head, key) of a paged-attention
    call, (b, t, hq, s), -inf where the key is not visible."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    k = kp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    qq = q.float().reshape(b, tq, hq, hd)
    scores = torch.einsum("bthd,bshd->bths", qq, k) / math.sqrt(hd)
    pos2 = pos.reshape(b, tq).long()
    kv = torch.arange(k.shape[1], device=q.device)
    vis = kv[None, None, :] <= pos2[:, :, None]
    if window is not None:
        vis &= kv[None, None, :] > pos2[:, :, None] - window
    return torch.where(vis[:, :, None, :], scores, -torch.inf)


def maxonly_rows(torch, out, q, kp, vp, bt, pos, window):
    """maxonly against its plain version on f32 copies of the inputs:
    (max abs error against that plain output, rows equal to it, rows
    that are instead the V row of another key scoring within
    MAXONLY_BAND * |best| of the best f32 score, rows that are
    neither)."""
    from repro_torch.kernels import ref

    qf, kf, vf = q.float(), kp.float(), vp.float()
    want = ref.paged_attention(qf, kf, vf, bt, pos, attn_approx="maxonly",
                               window=window)
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    v = vf[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    scores = visible_scores(torch, q, kp, bt, pos, window)
    best = scores.amax(dim=-1, keepdim=True)
    near = scores >= best - MAXONLY_BAND * best.abs()          # (b,t,h,s)
    got = out.float().reshape(b, tq, hq, hd)
    same = (got == want.float().reshape(b, tq, hq, hd)).all(-1)
    # (b, t, h, s): the output row is key s's V row
    is_row = (got[:, :, :, None] == v.permute(0, 2, 1, 3)[:, None]).all(-1)
    banded = (is_row & near).any(-1) & ~same
    err = (got - want.float().reshape(b, tq, hq, hd)).abs().max().item()
    return (err, int(same.sum()), int(banded.sum()),
            int((~same & ~banded).sum()))


def paged_passes(torch, fn) -> dict:
    """Device ms per call of each launch of a paged-attention call, from a
    profiler trace (``kernel_device_ms``): the row-max pre-pass (base2 and
    pwl), the fold and the combine."""
    times = kernel_device_ms(torch, fn)
    got = {key: sum(t for n, t in times.items() if name in n)
           for key, name in (("prepass_ms", "paged_rowmax"),
                             ("fold_ms", "paged_attention"),
                             ("combine_ms", "paged_combine"))}
    check(got["fold_ms"] > 0, f"paged passes: the trace shows no fold "
          f"kernel: {sorted(times)}")
    return got


def check_paged_modes(torch, timer, rng):
    """Paged attention's exp-free score modes at the main path's shapes
    (``paged_case``: T = 1 and 4; window None and 128), each against its
    plain version: base2, pseudo and pwl at PA_TOL, maxonly by
    ``maxonly_rows``.  Each is timed beside exact on the same inputs, with
    the same bound, and at T = 1 without a window its launches apart
    (``paged_passes``: base2 and pwl's row-max pre-pass, the fold, the
    combine); the library yardstick of pseudo is SDPA at scale ln 2 /
    sqrt(hd) on the gathered view (softmax(s ln 2) = 2^s / sum 2^s), and
    no one PyTorch call computes base2, pwl or maxonly."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            q, kp, vp, bt, pos = paged_case(torch, rng, t)
            nbytes, flops = paged_work(q, kp, bt, pos, window)
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            tag = f"T={t} window={window}"
            for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
                out = pa.paged_attention(q, kp, vp, bt, pos,
                                         attn_approx=mode, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"paged {mode} {tag}: non-finite")
                if mode == "maxonly":
                    err, same, banded, bad = maxonly_rows(
                        torch, out, q, kp, vp, bt, pos, window)
                    ok = bad == 0
                    verdict = (f"{same} rows equal to the plain version on "
                               f"f32 copies, {banded} the V row of a key "
                               f"within {MAXONLY_BAND}*|best| of the best "
                               f"f32 score, {bad} neither")
                else:
                    want = ref.paged_attention(q, kp, vp, bt, pos,
                                               attn_approx=mode,
                                               window=window)
                    err = (out.float() - want.float()).abs().max().item()
                    ok = torch.allclose(out.float(), want.float(),
                                        atol=PA_TOL, rtol=PA_TOL)
                    verdict = f"atol = rtol = {PA_TOL}"
                print(f"paged_attention {mode} {tag}: "
                      f"{split_line(pa, q, kp, bt)}; max_abs_err "
                      f"{err:.6g} vs plain ({verdict}): "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"paged attention {mode} {tag} disagrees with its "
                      "plain version")

                kern = timer.readings(lambda: pa.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode, window=window))
                plain_ms = timer(lambda: ref.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode, window=window))
                lib = NO_LIBRARY
                if mode in ("exact", "pseudo"):
                    scale = (math.log(2) if mode == "pseudo" else 1.0) \
                        / math.sqrt(q.shape[-1])
                    lib = timer.readings(sdpa_on_gathered_view(
                        torch, q, kp, vp, bt, pos, window, scale),
                        "library_")
                print(f"paged_attention {mode} {tag}: kernel {shown(kern)}, "
                      f"plain {plain_ms:.4f} ms, library "
                      f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
                      f"({bound_by}: {nbytes / 1e6:.3f} MB)", flush=True)
                rows[(mode, t, window)] = dict(
                    max_abs_err=err, **kern, plain_ms=plain_ms, **lib,
                    bound_ms=bound_ms, bound_by=bound_by)
                if (t, window) == (1, None):
                    passes = paged_passes(torch, lambda: pa.paged_attention(
                        q, kp, vp, bt, pos, attn_approx=mode))
                    print(f"paged_attention {mode} {tag} launches "
                          "(profiler, device): " + ", ".join(
                              f"{k} {v:.4f}" for k, v in passes.items()),
                          flush=True)
                    rows[(mode, t, window)]["passes"] = passes
    return rows


def pinned_case(torch, rng, t, window):
    """``paged_case`` in f32 with every value on a quarter step in [-4, 4],
    so that each score's dot product is exact in any order and kernel and
    plain version form the same f32 scores, and with each query's first
    visible key made its strict best: q[..., 0] = 4 and that key's K row
    20 * e_0 (19, 18, 17 for a later query's first key, which an earlier
    query of the row also sees), a score of 7.07 against ~N(0, 1.06) for
    the rest.  The kernel's running max then never moves after the first
    slice with a visible key, so it evaluates the score function at the
    max the plain version uses."""
    q, kp, vp, bt, pos = paged_case(torch, rng, t, dtype=torch.float32)
    for x in (q, kp, vp):
        x.copy_(torch.clamp(torch.round(x * 4), -16, 16) / 4)
    b, bs = q.shape[0], kp.shape[1]
    q[..., 0] = 4.0
    pos2, table = pos.reshape(b, -1).cpu().numpy(), bt.cpu().numpy()
    for r in range(b):
        first = pos2[r] * 0 if window is None else np.maximum(
            pos2[r] - window + 1, 0)
        for rank, p in enumerate(sorted(set(first.tolist()))):
            blk, off = int(table[r, p // bs]), p % bs
            kp[blk, off] = 0.0
            kp[blk, off, :, 0] = 20.0 - rank
    return q, kp, vp, bt, pos


def first_key_margin(torch, q, kp, bt, pos, window) -> float:
    """min over queries and heads of (the first visible key's f32 score -
    the best other visible key's)."""
    scores = visible_scores(torch, q, kp, bt, pos, window)
    kv = torch.arange(scores.shape[-1], device=q.device)
    first = (scores > -torch.inf).float().argmax(dim=-1, keepdim=True)
    own = scores.gather(-1, first)
    rest = torch.where(kv == first, -torch.inf, scores).amax(dim=-1,
                                                             keepdim=True)
    return (own - rest).min().item()


def check_paged_modes_pinned(torch, rng):
    """base2, pseudo and pwl (and exact) where kernel and plain version
    evaluate the score function at the same max (``pinned_case``; T = 1
    and 4, window None and 128).  In f32 the kernel agrees with its plain
    version within PIN_TOL (summation order only), and its gap to its own
    exact output is within PIN_GAP of the plain version's gap to exact --
    a kernel that ignored the mode would miss by the whole gap; on bf16
    copies of the same values it agrees with the plain version on the f32
    inputs within one bf16 step of the output."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    modes = ("exact", "base2", "pseudo", "pwl")
    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            tag = f"T={t} window={window}"
            q, kp, vp, bt, pos = pinned_case(torch, rng, t, window)
            margin = first_key_margin(torch, q, kp, bt, pos, window)
            check(margin > 0.25, f"paged pinned {tag}: the first visible "
                  f"key leads by {margin}, not > 0.25")
            want = {m: ref.paged_attention(q, kp, vp, bt, pos, attn_approx=m,
                                           window=window) for m in modes}
            got = {m: pa.paged_attention(q, kp, vp, bt, pos, attn_approx=m,
                                         window=window) for m in modes}
            bf = [x.to(torch.bfloat16) for x in (q, kp, vp)]
            got_bf = {m: pa.paged_attention(*bf, bt, pos, attn_approx=m,
                                            window=window) for m in modes}
            torch.cuda.synchronize()
            for mode in modes:
                err = (got[mode] - want[mode]).abs().max().item()
                ok = torch.allclose(got[mode], want[mode], atol=PIN_TOL,
                                    rtol=PIN_TOL)
                err_bf = (got_bf[mode].float() - want[mode]).abs().max()
                ok_bf = torch.allclose(got_bf[mode].float(), want[mode],
                                       atol=PIN_TOL, rtol=BF16_STEP)
                line = (f"paged_attention {mode} pinned {tag}: f32 "
                        f"max_abs_err {err:.6g} (atol = rtol = {PIN_TOL}), "
                        f"bf16 {err_bf.item():.6g} vs plain on f32 (atol "
                        f"{PIN_TOL}, rtol {BF16_STEP})")
                gap = miss = None
                if mode != "exact":
                    want_gap = want[mode] - want["exact"]
                    gap = want_gap.abs().max().item()
                    miss = ((got[mode] - got["exact"]) - want_gap
                            ).abs().max().item()
                    ok = ok and miss <= PIN_GAP * gap
                    line += (f"; gap to exact {gap:.6g} plain, kernel's "
                             f"off by {miss:.6g} (<= {PIN_GAP} x gap)")
                print(f"{line}: {'ok' if ok and ok_bf else 'FAIL'}",
                      flush=True)
                check(ok and ok_bf, f"paged attention {mode} pinned {tag} "
                      "disagrees with its plain version")
                rows[(mode, t, window)] = dict(max_abs_err=err, gap=gap,
                                               miss=miss)
    return rows


LUT_STEP = 2.0 ** (1 / 256) - 1   # base2: a weight's jump at a LUT bin edge
FLIP_EPS = 2.0 ** -19             # base2: y's rounding, relative (below)


def base2_flip_allowance(torch, q, kp, vp, bt, pos, window, out):
    """How far each f32 base2 output element may move when a score's LUT
    bin flips, and the number of keys that may flip.  Kernel and plain
    version form each score in another order (an fmaf chain times 1 /
    sqrt(hd), against a batched product divided by sqrt(hd)), so they
    differ by an ulp or so; the plain version's y = (s - M) log2 e of a
    key within FLIP_EPS * (1 + |s| + |M|) of an edge of the rounding
    rint(frac(y) * 256) (a half step, or an integer y; the row's best key
    at y = 0 only if another key scores that close to it) may land in the
    neighbouring bin in the kernel, moving that key's weight by LUT_STEP
    relative and the output by at most p_key * LUT_STEP * (|v_key| +
    |out|).  pwl's chords meet at their ends, so its weight moves only by
    the rounding itself."""
    from repro_torch.core import attn_approx as approx
    from repro_torch.core.softmax_variants import LOG2E

    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, tq = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    s = visible_scores(torch, q, kp, bt, pos, window)      # (b, t, hq, keys)
    vis = s > -torch.inf
    m = s.amax(dim=-1, keepdim=True)
    y = ((s - m) * LOG2E).double()
    frac = y - torch.floor(y)
    bins = frac * 256
    edge = torch.minimum((bins - torch.floor(bins) - 0.5).abs() / 256,
                         torch.minimum(frac, 1 - frac))
    top = s == m
    second = torch.where(top, -torch.inf, s).amax(dim=-1, keepdim=True)
    gap = torch.where(top.sum(-1, keepdim=True) > 1, 0.0,
                      (m - second) * LOG2E).double()
    edge = torch.where(top, gap, edge)
    near = vis & (edge <= FLIP_EPS * (1 + s.abs() + m.abs()).double())
    p = approx.attn_weights(torch.where(vis, s, -1e30), "base2")
    pn = torch.where(near, p, 0.0)
    v = vp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    o = out.float().reshape(b, tq, hq, hd)
    move = LUT_STEP * (torch.einsum("bths,bshd->bthd", pn, v.abs())
                       + o.abs() * pn.sum(-1, keepdim=True))
    return move.reshape(out.shape), int(near.sum())


def check_paged_modes_unpinned(torch, timer, rng):
    """base2 and pwl (and exact beside them) in f32 at the main path's
    shapes (``paged_case``, T = 1 and 4, window None and 128), on inputs
    with nothing pinned: the kernel weighs every score at its row's max,
    as the plain version does, so it agrees with the plain version within
    PIN_TOL -- base2 where no score's LUT bin may flip between the two
    roundings of the score, and within PIN_TOL plus the flips' own effect
    where one may (``base2_flip_allowance``).  A kernel that weighed at a
    chunk's or a slice's own max would miss by a LUT bin or a chord on
    every key.  Timed at T = 1 without a window."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 4):
        for window in (None, 128):
            tag = f"T={t} window={window}"
            q, kp, vp, bt, pos = paged_case(torch, rng, t,
                                            dtype=torch.float32)
            for mode in ("exact", "base2", "pwl"):
                got = pa.paged_attention(q, kp, vp, bt, pos,
                                         attn_approx=mode, window=window)
                want = ref.paged_attention(q, kp, vp, bt, pos,
                                           attn_approx=mode, window=window)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                room = PIN_TOL + PIN_TOL * want.abs()
                err, over = diff.max().item(), int((diff > room).sum())
                line = (f"paged_attention {mode} f32 unpinned {tag}: "
                        f"max_abs_err {err:.6g}, {over} of {diff.numel()} "
                        f"elements over atol = rtol = {PIN_TOL}")
                if mode == "base2":
                    move, keys = base2_flip_allowance(
                        torch, q, kp, vp, bt, pos, window, want)
                    ok = bool((diff <= room + move).all())
                    line += (f"; {keys} keys within {FLIP_EPS:.3g} "
                             f"relative of a LUT bin edge, allowance up to "
                             f"{move.max().item():.6g}, all within it")
                else:
                    ok = over == 0
                print(f"{line}: {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"paged attention {mode} f32 unpinned {tag} "
                      "disagrees with its plain version")
                rows[(mode, t, window)] = dict(max_abs_err=err, over=over)
                if (t, window) == (1, None):
                    kern = timer.readings(lambda: pa.paged_attention(
                        q, kp, vp, bt, pos, attn_approx=mode))
                    print(f"paged_attention {mode} f32 {tag}: kernel "
                          f"{shown(kern)}", flush=True)
                    rows[(mode, t, window)].update(kern)
    return rows


def paged_routes(torch, rng) -> dict:
    """The kernels paged attention ran per (dtype, mode), read from a
    profiler trace of one call (T = 1 over 2 ragged rows): bf16 must run
    the tensor-core kernel (``paged_attention_mma_kernel``) in every mode,
    f32 the CUDA-core one (``paged_attention_kernel``); base2 and pwl run
    the row-max pre-pass of the same route first
    (``paged_rowmax_mma_kernel`` / ``paged_rowmax_kernel``), the other
    modes none."""
    from repro_torch.kernels import paged_attention as pa

    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, bt, pos = paged_case(torch, rng, 1, b=2, dtype=dtype)
        for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
            names = [n for n in device_kernels(
                torch, lambda: pa.paged_attention(q, kp, vp, bt, pos,
                                                  attn_approx=mode),
                "paged_attention") if "paged_" in n]
            mma = [n for n in names if "paged_attention_mma_kernel" in n]
            core = [n for n in names if "paged_attention_kernel" in n]
            pre_mma = [n for n in names if "paged_rowmax_mma_kernel" in n]
            pre_core = [n for n in names if "paged_rowmax_kernel" in n]
            route = ("mma" if mma and not core else
                     "cuda-core" if core and not mma else f"? {names}")
            pre = ("mma" if pre_mma and not pre_core else
                   "cuda-core" if pre_core and not pre_mma else
                   None if not (pre_mma or pre_core) else f"? {names}")
            tag = f"{str(dtype).replace('torch.', '')} {mode}"
            routes[tag] = route if pre is None else \
                f"{route} after a row-max pre-pass ({pre})"
            want = "mma" if dtype == torch.bfloat16 else "cuda-core"
            want_pre = want if mode in pa.PREMAX_MODES else None
            print(f"paged_attention route {tag}: {routes[tag]} (ran "
                  f"{', '.join(n[:60] for n in names)})", flush=True)
            check(route == want and pre == want_pre,
                  f"paged attention {tag} ran {names}, not the {want} "
                  f"kernel with {want_pre} pre-pass")
    return routes


def check_paged_invariance(torch, rng):
    """A row's attention bits depend on its own inputs, dtype, head dim
    and mode only.  At the main path's shapes (bf16, 16/8 heads, hd 128),
    in every score mode: each of 8 ragged rows alone (B 1, a table of its
    own width, so fewer chunks) equals, bit for bit, the same row in the
    batch beside the 1,000-token row (B 8, a 1,024-position table, 16
    chunks); and each row's T = 1 output equals every column of the same
    row at T = 8 whose padding queries repeat its position."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.paged_kv import pow2

    q, kp, vp, bt, pos = paged_case(torch, rng, 1)
    b, bs = q.shape[0], kp.shape[1]
    q8 = q[:, None].expand(b, 8, *q.shape[1:]).contiguous()
    pos8 = pos[:, None].expand(b, 8).contiguous()
    out = {}
    for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
        batch = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
        alone = []
        for r in range(b):
            nb = pow2(int(pos[r]) // bs + 1)
            alone.append(pa.paged_attention(
                q[r:r + 1].contiguous(), kp, vp,
                bt[r:r + 1, :nb].contiguous(), pos[r:r + 1],
                attn_approx=mode))
        wide = pa.paged_attention(q8, kp, vp, bt, pos8, attn_approx=mode)
        torch.cuda.synchronize()
        rows_ok = sum(bool(torch.equal(a[0], batch[r]))
                      for r, a in enumerate(alone))
        cols_ok = sum(bool(torch.equal(wide[:, t], batch))
                      for t in range(8))
        chunks = sorted({pa.split_for(q[:1], kp, bt[:1, :pow2(
            int(pos[r]) // bs + 1)])[0] for r in range(b)})
        print(f"paged_attention {mode} invariance: {rows_ok}/{b} rows "
              f"alone (chunks {chunks}) bitwise equal to the same row at "
              f"B {b} ({pa.split_for(q, kp, bt)[0]} chunks); "
              f"{cols_ok}/8 columns of T 8 bitwise equal to T 1: "
              f"{'ok' if rows_ok == b and cols_ok == 8 else 'FAIL'}",
              flush=True)
        check(rows_ok == b, f"paged {mode}: a row alone differs from the "
              "same row beside a 1,000-token row")
        check(cols_ok == 8, f"paged {mode}: T 8 with repeated positions "
              "differs from T 1")
        out[mode] = dict(rows_equal=rows_ok, columns_equal=cols_ok)
    return out


def check_head_dim_192(torch, timer, rng):
    """nemotron-4-340b's head dim 192 (96 query / 8 KV heads, g 12) in
    both attention kernels, bf16, against their plain versions at the
    existing tolerances: paged attention at T = 1 and 32 over 8 ragged
    rows in every score mode (maxonly by ``maxonly_rows``), and flash
    attention over a 512-token prompt, causal, at g 2 and 12; flash at g
    2 and paged exact at T 1 timed beside SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    for t in (1, 32):
        q, kp, vp, bt, pos = paged_case(torch, rng, t, hq=96, hkv=8,
                                        hd=192)
        for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
            out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"paged hd 192 {mode} T={t}: non-finite")
            if mode == "maxonly":
                err, _, _, bad = maxonly_rows(torch, out, q, kp, vp, bt, pos,
                                              None)
                ok = bad == 0
            else:
                want = ref.paged_attention(q, kp, vp, bt, pos,
                                           attn_approx=mode)
                err = (out.float() - want.float()).abs().max().item()
                ok = torch.allclose(out.float(), want.float(), atol=PA_TOL,
                                    rtol=PA_TOL)
            print(f"paged_attention hd 192 {mode} T={t}: max_abs_err "
                  f"{err:.6g} vs plain: {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"paged attention hd 192 {mode} T={t} disagrees with "
                  "its plain version")
            rows[f"paged_T{t}_{mode}"] = dict(max_abs_err=err)
            if mode in ("base2", "pwl") or (mode, t) == ("exact", 32):
                kern = timer.readings(lambda: pa.paged_attention(
                    q, kp, vp, bt, pos, attn_approx=mode))
                print(f"paged_attention hd 192 {mode} T={t}: kernel "
                      f"{shown(kern)}", flush=True)
                rows[f"paged_T{t}_{mode}"].update(kern)
        if t == 1:
            kern = timer.readings(lambda: pa.paged_attention(
                q, kp, vp, bt, pos))
            lib = timer.readings(sdpa_on_gathered_view(
                torch, q, kp, vp, bt, pos, None, 1 / math.sqrt(192)),
                "library_")
            nbytes, flops = paged_work(q, kp, bt, pos, None)
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            print(f"paged_attention hd 192 T=1: kernel {shown(kern)}, "
                  f"sdpa(gathered view) {shown(lib, 'library_')}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            rows["paged_T1_exact"].update(kern, bound_ms=bound_ms,
                                          bound_by=bound_by, **lib)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for hq, hkv in ((16, 8), (96, 8)):
        q, k, v = (torch.randn((1, 512, h, 192), generator=gen,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2) for h in (hq, hkv, hkv))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=FA_TOL,
                            rtol=FA_TOL)
        g = hq // hkv
        print(f"flash_attention hd 192 T512 g {g}: max_abs_err {err:.6g} "
              f"vs plain (atol = rtol = {FA_TOL}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash attention hd 192 g {g} disagrees with its plain "
              "version")
        row = dict(max_abs_err=err)
        if g == 2:
            row.update(timer.readings(lambda: fa.flash_attention(q, k, v)))
            row.update(timer.readings(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), "library_"))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            flops = 4 * 192 * hq * 512 * 513 // 2
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
            print(f"flash_attention hd 192 T512 g 2: kernel {shown(row)}, "
                  f"sdpa {shown(row, 'library_')}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})",
                  flush=True)
        rows[f"flash_T512_g{g}"] = row
    return rows


def argmax_verdict(torch, h, w, idx, val):
    """The argmax head's (idx, val) against its plain version: (idx_ok,
    val_ok, max_abs_err, plain idx).  Indices must be equal where the
    plain top-2 f32 logit gap exceeds HEAD_RTOL * |max|; values within
    rtol HEAD_RTOL."""
    from repro_torch.kernels import ref

    ridx, rval = ref.fused_argmax_head_with_value(h, w)
    top2 = torch.matmul(h.float(), w.float()).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > HEAD_RTOL * rval.abs()
    idx_ok = bool(((idx == ridx) | ~decided).all())
    val_ok = torch.allclose(val, rval, rtol=HEAD_RTOL, atol=0.0)
    return idx_ok, val_ok, (val - rval).abs().max().item(), ridx


def topk_verdict(torch, h, w, k, vals, idxs) -> dict:
    """The top-k head's (vals, idxs) against its plain version: indices
    equal where a value stands apart from both plain neighbours by more
    than HEAD_RTOL * |val|, equal values in increasing index order,
    values descending and within rtol HEAD_RTOL."""
    from repro_torch.kernels import ref

    rvals, ridxs = ref.fused_topk_head(h, w, k)
    full, _ = ref.fused_topk_head(h, w, k + 1)
    inf = torch.full_like(full[:, :1], float("inf"))
    to_next = full - torch.cat([full[:, 1:], -inf], dim=1)
    to_prev = torch.cat([inf, to_next[:, :-1]], dim=1)
    decided = (torch.minimum(to_next, to_prev)
               > HEAD_RTOL * full.abs())[:, :k]
    tied = vals[:, 1:] == vals[:, :-1]
    return dict(
        idx_ok=bool(((idxs == ridxs) | ~decided).all()),
        ties_ok=bool((~tied | (idxs[:, 1:] > idxs[:, :-1])).all()),
        desc_ok=bool((vals[:, 1:] <= vals[:, :-1]).all()),
        val_ok=torch.allclose(vals, rvals, rtol=HEAD_RTOL, atol=0.0),
        err=(vals - rvals).abs().max().item(), n_ties=int(tied.sum()))


def topk_line(tv: dict) -> str:
    ok = {k: "ok" if tv[k] else "FAIL"
          for k in ("idx_ok", "ties_ok", "desc_ok", "val_ok")}
    return (f"idx {ok['idx_ok']} (equal where the value stands apart by > "
            f"{HEAD_RTOL}*|val|), {tv['n_ties']} equal neighbours "
            f"{ok['ties_ok']} (lower index first), descending "
            f"{ok['desc_ok']}, val max_abs_err {tv['err']:.6g} (rtol "
            f"{HEAD_RTOL}): {ok['val_ok']}")


def head_routes(torch) -> dict:
    """The pass-1 kernel the argmax and verify heads ran per dtype, read
    from a profiler trace of one call at qwen3-0.6b's width (B 8; T 8):
    bf16 must run the tensor-core tile (``argmax_wgmma_partial_kernel``),
    f32 the CUDA-core one (``argmax_partial_kernel``)."""
    from repro_torch.kernels import fused_argmax_head as fah

    gen = torch.Generator(device="cuda").manual_seed(11)
    routes = {}
    for dt, want in ((torch.bfloat16, "wgmma"),
                     (torch.float32, "cuda-core")):
        w = torch.randn((151936, 1024), generator=gen, device="cuda").to(dt)
        h = torch.randn((8, 8, 1024), generator=gen, device="cuda").to(dt)
        h1 = h[:, 0].contiguous()
        cand = torch.full((8, 7), -1, dtype=torch.int32, device="cuda")
        for entry, shape, fn in (
                ("argmax", h1.shape,
                 lambda: fah.fused_argmax_head_with_value(h1, w.t())),
                ("verify", h.shape,
                 lambda: fah.fused_verify_head(h, w.t(), cand))):
            names = [n for n in device_kernels(torch, fn, "_partial_kernel")
                     if "_partial_kernel" in n]
            wg = [n for n in names if "argmax_wgmma_partial_kernel" in n]
            core = [n for n in names if "argmax_partial_kernel" in n]
            route = ("wgmma" if wg and not core else
                     "cuda-core" if core and not wg else f"? {names}")
            tag = f"{entry} {str(dt).replace('torch.', '')}"
            routes[tag] = route
            plan = fah.head_plan(tuple(shape), 151936, dt,
                                 *fah.device_limits(0))
            print(f"head route {tag}: {route} (ran "
                  f"{', '.join(n[:60] for n in names)}; plan {plan})",
                  flush=True)
            check(route == want and plan.route == want,
                  f"head {tag} ran {names}, not the {want} kernel")
        del w
    geometry = fah.tile_geometry()
    check(geometry == (fah.VOCAB_TILE, fah.K_SLAB, fah.ROW_GROUP,
                       fah.STAGES, fah.TILE_SMEM_BYTES),
          f"the head tile's geometry {geometry} differs from the wrapper's")
    return routes


def check_argmax_head(torch, timer):
    """The argmax head at qwen3-0.6b's width, bf16, B 1, 8 (the main
    path's) and 64, with cross-split ties planted."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(1)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    rows = {}
    for b in (1, 8, 64):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        # plant cross-split ties: copy each row's winner to the vocab row
        # half the vocabulary away, so an exact tie spans two far splits
        win = ref.fused_argmax_head(h, emb.t()).tolist()
        pairs = [(a, a - v // 2 if a >= v // 2 else a + v // 2) for a in win]
        for a, j in pairs:
            emb[j] = emb[a]
        w = emb.t()                                         # (D, V) view
        idx, val = fah.fused_argmax_head_with_value(h, w)
        torch.cuda.synchronize()
        idx_ok, val_ok, err, ridx = argmax_verdict(torch, h, w, idx, val)
        # rows whose winner is still a planted pair of equal vocab rows:
        # the kernel sums both identically, so it must return the lower
        live = [(r, min(a, j)) for r, (a, j) in enumerate(pairs)
                if torch.equal(emb[a], emb[j]) and int(ridx[r]) in (a, j)]
        ties_ok = all(int(idx[r]) == lo for r, lo in live)
        print(f"fused_argmax_head B={b}: idx {'ok' if idx_ok else 'FAIL'} "
              f"(equal where the top-2 gap > {HEAD_RTOL}*|val|), "
              f"{len(live)} planted cross-split ties "
              f"{'ok' if ties_ok else 'FAIL'} (lowest index wins), val "
              f"max_abs_err {err:.6g} (rtol {HEAD_RTOL}): "
              f"{'ok' if val_ok else 'FAIL'}", flush=True)
        check(idx_ok and ties_ok and val_ok,
              f"fused argmax head B={b} disagrees with its plain version")
        check(len(live) > 0, "no planted tie reached the top")

        kern = timer.readings(lambda: fah.fused_argmax_head_with_value(
            h, w))
        plain_ms = timer(lambda: ref.fused_argmax_head_with_value(h, w))
        lib = timer.readings(lambda: torch.argmax(h @ w, dim=-1), "library_")
        nbytes = v * d * 2 + b * d * 2 + b * 8
        bound_ms, bound_by = bound(nbytes, 2.0 * b * d * v,
                                   BF16_FLOPS_PER_S)
        print(f"fused_argmax_head B={b}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, argmax(h @ W) {shown(lib, 'library_')}, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        rows[b] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def check_topk_head(torch, timer):
    """The top-k head at qwen3-0.6b's width, B in {1, 4, 8} (4 is the
    main path's top-k group), k in {1, 8, 64}, bf16, with planted ties:
    each row's plain winners copied half the vocabulary away, so equal
    values sit in far vocabulary splits.  Values at rtol 1e-3; indices
    equal to the plain version's where a value stands apart from both
    neighbours by more than that; among the kernel's equal values the
    lower index first."""
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(2)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    rows = {}
    for b in (1, 4, 8):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        _, win = ref.fused_topk_head(h, emb.t(), 4)
        for a in win.flatten().tolist():
            emb[(a + v // 2) % v] = emb[a]
        w = emb.t()
        for k in (1, 8, 64):
            vals, idxs = ftk.fused_topk_head(h, w, k)
            torch.cuda.synchronize()
            tv = topk_verdict(torch, h, w, k, vals, idxs)
            err, n_ties = tv["err"], tv["n_ties"]
            print(f"fused_topk_head B={b} k={k}: {topk_line(tv)}",
                  flush=True)
            check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"]
                  and tv["val_ok"],
                  f"top-k head B={b} k={k} disagrees with its plain version")
            if k > 1:
                check(n_ties > 0, f"no planted tie reached the top {k}")

            kern = timer.readings(lambda: ftk.fused_topk_head(h, w, k))
            plain_ms = timer(lambda: ref.fused_topk_head(h, w, k))
            lib = timer.readings(lambda: torch.topk(h @ w, k, dim=-1),
                                 "library_")
            nbytes = v * d * 2 + b * d * 2 + b * k * 8
            bound_ms, bound_by = bound(nbytes, 2.0 * b * d * v,
                                       BF16_FLOPS_PER_S)
            print(f"fused_topk_head B={b} k={k}: kernel {shown(kern)}, "
                  f"plain {plain_ms:.4f} ms, topk(h @ W) "
                  f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
            rows[(b, k)] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def kernel_device_ms(torch, fn, iters=20) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, by name,
    from a profiler trace over ``iters`` calls, the L2 flushed before
    each (the flush's own kernel is listed too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    return out


def check_topk_passes(torch):
    """The top-k head's two kernels timed apart (profiler, device ms) at
    the main path's B 4, k 8 and 64, qwen3-0.6b's width; then k 64 on
    integer-valued operands, whose sums are exact in any order and whose
    logits tie across every vocabulary split: values and indices equal to
    ``ref.topk_select`` of the logits bit for bit."""
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d, b = 151936, 1024, 4
    gen = torch.Generator(device="cuda").manual_seed(9)
    emb = (torch.randn((v, d), generator=gen, device="cuda")
           / math.sqrt(d)).to(torch.bfloat16)
    h = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
    passes = {}
    for k in (8, 64):
        times = kernel_device_ms(torch, lambda: ftk.fused_topk_head(
            h, emb.t(), k))
        part = sum(t for n, t in times.items() if "topk_partial_kernel" in n)
        merge = sum(t for n, t in times.items() if "topk_merge_kernel" in n)
        check(part > 0 and merge > 0, f"top-k k={k}: the trace shows no "
              f"pass 1 or pass 2 kernel: {sorted(times)}")
        print(f"fused_topk_head B={b} k={k} passes (profiler, device): pass "
              f"1 topk_partial_kernel {part:.4f} ms, pass 2 "
              f"topk_merge_kernel {merge:.4f} ms", flush=True)
        passes[k] = dict(partial_ms=part, merge_ms=merge)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    h = torch.randint(-1, 2, (b, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    vals, idxs = ftk.fused_topk_head(h, emb.t(), 64)
    torch.cuda.synchronize()
    rvals, ridxs = ref.topk_select(torch.matmul(h.float(), emb.float().t()),
                                   64)
    same = torch.equal(vals, rvals) and torch.equal(idxs, ridxs)
    ties = int((vals[:, 1:] == vals[:, :-1]).sum())
    print(f"fused_topk_head B={b} k=64 on integer operands ({ties} equal "
          f"neighbours): values and indices "
          f"{'bitwise equal to' if same else 'DIFFER from'} "
          f"ref.topk_select", flush=True)
    check(same and ties > 0, "top-k k=64 differs from ref.topk_select on "
          "exact integer logits")
    return passes


def check_verify_head(torch, timer):
    """The verify head at qwen3-0.6b's width, bf16: B 8 rows of T in {2,
    8, 32} positions, and B 1 at T 32 (the spec_k 20 request).
    Integer-valued operands make every sum exact in any order, so ids
    and accept must equal the plain version's exactly.  Drafts: a prefix
    of each row's ids of ragged width (-1 padded), some with a wrong
    token inside the run.  Yardstick: ``argmax(h @ W)`` over the B*T
    rows (no one PyTorch call verifies)."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import ref

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = emb.t()
    rng = np.random.default_rng(3)
    rows = {}
    for b, t in ((8, 2), (8, 8), (1, 32), (8, 32)):
        h = torch.randint(-1, 2, (b, t, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        ids0, _ = ref.verify_draft(h, w, torch.full(
            (b, t - 1), -1, dtype=torch.int32, device="cuda"))
        cand = np.full((b, t - 1), -1, np.int32)
        for r in range(b):
            width = r % t                          # ragged: 0 .. T-1
            cand[r, :width] = ids0[r, :width].cpu().numpy()
            if width and r % 3 == 0:               # a wrong draft
                j = int(rng.integers(0, width))
                cand[r, j] = (cand[r, j] + 1) % v
        cand_t = torch.from_numpy(cand).to("cuda")
        ids, acc = fah.fused_verify_head(h, w, cand_t)
        torch.cuda.synchronize()
        rids, racc = ref.verify_draft(h, w, cand_t)
        ok = torch.equal(ids, rids) and torch.equal(acc, racc)
        print(f"fused_verify_head B={b} T={t}: ids and accept "
              f"{'equal' if ok else 'DIFFER'} (exact; accept "
              f"{acc.tolist()})", flush=True)
        check(ok, f"verify head T={t} disagrees with its plain version")

        h2 = h.view(b * t, d)
        kern = timer.readings(lambda: fah.fused_verify_head(h, w, cand_t))
        plain_ms = timer(lambda: ref.verify_draft(h, w, cand_t))
        lib = timer.readings(lambda: torch.argmax(h2 @ w, dim=-1),
                             "library_")
        nbytes = v * d * 2 + b * t * d * 2 + cand.size * 4 + b * t * 4 + b * 4
        bound_ms, bound_by = bound(nbytes, 2.0 * b * t * d * v,
                                   BF16_FLOPS_PER_S)
        print(f"fused_verify_head B={b} T={t}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, argmax(h @ W) over the {b * t} rows "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        rows[(b, t)] = dict(max_abs_err=0.0, **kern, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows


def check_head_invariance(torch):
    """A row's head result depends on its own h, W and D only: at
    qwen3-0.6b's width, bf16, random h, each of 8 rows' (val, idx) from
    the argmax head alone (B 1) is bit-equal to the same row as row r of
    B 8 and of B 64, and its id equals position t of the verify head at
    T 8 and T 32 (rows in the same order)."""
    from repro_torch.kernels import fused_argmax_head as fah

    v, d = 151936, 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(torch.bfloat16).t()
    h = torch.randn((256, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    alone = [fah.fused_argmax_head_with_value(h[r:r + 1].contiguous(), w)
             for r in range(8)]
    b8 = fah.fused_argmax_head_with_value(h[:8].contiguous(), w)
    b64 = fah.fused_argmax_head_with_value(h[:64].contiguous(), w)
    ids = {t: fah.fused_verify_head(
        h[:8 * t].reshape(8, t, d).contiguous(), w,
        torch.full((8, t - 1), -1, dtype=torch.int32,
                   device="cuda"))[0].view(-1) for t in (8, 32)}
    torch.cuda.synchronize()
    ok = {"B 8": 0, "B 64": 0, "verify T 8": 0, "verify T 32": 0}
    for r, (i1, v1) in enumerate(alone):
        ok["B 8"] += bool(torch.equal(i1[0], b8[0][r])
                          and torch.equal(v1[0], b8[1][r]))
        ok["B 64"] += bool(torch.equal(i1[0], b64[0][r])
                           and torch.equal(v1[0], b64[1][r]))
        ok["verify T 8"] += int(ids[8][r]) == int(i1[0])
        ok["verify T 32"] += int(ids[32][r]) == int(i1[0])
    same64 = {t: bool(torch.equal(ids[t][:64], b64[0])) for t in (8, 32)}
    print("head invariance: " + ", ".join(
        f"{k} {n}/8 rows bitwise" for k, n in ok.items())
        + f" (alone vs the same row there); the B 64 ids == verify T 8 "
        f"{same64[8]}, == verify T 32's first 64 {same64[32]}", flush=True)
    check(all(n == 8 for n in ok.values()) and all(same64.values()),
          f"a row's head result depends on its batch: {ok}, {same64}")
    return dict(ok, b64_is_verify_t8=same64[8],
                b64_is_verify_t32=same64[32])


def wide_weight(torch, gen, v, d):
    """(V, D) bf16 with rows N(0, 1/D), made in slices (no f32 copy of
    the whole)."""
    emb = torch.empty((v, d), dtype=torch.bfloat16, device="cuda")
    for a in range(0, v, 16384):
        emb[a:a + 16384] = (torch.randn((min(16384, v - a), d), generator=gen,
                                        device="cuda") / math.sqrt(d))
    return emb


def check_wide_heads(torch, timer):
    """nemotron-4-340b's head width: D 18432, V 256000, bf16 (W 9.44 GB;
    each plain version's f32 copy of W is 18.9 GB).  The argmax head at B
    1 and 8, the verify head at B 8, T 8 and the top-k head at B 8, k 8
    against their plain versions at the existing tolerances (the verify
    head's ids where the plain top-2 gap is decided, its accept where
    every drafted position is), each timed beside its library call and
    its bound."""
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import fused_topk_head as ftk
    from repro_torch.kernels import ref

    v, d = 256000, 18432
    gen = torch.Generator(device="cuda").manual_seed(13)
    emb = wide_weight(torch, gen, v, d)
    w = emb.t()
    rows = {}

    def timed(tag, kern_fn, lib_fn, nrows, out_bytes):
        kern = timer.readings(kern_fn)
        lib = timer.readings(lib_fn, "library_")
        bound_ms, bound_by = bound(v * d * 2 + nrows * d * 2 + out_bytes,
                                   2.0 * nrows * d * v, BF16_FLOPS_PER_S)
        print(f"wide head {tag}: kernel {shown(kern)}, library "
              f"{shown(lib, 'library_')}, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        return dict(**kern, bound_ms=bound_ms, bound_by=bound_by, **lib)

    for b in (1, 8):
        h = torch.randn((b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        idx, val = fah.fused_argmax_head_with_value(h, w)
        torch.cuda.synchronize()
        idx_ok, val_ok, err, _ = argmax_verdict(torch, h, w, idx, val)
        print(f"wide head argmax B={b} (D {d}, V {v}): idx "
              f"{'ok' if idx_ok else 'FAIL'}, val max_abs_err {err:.6g} "
              f"(rtol {HEAD_RTOL}): {'ok' if val_ok else 'FAIL'}",
              flush=True)
        check(idx_ok and val_ok, f"wide argmax head B={b} disagrees with "
              "its plain version")
        rows[f"argmax_B{b}"] = dict(max_abs_err=err, **timed(
            f"argmax B={b}", lambda: fah.fused_argmax_head_with_value(h, w),
            lambda: torch.argmax(h @ w, dim=-1), b, 8 * b))

    b, t = 8, 8
    h = torch.randn((b, t, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    rids, _ = ref.verify_draft(h, w, torch.full(
        (b, t - 1), -1, dtype=torch.int32, device="cuda"))
    cand = rids[:, :t - 1].clone()
    cand[::3, 2] = (cand[::3, 2] + 1) % v              # wrong drafts
    cand[1::4, 4:] = -1                                # ragged widths
    ids, acc = fah.fused_verify_head(h, w, cand)
    torch.cuda.synchronize()
    rids, racc = ref.verify_draft(h, w, cand)
    top2 = torch.matmul(h.view(b * t, d).float(), w.float()).topk(
        2, dim=-1).values
    decided = ((top2[:, 0] - top2[:, 1])
               > HEAD_RTOL * top2[:, 0].abs()).view(b, t)
    ids_ok = bool(((ids == rids) | ~decided).all())
    acc_ok = bool(((acc == racc) | ~decided.all(dim=1)).all())
    print(f"wide head verify B={b} T={t}: ids {'ok' if ids_ok else 'FAIL'} "
          f"({int(decided.sum())}/{b * t} decided), accept "
          f"{'ok' if acc_ok else 'FAIL'} ({acc.tolist()})", flush=True)
    check(ids_ok and acc_ok, "wide verify head disagrees with its plain "
          "version")
    h2 = h.view(b * t, d)
    rows["verify_B8_T8"] = dict(decided=int(decided.sum()), **timed(
        f"verify B={b} T={t}", lambda: fah.fused_verify_head(h, w, cand),
        lambda: torch.argmax(h2 @ w, dim=-1), b * t, 12 * b * t))

    h = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    plan = ftk.topk_plan(8, d, v, torch.bfloat16, *fah.device_limits(0))
    vals, idxs = ftk.fused_topk_head(h, w, 8)
    torch.cuda.synchronize()
    tv = topk_verdict(torch, h, w, 8, vals, idxs)
    print(f"wide head top-k B=8 k=8 ({plan.row_block} rows per block, "
          f"{plan.row_blocks} row chunks): {topk_line(tv)}", flush=True)
    check(tv["idx_ok"] and tv["ties_ok"] and tv["desc_ok"] and tv["val_ok"],
          "wide top-k head disagrees with its plain version")
    rows["topk_B8_k8"] = dict(max_abs_err=tv["err"], **timed(
        "top-k B=8 k=8", lambda: ftk.fused_topk_head(h, w, 8),
        lambda: torch.topk(h @ w, 8, dim=-1), 8, 64),
        row_block=plan.row_block)
    del emb, w
    torch.cuda.empty_cache()
    return rows


def device_kernels(torch, fn, seen, attempts=8) -> list:
    """Names of the device kernels a profiler trace saw ``fn`` launch.
    ``fn`` runs once first, so that its kernels' lazy loading happens
    outside the trace (a first launch can go unrecorded).  A trace can
    also lose its first kernel, so each trace launches a small add
    before ``fn``; a trace with no device event whose name holds ``seen``
    is the profiler's miss, not an answer: ``fn`` is traced again, up to
    ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad.add_(1)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if any(seen in n for n in names):
            break
    if attempt:
        print(f"  (the profiler missed {seen!r} in {attempt} of "
              f"{attempt + 1} traces)", flush=True)
    return names


def flash_routes(torch) -> dict:
    """The kernel flash attention ran per (dtype, head dim), read from a
    profiler trace of one call: bf16 must run the tensor-core kernel
    (``flash_attention_mma_kernel``) at every head dim, f32 the CUDA-core
    one (``flash_attention_kernel``)."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    routes = {}
    for dt, want in ((torch.bfloat16, "mma.sync"),
                     (torch.float32, "cuda-core")):
        for hd in (16, 32, 64, 128, 192, 256):
            q, k, v = (torch.randn((1, h, 64, hd), generator=gen,
                                   device="cuda").to(dt) for h in (2, 1, 1))
            names = [n for n in device_kernels(
                torch, lambda: fa.flash_attention(q, k, v),
                "flash_attention") if "flash_attention" in n]
            mma = [n for n in names if "flash_attention_mma_kernel" in n]
            core = [n for n in names if "flash_attention_kernel" in n]
            tag = f"{str(dt).replace('torch.', '')} hd {hd}"
            route = ("mma.sync" if mma and not core else
                     "cuda-core" if core and not mma else f"? {names}")
            routes[tag] = route
            print(f"flash_attention route {tag}: {route} (ran "
                  f"{', '.join(n[:60] for n in names)})", flush=True)
            check(route == want, f"flash attention {tag} ran {names}, not "
                  f"the {want} kernel")
    return routes


def check_flash_attention(torch, timer):
    """Flash attention at the prefill's shapes: one prompt (B 1) of T = S
    in {71, 512} tokens, qwen3-0.6b's 16 query / 8 KV heads of hd 128,
    bf16, causal; then g 8 (64 / 8 heads, qwen3-32b's) and a causal
    window of 128, both at 512.  Operands are the transposed (B, T, H,
    hd) views the layer passes.  Yardstick: SDPA on the same views.
    Returns the rows and ``flash_routes``' kernels per (dtype, hd)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    routes = flash_routes(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, t, hq, hkv, window in (("T71", 71, 16, 8, None),
                                     ("T512", 512, 16, 8, None),
                                     ("T512_g8", 512, 64, 8, None),
                                     ("T512_w128", 512, 16, 8, 128)):
        hd = 128

        def rand(heads):
            return torch.randn((1, t, heads, hd), generator=gen,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        check(bool(torch.isfinite(out).all()), f"flash {name}: non-finite")
        err = (out.float() - want.float()).abs().max().item()
        ok = torch.allclose(out.float(), want.float(), atol=FA_TOL,
                            rtol=FA_TOL)
        print(f"flash_attention {name}: max_abs_err {err:.6g} vs plain "
              f"(atol = rtol = {FA_TOL}): {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"flash attention {name} disagrees with its plain version")
        check_repeatable(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), f"flash_attention {name}")

        idx = torch.arange(t, device="cuda")
        mask = idx[None, :] <= idx[:, None]
        if window is not None:
            mask &= idx[None, :] > idx[:, None] - window
        sdpa = (dict(is_causal=True) if window is None
                else dict(attn_mask=mask))
        kern = timer.readings(lambda: fa.flash_attention(
            q, k, v, causal=True, window=window))
        plain_ms = timer(lambda: ref.flash_attention(q, k, v, causal=True,
                                                     window=window))
        lib = timer.readings(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **sdpa), "library_")
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * hq * int(mask.sum())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        print(f"flash_attention {name}: kernel {shown(kern)}, plain "
              f"{plain_ms:.4f} ms, sdpa {shown(lib, 'library_')}, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.3f} GFLOP)", flush=True)
        rows[name] = dict(max_abs_err=err, **kern, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, **lib)
    return rows, routes


def unit_errors(torch, x, lab, m, l, p, loss):
    """Max abs errors of the unit kernels' outputs against their plain
    versions on (x, lab), after checking each within its tolerance
    (``p`` None: online_softmax not run)."""
    from repro_torch.kernels import ref

    rm, rl = ref.softmax_stats(x)
    checks = [("softmax_stats m", m, rm, UNIT_ATOL),
              ("softmax_stats l", l, rl, UNIT_ATOL),
              ("fused_xent", loss, ref.fused_xent(x, lab), XENT_ATOL)]
    if p is not None:
        checks.append(("online_softmax", p, ref.online_softmax(x),
                       UNIT_ATOL))
    errs = {}
    for what, got, want, atol in checks:
        ok = torch.allclose(got, want, rtol=UNIT_RTOL, atol=atol)
        errs[what] = (got - want).abs().max().item()
        print(f"  {what}: max_abs_err {errs[what]:.6g} (rtol {UNIT_RTOL}, "
              f"atol {atol}): {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{what} disagrees with its plain version")
    out = {"softmax_stats": max(errs["softmax_stats m"],
                                errs["softmax_stats l"]),
           "fused_xent": errs["fused_xent"]}
    if p is not None:
        sums = p.sum(-1)
        check(bool(((sums - 1).abs() <= 1e-5).all()),
              "online_softmax rows do not sum to 1 within 1e-5")
        out["online_softmax"] = errs["online_softmax"]
    return out


def split_errors(torch, x, lab, m, l, loss, rows) -> float:
    """The stats and the cross-entropy of the first ``rows`` rows against
    their split models (``softmax_stats_split``, ``fused_xent_split``:
    the kernels' own fold and merge order) at the unit tolerances; the
    max abs error."""
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ref

    xs, ls = x[:rows], lab[:rows]
    plan = osm.plan_of(x)
    sm, sl = ref.softmax_stats_split(xs, plan)
    sx = ref.fused_xent_split(xs, ls, plan)
    errs = {}
    for what, got, want, atol in (("m", m[:rows], sm, UNIT_ATOL),
                                  ("l", l[:rows], sl, UNIT_ATOL),
                                  ("loss", loss[:rows], sx, XENT_ATOL)):
        errs[what] = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=UNIT_RTOL, atol=atol),
              f"{what} of rows :{rows} disagrees with its split model")
    print(f"  softmax_stats / fused_xent vs softmax_stats_split / "
          f"fused_xent_split (rows :{rows}): max_abs_err m "
          f"{errs['m']:.6g}, l {errs['l']:.6g}, loss {errs['loss']:.6g}: ok",
          flush=True)
    return max(errs.values())


UNIT_KERNELS = ("unit_stats_kernel", "unit_xent_kernel",
                "unit_one_pass_kernel", "normalize_kernel")


def unit_kernels(torch, fn) -> list:
    """The softmax unit's device kernels one call of ``fn`` launched,
    from a profiler trace."""
    return [k for n in device_kernels(torch, fn, "unit_")
            for k in UNIT_KERNELS if k in n]


def unit_route(torch, x, lab, softmax=True) -> dict:
    """The plan of rows x, and the device kernels one call of each
    wrapper ran: softmax_stats and fused_xent (labels ``lab``) one at any
    B, online_softmax (unless ``softmax`` is False) one on the one-pass
    route and two on the other."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    plan = osm.plan_of(x)
    calls = [("softmax_stats", lambda: osm.softmax_stats(x)),
             ("fused_xent", lambda: fx.fused_xent(x, lab))]
    if softmax:
        calls.append(("online_softmax", lambda: osm.online_softmax(x)))
    kernels = {name: unit_kernels(torch, fn) for name, fn in calls}
    tag = (f"B={x.shape[0]} V={x.shape[1]} "
           f"{str(x.dtype).replace('torch.', '')}")
    print(f"softmax unit {tag}: plan chunk {plan.chunk}, nsplit "
          f"{plan.nsplit}, vec {plan.vec}; online_softmax route "
          f"{plan.route}; device kernels per call: " + "; ".join(
              f"{n} {len(k)} ({', '.join(k)})" for n, k in kernels.items()),
          flush=True)
    want = {"softmax_stats": ["unit_stats_kernel"],
            "fused_xent": ["unit_xent_kernel"]}
    if softmax:
        want["online_softmax"] = (
            ["unit_one_pass_kernel"] if plan.route == osm.ONE_PASS
            else ["unit_stats_kernel", "normalize_kernel"])
    check({n: sorted(k) for n, k in kernels.items()}
          == {n: sorted(k) for n, k in want.items()},
          f"softmax unit {tag}: device kernels {kernels}, want {want}")
    return dict(route=plan.route, chunk=plan.chunk, nsplit=plan.nsplit,
                vec=plan.vec, device_kernels_per_call={
                    n: len(k) for n, k in kernels.items()})


def check_softmax_units(torch, timer):
    """The softmax unit's kernels on (B, V = 151936) rows: B 12 in f32
    (the unit path's logits), B 512 in bf16 and B 4,096 in bf16 (one
    4k-token training sequence; softmax_stats and fused_xent only), each
    call's plan, route and device kernels, the stats and the
    cross-entropy against their split models too (all rows; the first 64
    at B 4,096), and two calls bitwise equal.  Yardsticks
    ``torch.logsumexp``, ``torch.softmax`` and ``F.cross_entropy``; an
    empty launch (``torch.cuda._sleep(1)``) on the same ruler is the floor
    of one launch."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ref

    v = 151936
    gen = torch.Generator(device="cuda").manual_seed(6)
    floor = timer.readings(lambda: torch.cuda._sleep(1))
    print(f"empty launch (torch.cuda._sleep(1)): {shown(floor)}; the card "
          f"holds {osm.device_resident_blocks(0, torch.float32)} one-pass "
          f"blocks (f32), {osm.device_resident_blocks(0, torch.bfloat16)} "
          f"(bf16) at once", flush=True)
    rows = {"floor": floor}
    for b, dtype in ((12, torch.float32), (512, torch.bfloat16),
                     (4096, torch.bfloat16)):
        softmax = b < 4096
        x = (torch.randn((b, v), generator=gen, device="cuda") * 4).to(dtype)
        lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
        m, l = osm.softmax_stats(x)
        p = osm.online_softmax(x) if softmax else None
        loss = fx.fused_xent(x, lab)
        torch.cuda.synchronize()
        tag = f"B={b} {str(dtype).replace('torch.', '')}"
        print(f"softmax unit {tag}:", flush=True)
        errs = unit_errors(torch, x, lab, m, l, p, loss)
        split_err = split_errors(torch, x, lab, m, l, loss,
                                 b if softmax else 64)
        plan = unit_route(torch, x, lab, softmax)
        check_repeatable(torch, lambda: torch.stack(osm.softmax_stats(x)),
                         f"softmax_stats {tag}")
        check_repeatable(torch, lambda: fx.fused_xent(x, lab),
                         f"fused_xent {tag}")
        if softmax:
            check_repeatable(torch, lambda: osm.online_softmax(x),
                             f"online_softmax {tag} ({plan['route']})")
        del p
        el, n = x.element_size(), b * v
        cases = [
            ("softmax_stats", lambda: osm.softmax_stats(x),
             lambda: ref.softmax_stats(x),
             lambda: torch.logsumexp(x, dim=-1), n * el + 8 * b, 4 * n),
            ("fused_xent", lambda: fx.fused_xent(x, lab),
             lambda: ref.fused_xent(x, lab),
             lambda: F.cross_entropy(x, lab, reduction="none"),
             n * el + 12 * b, 4 * n)]
        if softmax:
            cases.append((
                "online_softmax", lambda: osm.online_softmax(x),
                lambda: ref.online_softmax(x),
                lambda: torch.softmax(x, dim=-1, dtype=torch.float32),
                n * el + 4 * n + 8 * b, 6 * n))
        for name, kern, plain, lib, nbytes, flops in cases:
            kern_t, plain_ms = timer.readings(kern), timer(plain)
            lib_t = timer.readings(lib, "library_")
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            print(f"{name} {tag}: kernel {shown(kern_t)}, plain "
                  f"{plain_ms:.4f} ms, library {shown(lib_t, 'library_')}, "
                  f"bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes / 1e6:.3f} MB)", flush=True)
            rows[(name, b)] = dict(max_abs_err=errs[name], **kern_t,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, **lib_t, plan=plan)
            if name != "online_softmax":
                rows[(name, b)]["split_max_abs_err"] = split_err
        del x, lab, m, l, loss
        torch.cuda.empty_cache()
    return rows


def check_xent_backward_memory(torch) -> dict:
    """``ops.softmax_xent``'s backward at 4,096 rows of 151,936 bf16: the
    bytes it allocates beyond what is live before it (at most the f32
    probabilities and the bf16 gradient, 3.73 GB; the 4.0 GB limit leaves
    room for the label indices), and its gradient against autograd
    through the plain version (bf16: a step of bf16, 1e-2, as the card
    tests take it)."""
    from repro_torch.kernels import ops, ref

    b, v = 4096, 151936
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = (torch.randn((b, v), generator=gen, device="cuda") * 4).to(
        torch.bfloat16)
    lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)
    loss = ops.softmax_xent(xg, lab).mean()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss.backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    xr = x.clone().requires_grad_(True)
    ref.fused_xent(xr, lab).mean().backward()
    err = (xg.grad.float() - xr.grad.float()).abs().max().item()
    ok = torch.allclose(xg.grad.float(), xr.grad.float(), rtol=1e-2,
                        atol=UNIT_ATOL)
    print(f"softmax_xent backward B={b} bf16: {extra / 1e9:.4f} GB "
          f"allocated beyond its inputs (limit 4.0; the f32 probabilities "
          f"{4 * b * v / 1e9:.4f} + the bf16 gradient {2 * b * v / 1e9:.4f});"
          f" gradient max_abs_err {err:.6g} vs the plain one (rtol 1e-2, "
          f"atol {UNIT_ATOL}): {'ok' if ok else 'FAIL'}", flush=True)
    check(extra <= 4.0e9, f"softmax_xent backward allocated {extra} bytes")
    check(ok, "softmax_xent backward disagrees with the plain gradient")
    del x, xg, xr, loss
    torch.cuda.empty_cache()
    return {"extra_bytes": extra, "grad_max_abs_err": err}


def check_unit_invariance(torch) -> dict:
    """A row's stats and probabilities are the same bits alone (B 1,
    one-pass), in B 12 (one-pass) and in B 64 (two-launch), and its
    cross-entropy loss alone and in B 12, 64 and 4,096, f32 at V 151936:
    the split follows V alone and every route folds and merges alike."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((4096, 151936), generator=gen, device="cuda") * 4
    lab = torch.randint(0, 151936, (4096,), generator=gen, device="cuda")
    runs, routes = {}, {}
    for b in (12, 64):
        routes[b] = osm.plan_of(x[:b]).route
        runs[b] = (*osm.softmax_stats(x[:b]), osm.online_softmax(x[:b]))
    losses = {b: fx.fused_xent(x[:b], lab[:b]) for b in (12, 64, 4096)}
    routes[1] = osm.plan_of(x[:1]).route
    same = {12: 0, 64: 0}
    same_loss = dict.fromkeys(losses, 0)
    for r in range(12):
        alone = (*osm.softmax_stats(x[r:r + 1]),
                 osm.online_softmax(x[r:r + 1]))
        for b in same:
            same[b] += all(torch.equal(a, got[r:r + 1])
                           for a, got in zip(alone, runs[b]))
        loss = fx.fused_xent(x[r:r + 1], lab[r:r + 1])
        for b in same_loss:
            same_loss[b] += torch.equal(loss, losses[b][r:r + 1])
    print(f"softmax unit rows (f32, V 151936): m, l and probabilities "
          f"of B 1 ({routes[1]}) bitwise equal in B 12 ({routes[12]}) for "
          f"{same[12]}/12 rows and in B 64 ({routes[64]}) for "
          f"{same[64]}/12; fused_xent's loss of B 1 bitwise equal in "
          + ", ".join(f"B {b} for {k}/12" for b, k in same_loss.items()),
          flush=True)
    check(routes == {1: osm.ONE_PASS, 12: osm.ONE_PASS,
                     64: osm.TWO_LAUNCH},
          f"softmax unit routes {routes}: want one-pass at B 1 and 12, "
          "two-launch at B 64")
    check(same == {12: 12, 64: 12},
          "softmax unit: a row's bits depend on its batch or route")
    check(all(k == 12 for k in same_loss.values()),
          "fused_xent: a row's loss depends on its batch")
    del x, lab, runs, losses
    torch.cuda.empty_cache()
    return {"routes": {str(b): r for b, r in routes.items()},
            "rows_equal_b12": same[12], "rows_equal_b64": same[64],
            "xent_rows_equal": {str(b): k for b, k in same_loss.items()}}


def check_many_rows(torch):
    """The softmax unit's three wrappers at B 70,000 rows of V 1,000
    (f32): more rows than grid.y holds, one wrapper call each and one
    device kernel each (online_softmax two, on its two-launch route),
    against their plain versions at the unit tolerances.  Logits of scale 1: where the label is the max, m + log
    l - x[label] cancels to about one f32 ulp of m, under XENT_ATOL
    while |m| < 8."""
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm

    b, v = 70000, 1000
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((b, v), generator=gen, device="cuda")
    lab = torch.randint(0, v, (b,), generator=gen, device="cuda")
    n0 = read_launches()
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    n1 = read_launches()
    print(f"softmax unit B={b} V={v} f32:", flush=True)
    errs = unit_errors(torch, x, lab, m, l, p, loss)
    check(all(n1[k] - n0[k] == want for k, want in (
        ("softmax_stats", 2), ("online_softmax", 1), ("fused_xent", 1))),
        "the 70,000-row unit calls did not launch once each")
    route = unit_route(torch, x, lab)
    check(osm.plan_of(x).route == osm.TWO_LAUNCH,
          "70,000 rows must take the two-launch route")
    return errs, route


# ---------------------------------------------------------------------------
# Phases 4-6: the main path
# ---------------------------------------------------------------------------
def top2_gap_at(torch, llm, prompt, generated, step):
    """f32 top-2 logit gap and max for the hidden state that chose token
    ``step`` (a one-shot prefill over the prompt and the tokens before
    it)."""
    from repro_torch.models import lm

    eng = llm.engine
    toks = np.concatenate([np.asarray(prompt, np.int64),
                           np.asarray(generated[:step], np.int64)])
    t = torch.as_tensor(toks, device=eng.device)[None]
    h, _ = lm.prefill(eng.params, eng.cfg, t, len(toks))
    logits = torch.matmul(h.float(), lm.lm_head_weight(eng.params,
                                                       eng.cfg).float())
    top2 = logits[0].topk(2).values
    return (top2[0] - top2[1]).item(), top2[0].item()


def stats_now(llm) -> dict:
    """A copy of the engine's counters (``head_calls`` copied too)."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in llm.engine.stats.items()}


def stats_delta(before: dict, after: dict) -> dict:
    """The counters' growth between two ``stats_now`` copies."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {n: c - before[k].get(n, 0) for n, c in v.items()}
        elif k != "acceptance_rate":
            out[k] = v - before[k]
    if out.get("drafted"):
        out["acceptance_rate"] = out["accepted"] / out["drafted"]
    return out


def drive(torch, llm, prompts, plist):
    """One ``LLM.generate`` over ``prompts``: the launch counts are set
    to 0 just before it and read just after.  Returns (outputs, every
    streamed chunk's candidate ids by prompt, launches, stats delta,
    wall seconds)."""
    cands = {}

    def collect(chunk):
        cands.setdefault(chunk.rid, []).append(chunk.candidate_ids)

    llm.engine.add_consumer(collect)
    before = stats_now(llm)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        outs = llm.generate(prompts, plist)
        torch.cuda.synchronize()
    finally:
        llm.engine.remove_consumer(collect)
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = stats_delta(before, stats_now(llm))
    return outs, [cands[o.rid] for o in outs], launches, st, wall


def compare_streams(torch, llm, prompts, want, got, what) -> int:
    """``got`` must equal ``want`` stream by stream, or part from it only
    at a near-tie of the two best f32 logits (gap <= HEAD_RTOL * |max|),
    where the order of the trunk's bf16 sums can decide.  Returns the
    number of identical streams."""
    same = 0
    for p, o, s in zip(prompts, want, got):
        if o.token_ids == s.token_ids:
            same += 1
            continue
        k = next((i for i, (x, y) in enumerate(zip(o.token_ids,
                                                   s.token_ids)) if x != y),
                 min(len(o.token_ids), len(s.token_ids)))
        check(k < min(len(o.token_ids), len(s.token_ids)),
              f"{what}: rid {s.rid} stopped at {len(s.token_ids)} tokens "
              f"where the reference has {len(o.token_ids)}")
        gap, top = top2_gap_at(torch, llm, p, o.token_ids, k)
        print(f"{what}: rid {s.rid} diverges at step {k}: top-2 f32 logit "
              f"gap {gap:.6g} (max {top:.6g})", flush=True)
        check(gap <= HEAD_RTOL * abs(top),
              f"{what}: streams diverge at a decided step (gap {gap} > "
              f"{HEAD_RTOL}*|{top}|)")
    print(f"{what}: {same}/{len(want)} streams identical", flush=True)
    return same


def graph_line(llm) -> str:
    """The engine's graph cache: buckets seen and captured, replays,
    capture ms and the pool's reserved MB."""
    g = llm.engine.graphs
    return (f"{len(g.seen)} buckets seen, {g.captures} captures "
            f"({len(g)} buckets), {g.replays} replays, capture "
            f"{g.capture_ms:.1f} ms, pool {g.pool_bytes() / 2 ** 20:.1f} MB")


def drive_graphed(torch, llm, prompts, plist, what):
    """``drive``, graphed: returns its run plus (captures, replays, first
    steps) -- a bucket's first step runs eagerly, its second captures
    and replays -- which must add up to the run's steps."""
    g = llm.engine.graphs
    n0 = (g.captures, g.replays, len(g.seen))
    run = drive(torch, llm, prompts, plist)
    caps, reps, firsts = (b - a for a, b in zip(
        n0, (g.captures, g.replays, len(g.seen))))
    check(firsts + reps == run[3]["decode_steps"],
          f"{what}: the graphed run's steps are not its first steps + "
          "replays")
    return run + (caps, reps, firsts)


def run_counts(run) -> str:
    """A graphed run's first steps, captures and replays, as words."""
    caps, reps, firsts = run[5:8]
    return (f"ran {firsts} first steps eagerly, captured {caps} and "
            f"replayed {reps} steps of {run[3]['decode_steps']}")


def drive_both(torch, llm, prompts, plist, what, replays=True):
    """``drive`` once inside ``eager_steps()`` and once graphed, on the
    same prompts: the token streams must be EQUAL (the graph replays the
    eager step's bits).  Returns (eager run, graphed run), each as
    ``drive`` returns it, the graphed run with ``drive_graphed``'s
    counts (which must include a replay when ``replays``)."""
    from repro_torch.serve import step_graph

    with step_graph.eager_steps():
        eager = drive(torch, llm, prompts, plist)
    graphed = drive_graphed(torch, llm, prompts, plist, what)
    same = sum(a.token_ids == b.token_ids
               for a, b in zip(eager[0], graphed[0]))
    print(f"{what}: graphed vs eager, {same}/{len(prompts)} streams equal; "
          f"the graphed run {run_counts(graphed)}", flush=True)
    check(same == len(prompts),
          f"{what}: the graphed run's tokens differ from the eager run's")
    check(graphed[6] > 0 or not replays,
          f"{what}: the graphed run replayed no step")
    return eager, graphed


def drive_replays(torch, llm, prompts, plist, what, first):
    """Two more graphed runs after ``first`` (``drive_both``'s graphed
    run) on the same prompts: the second captures the buckets that the
    first ran once, the third runs no first step and captures nothing,
    so it is every bucket's replay.  Both runs' tokens must equal
    ``first``'s.  Returns (second run, third run), as ``drive_graphed``
    returns them."""
    runs = []
    for n in (2, 3):
        run = drive_graphed(torch, llm, prompts, plist, what)
        print(f"{what}: graphed run {n} {run_counts(run)}", flush=True)
        check([o.token_ids for o in run[0]]
              == [o.token_ids for o in first[0]],
              f"{what}: graphed run {n}'s tokens differ from the first's")
        runs.append(run)
    check(runs[1][5] == runs[1][7] == 0, f"{what}: graphed run 3 captured "
          f"{runs[1][5]} buckets and ran {runs[1][7]} first steps")
    return tuple(runs)


def check_main_launches(launches, st, cfg, n_prompts, run):
    """Phase 4's launch checks on one run's counts."""
    from repro_torch.kernels import paged_attention as pa

    want_pa = cfg.n_layers * st["decode_steps"]
    want_fa = cfg.n_layers * st["prefills"]
    want_head = st["decode_steps"] + st["prefills"]
    print(f"main path launches ({run}): paged_attention "
          f"{launches['paged_attention']} (want {cfg.n_layers} x "
          f"{st['decode_steps']} = {want_pa}), flash_attention "
          f"{launches['flash_attention']} (want {cfg.n_layers} x "
          f"{st['prefills']} = {want_fa}), fused_argmax_head "
          f"{launches['fused_argmax_head']} (want {st['decode_steps']} + "
          f"{st['prefills']} = {want_head})", flush=True)
    check(launches["paged_attention"] == want_pa,
          f"{run}: paged attention launches != layers x decode steps")
    check(pa.paged_attention.launches_by_mode["exact"] == want_pa,
          f"{run}: the greedy path launched paged attention in a non-exact "
          "mode")
    check(launches["flash_attention"] == want_fa,
          f"{run}: flash attention launches != layers x prefills")
    check(launches["fused_argmax_head"] == want_head,
          f"{run}: head launches != decode steps + prefills")
    check(launches["fused_topk_head"] == launches["fused_verify_head"] == 0,
          f"{run}: a greedy run launched a top-k or verify kernel")
    check(all(launches[n] == 0 for n in ("softmax_stats", "online_softmax",
                                         "fused_xent")),
          f"{run}: a greedy run launched a softmax-unit kernel")
    check(st["decode_steps"] > 0 and st["prefills"] >= n_prompts,
          f"{run}: the main path ran no decode step or missed a prefill")


def main_line(what, outs, st, wall) -> dict:
    """Print and return one greedy run's end-to-end numbers."""
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = st["prefill_ms"] / st["prefills"]
    print(f"{what}: {n_tok} tokens generated in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tok/s; {st['decode_steps']} decode steps, "
          f"mean {st['decode_ms'] / st['decode_steps']:.3f} ms/step; "
          f"{st['prefills']} prefills, mean {prefill_ms:.3f} ms, "
          f"{st['prefill_ms']:.1f} ms in all", flush=True)
    return dict(tok_s=n_tok / wall, tokens=n_tok,
                decode_steps=st["decode_steps"], prefills=st["prefills"],
                decode_ms=st["decode_ms"] / st["decode_steps"],
                prefill_ms=prefill_ms, wall_s=wall)


def run_main_path(torch, prompts, max_new):
    """Phase 4: greedy, once inside ``eager_steps()``, then graphed twice
    on the same prompts (the first run captures its buckets, the second
    replays them all); the three runs' streams must be equal and each
    run's launches hold at layers x steps and steps + prefills."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    t0 = time.perf_counter()
    llm = LLM.from_arch("qwen3-0.6b", smoke=False, seed=0, n_slots=8,
                        max_len=1024)
    torch.cuda.synchronize()
    cfg = llm.cfg
    print(f"main path: qwen3-0.6b {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, "
          f"V={cfg.vocab_size}, {cfg.dtype}; weights "
          f"{sum(t.numel() * t.element_size() for t in _leaves(llm.engine.params)) / 1e9:.3f} GB, "
          f"KV pool {sum(p.numel() * p.element_size() for p in llm.engine.store.pools.values()) / 1e9:.3f} GB; "
          f"built in {time.perf_counter() - t0:.1f} s; {len(prompts)} "
          f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens", flush=True)
    params = SamplingParams(max_new_tokens=max_new)
    llm.generate([prompts[0][:16]], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)

    eager, graphed = drive_both(torch, llm, prompts, params, "main path")
    outs, _, launches, st, wall, caps, reps, firsts = graphed
    summary = {"eager": main_line("main path, eager", *(
        eager[i] for i in (0, 3, 4)))}
    check_main_launches(eager[2], eager[3], cfg, len(prompts), "eager")
    summary["graph_first_run"] = main_line("main path, graphed run 1",
                                           outs, st, wall)
    check_main_launches(launches, st, cfg, len(prompts), "graphed")
    print(f"main path graphs after graphed run 1: {graph_line(llm)}",
          flush=True)
    second, again = drive_replays(torch, llm, prompts, params, "main path",
                                  graphed)
    summary["graph_second_run"] = main_line(
        "main path, graphed run 2", second[0], second[3], second[4])
    check_main_launches(second[2], second[3], cfg, len(prompts),
                        "graphed run 2")
    summary["graph"] = main_line("main path, graphed run 3 (replays only)",
                                 again[0], again[3], again[4])
    check_main_launches(again[2], again[3], cfg, len(prompts),
                        "graphed run 3")
    print(f"main path graphs after graphed run 3: {graph_line(llm)}",
          flush=True)
    summary["graph_first_run"].update(captures=caps, replays=reps,
                                      first_steps=firsts)
    summary["graph_second_run"].update(captures=second[5],
                                       replays=second[6])
    summary["graph"].update(captures=again[5], replays=again[6])
    for o in outs:
        check(1 <= len(o.token_ids) <= max_new
              and o.finish_reason in ("length", "eos")
              and all(0 <= x < cfg.vocab_size for x in o.token_ids),
              f"bad output for rid {o.rid}: {o.finish_reason} "
              f"{o.token_ids}")
    return llm, outs, launches, summary


def run_sampled_path(torch, llm, prompts, greedy_outs, max_new):
    """Phase 4b: the same 12 prompts as a mixed sampled workload -- 4
    greedy, 4 top-k (k 8, temperature 0.8, seeded), 2 greedy with 4
    candidate ids (the top-k bus at sample_k 1), 2 Gumbel-max
    temperature -- through one engine, every kind sharing fused steps."""
    from repro_torch.serve.params import SamplingParams

    kinds = ["greedy", "topk", "greedy", "topk", "cands", "temp"] * 2
    plist = [SamplingParams(max_new_tokens=max_new) if kind == "greedy" else
             SamplingParams(max_new_tokens=max_new, top_k=8,
                            temperature=0.8, seed=r) if kind == "topk" else
             SamplingParams(max_new_tokens=max_new, n_candidates=4)
             if kind == "cands" else
             SamplingParams(max_new_tokens=max_new, head_mode="temperature",
                            seed=r)
             for r, kind in enumerate(kinds)]
    eager, graphed = drive_both(torch, llm, prompts, plist, "sampled path")
    for run, (outs, cands, launches, st, wall, *_) in (("eager", eager),
                                                       ("graphed", graphed)):
        calls = st["head_calls"]
        n_tok = sum(len(o.token_ids) for o in outs)
        print(f"sampled path ({run}): {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s; {st['decode_steps']} decode "
              f"steps, mean {st['decode_ms'] / st['decode_steps']:.3f} "
              f"ms/step; head calls {calls}; launches {launches}",
              flush=True)
        want_pa = llm.cfg.n_layers * st["decode_steps"]
        check(launches["paged_attention"] == want_pa,
              f"sampled path ({run}): paged attention launches != layers x "
              "steps")
        check(launches["fused_topk_head"] == calls.get("TopK", 0) > 0,
              f"sampled path ({run}): top-k launches != top-k head calls "
              "(decode steps and prefills holding a top-k row)")
        check(launches["fused_argmax_head"] == calls.get("Greedy", 0) > 0,
              f"sampled path ({run}): argmax launches != greedy head calls")
        check(launches["fused_verify_head"] == 0,
              f"sampled path ({run}): a verify kernel ran without "
              "speculation")
        check(launches["flash_attention"]
              == llm.cfg.n_layers * st["prefills"],
              f"sampled path ({run}): flash attention launches != layers x "
              "prefills")
        for o, c, kind in zip(outs, cands, kinds):
            check(1 <= len(o.token_ids) <= max_new
                  and all(0 <= x < llm.cfg.vocab_size for x in o.token_ids),
                  f"sampled path: bad output for rid {o.rid}: "
                  f"{o.token_ids}")
            if kind == "cands":
                check(all(x is not None and len(x) == 4 and x[0] == t
                          and len(set(x)) == 4
                          for x, t in zip(c, o.token_ids)),
                      f"sampled path: bad candidate ids for rid {o.rid}")
            else:
                check(all(x is None for x in c),
                      f"sampled path: rid {o.rid} got candidate ids")
    greedy = [r for r, kind in enumerate(kinds) if kind == "greedy"]
    compare_streams(torch, llm, [prompts[r] for r in greedy],
                    [greedy_outs[r] for r in greedy],
                    [outs[r] for r in greedy],
                    "sampled path, greedy rows vs the greedy-only run")
    eager_st = eager[3]
    return launches, dict(tok_s=n_tok / wall, tokens=n_tok,
                          decode_steps=st["decode_steps"],
                          decode_ms=st["decode_ms"] / st["decode_steps"],
                          eager_decode_ms=eager_st["decode_ms"]
                          / eager_st["decode_steps"],
                          eager_tok_s=sum(len(o.token_ids) for o in eager[0])
                          / eager[4], captures=graphed[5],
                          first_steps=graphed[7],
                          head_calls=calls)


class ReplayDrafter:
    """Drafts the continuation of a known stream (prompt + its spec_k=0
    tokens) wherever the history follows it, so every step drafts its
    whole window; records the widest proposal."""

    def __init__(self, stream):
        self.stream, self.widest = list(stream), 0

    def propose(self, history, k):
        n = len(history)
        out = (self.stream[n:n + k] if list(history) == self.stream[:n]
               else [])
        self.widest = max(self.widest, len(out))
        return out


def run_spec_path(torch, llm, lengths, max_new):
    """Phase 4c: 12 repetitive prompts (a random 32-token phrase repeated
    to each of the main path's lengths), greedy, at spec_k = 0 and then
    spec_k = 4; then one request at spec_k = 20 whose drafter replays the
    spec_k = 0 stream, so its 21-token windows make T = 32 and so 64
    query rows per KV head in paged attention."""
    from repro_torch.serve.params import SamplingParams

    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, llm.cfg.vocab_size, size=32),
                       n // 32 + 1)[:n].astype(np.int32) for n in lengths]
    beager, based = drive_both(torch, llm, prompts,
                               SamplingParams(max_new_tokens=max_new),
                               "spec path, spec_k=0")
    base = based[0]
    sp4 = SamplingParams(max_new_tokens=max_new, spec_k=4)
    seager, sgraph = drive_both(torch, llm, prompts, sp4,
                                "spec path, spec_k=4")
    _, sagain = drive_replays(torch, llm, prompts, sp4,
                              "spec path, spec_k=4", sgraph)
    n_base = sum(len(o.token_ids) for o in base)
    for run, spec0, spec4 in (("eager", beager, seager),
                              ("graphed run 1", based, sgraph),
                              ("graphed run 3, replays only", based,
                               sagain)):
        outs, _, launches, st, wall = spec4[:5]
        bst, bwall = spec0[3], spec0[4]
        calls = st["head_calls"]
        n_tok = sum(len(o.token_ids) for o in outs)
        print(f"spec path ({run}): spec_k=0 {n_base} tokens in {bwall:.3f} "
              f"s = {n_base / bwall:.2f} tok/s, {bst['decode_steps']} decode "
              f"steps at {bst['decode_ms'] / bst['decode_steps']:.3f} ms; "
              f"spec_k=4 {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s, {st['decode_steps']} decode steps "
              f"at {st['decode_ms'] / st['decode_steps']:.3f} ms, drafted "
              f"{st['drafted']}, accepted {st['accepted']}, acceptance_rate "
              f"{st.get('acceptance_rate', 0.0):.4f}; head calls {calls}; "
              f"launches {launches}", flush=True)
        check(st["drafted"] > 0, f"spec path ({run}): nothing was drafted")
        check(launches["fused_verify_head"] == calls.get("verify", 0) > 0,
              f"spec path ({run}): verify launches != decode steps with a "
              "draft row")
        check(launches["fused_argmax_head"] == calls.get("Greedy", 0),
              f"spec path ({run}): argmax launches != greedy head calls")
        check(launches["paged_attention"] == llm.cfg.n_layers
              * st["decode_steps"], f"spec path ({run}): paged attention "
              "launches != layers x decode steps")
        check(launches["flash_attention"]
              == llm.cfg.n_layers * st["prefills"],
              f"spec path ({run}): flash attention launches != layers x "
              "prefills")
    ms = {run: r[3]["decode_ms"] / r[3]["decode_steps"]
          for run, r in (("eager", seager), ("first", sgraph),
                         ("replays", sagain))}
    print(f"spec path, spec_k=4 ms/step: graphed replays only "
          f"{ms['replays']:.3f}, graphed run 1 {ms['first']:.3f}, eager "
          f"{ms['eager']:.3f}", flush=True)
    check(ms["replays"] < ms["eager"], "spec path: the graphed spec_k=4 "
          "step (replays only) is not faster than the eager one")
    same = compare_streams(torch, llm, prompts, base, outs,
                           "spec path, spec_k=4 vs spec_k=0")

    drafter = llm.engine.drafter
    llm.engine.drafter = ReplayDrafter(
        [int(t) for t in prompts[0]] + list(base[0].token_ids))
    try:
        _, wide_run = drive_both(
            torch, llm, prompts[:1], SamplingParams(max_new_tokens=max_new,
                                                    spec_k=20),
            "spec path, spec_k=20", replays=False)
        wide, _, wl, wst = wide_run[:4]
        widest = llm.engine.drafter.widest
    finally:
        llm.engine.drafter = drafter
    print(f"spec path: spec_k=20, widest draft {widest} (T = 32 from 16), "
          f"drafted {wst['drafted']}, accepted {wst['accepted']}, verify "
          f"launches {wl['fused_verify_head']}", flush=True)
    check(widest >= 16, "spec path: the spec_k=20 request never drafted "
          "16 tokens, so no step had T * g > 32")
    check(wl["fused_verify_head"] == wst["head_calls"].get("verify", 0) > 0,
          "spec path: spec_k=20 verify launches != its draft steps")
    compare_streams(torch, llm, prompts[:1], base[:1], wide,
                    "spec path, spec_k=20 vs spec_k=0")
    outs, _, launches, st, wall = sgraph[:5]
    bst, bwall = based[3], based[4]
    n_tok = sum(len(o.token_ids) for o in outs)
    return launches, dict(
        tok_s=n_tok / wall, tok_s_spec0=n_base / bwall, tokens=n_tok,
        decode_steps=st["decode_steps"],
        decode_steps_spec0=bst["decode_steps"],
        decode_ms=ms["first"], decode_ms_spec0=bst["decode_ms"]
        / bst["decode_steps"], decode_ms_replays=ms["replays"],
        tok_s_replays=n_tok / sagain[4], captures=sgraph[5],
        first_steps=sgraph[7], drafted=st["drafted"],
        accepted=st["accepted"],
        acceptance_rate=st["accepted"] / st["drafted"],
        eager_decode_ms=ms["eager"], identical_streams=same,
        widest_draft_spec20=widest)


def profile_decode(torch, llm, prompts, graphed, steps=5):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    engine iterations of 8 rows in pure decode (every request admitted
    beforehand, and one more step run first, so a graphed window only
    replays), eager (inside ``eager_steps()``) or graphed.  Prints the
    host wall clock per step (profiler on), the device time its kernels
    took, their count, and the kernels that took the most."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_argmax_head as fah
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams

    run = "graphed" if graphed else "eager"
    eng = llm.engine
    mode = contextlib.nullcontext() if graphed else step_graph.eager_steps()
    with mode:
        for p in prompts[:8]:
            llm.submit(p, SamplingParams(max_new_tokens=steps + 6))
        eng.step()                      # admit all 8, first decode step
        eng.step()                      # a graphed bucket's capture
        torch.cuda.synchronize()
        n_flash = fa.flash_attention.launches
        n_graph = (eng.graphs.captures, eng.graphs.replays)
        counted = (pa.paged_attention.launches,
                   fah.fused_argmax_head_with_value.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        check(fa.flash_attention.launches == n_flash,
              "a pure decode step launched the flash-attention kernel")
        counted = (pa.paged_attention.launches - counted[0],
                   fah.fused_argmax_head_with_value.launches - counted[1])
        replays = eng.graphs.replays - n_graph[1]
        check(eng.graphs.captures == n_graph[0]
              and replays == (steps if graphed else 0),
              f"decode profile ({run}): {replays} replays in {steps} steps")
        while eng.has_work:
            eng.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    busy_ms = sum(by_name.values()) / 1e3 / steps
    if not kernels:
        print(f"decode profile ({run}, 8 rows, {steps} steps, profiler on): "
              f"wall {wall_ms:.3f} ms/step; the profiler recorded no device "
              "time (device busy not measured)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, kernels_per_step=None)
    print(f"decode profile ({run}, 8 rows, {steps} steps, profiler on): wall "
          f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels) / steps:.0f} kernels/step", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  "
              f"{count[name] / steps:5.0f}/step  {name[:80]}", flush=True)
    # paged attention's kernel and its split's combine kernel
    paged = [e for e in kernels if "paged_" in e.name]
    paged_ms = sum(e.time_range.elapsed_us() for e in paged) / 1e3 / steps
    print(f"  paged attention (kernel + combine): {paged_ms:.3f} ms/step in "
          f"{len(paged) / steps:.0f} launches/step", flush=True)
    # the argmax head's two passes
    head = [e for e in kernels if any(n in e.name for n in (
        "argmax_wgmma_partial_kernel", "argmax_partial_kernel",
        "argmax_reduce_kernel"))]
    head_ms = sum(e.time_range.elapsed_us() for e in head) / 1e3 / steps
    print(f"  argmax head (pass 1 + pass 2): {head_ms:.3f} ms/step in "
          f"{len(head) / steps:.0f} launches/step", flush=True)
    # the trace backs the counters (a replay's are its capture's delta):
    # an exact-mode paged call is a fold and a combine, a head call two
    # passes
    print(f"  counted launches in the window: paged_attention "
          f"{counted[0]}, fused_argmax_head {counted[1]}; traced kernels "
          f"{len(paged)} and {len(head)}", flush=True)
    check(len(paged) == 2 * counted[0] == 2 * llm.cfg.n_layers * steps,
          f"decode profile ({run}): {len(paged)} traced paged-attention "
          f"kernels for {counted[0]} counted launches in {steps} steps")
    check(len(head) == 2 * counted[1] == 2 * steps,
          f"decode profile ({run}): {len(head)} traced argmax-head kernels "
          f"for {counted[1]} counted launches in {steps} steps")
    # the RMSNorm's f64 mean (its reduction kernel reads double)
    norm = [e for e in kernels if "reduce_kernel" in e.name
            and "double" in e.name]
    norm_ms = sum(e.time_range.elapsed_us() for e in norm) / 1e3 / steps
    print(f"  f64 reductions (the RMSNorm mean): {norm_ms:.3f} ms/step in "
          f"{len(norm) / steps:.0f} launches/step", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms,
                kernels_per_step=len(kernels) / steps, paged_ms=paged_ms,
                paged_kernels_per_step=len(paged) / steps,
                argmax_head_ms=head_ms,
                argmax_head_kernels_per_step=len(head) / steps,
                f64_reduce_ms=norm_ms,
                f64_reduce_kernels_per_step=len(norm) / steps)


class FixedDrafter:
    """Proposes ``k`` copies of one token, so every step of a spec_k
    request drafts its whole window."""

    def propose(self, history, k):
        return [7] * k


def step_leaves(out) -> list:
    """A step body's (h, outputs) as a flat list of host copies."""
    h, outs = out
    flat = [h]
    for o in outs:
        flat += list(o) if isinstance(o, tuple) else [o]
    return [x.cpu().clone() for x in flat]


def step_bound(torch, eng, plan):
    """The least time one fused step could take on the card: every
    weight read once, each row's K/V history read once (its positions up
    to the step's last query, every layer), at 2 flops per weight and
    row plus 4 * hd per (query, key, head) -- bound(), bf16 peak."""
    cfg = eng.cfg
    b, t = plan.arrays[0].shape
    pos = plan.arrays[1].reshape(b, -1)[:, -1].astype(np.int64) + 1
    w_bytes = sum(x.numel() * x.element_size() for x in _leaves(eng.params))
    n_w = sum(x.numel() for x in _leaves(eng.params))
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2 * int(pos.sum())
    flops = 2 * n_w * b * t + 4 * cfg.head_dim * cfg.n_heads \
        * cfg.n_layers * t * int(pos.sum())
    return bound(w_bytes + kv, flops, BF16_FLOPS_PER_S)


def check_step_graph(torch, llm, prompts) -> dict:
    """Phase 4f: the step as one program.  In three buckets at full width
    -- greedy B 8 T 1; Greedy + TopK + Temperature groups at B 8; every
    row in the verify group at T 8 -- 8 requests are admitted (with one
    eager step), the engine's next step is planned, and its body runs
    eagerly and as a replay of its bucket's graph on the same operands:
    the hidden states and every head output must be equal bit for bit.
    The greedy bucket's replay and its eager body are timed on the same
    operands (call, device and host ms), beside the step's bound; the
    Temperature head's memory and device ms beside the f32 copy of W it
    replaced (the parent's head, ``h.float() @ W.float()``)."""
    import functools

    from repro_torch.models import lm
    from repro_torch.serve import step_graph
    from repro_torch.serve.params import SamplingParams as SP
    from repro_torch.serve.sampler import Temperature

    eng = llm.engine
    mixed = [SP(max_new_tokens=4),
             SP(max_new_tokens=4, top_k=8, temperature=0.8, seed=1),
             SP(max_new_tokens=4, head_mode="temperature", seed=2)]
    cases = {"greedy B8 T1": [SP(max_new_tokens=4)] * 8,
             "mixed B8 T1": (mixed * 3)[:8],
             "verify B8 T8": [SP(max_new_tokens=16, spec_k=7)] * 8}
    timer = Timer(torch)
    out, drafter = {"cases": {}}, eng.drafter
    try:
        for name, plist in cases.items():
            eng.drafter = FixedDrafter() if "verify" in name else drafter
            reqs = [llm.submit(p[:256], sp) for p, sp in zip(prompts, plist)]
            with step_graph.eager_steps():
                eng.step()            # admit all 8, one eager step
            active = [i for i, sl in enumerate(eng.slots) if sl is not None]
            check(len(active) == 8, f"step graph {name}: {len(active)} "
                  "active rows after admission, want 8")
            plan = eng._plan_step(active)
            body = functools.partial(eng._step_body, tuple(plan.order))
            operands = step_graph.to_device(plan.arrays, eng.device)
            want = step_leaves(body(*operands))
            if plan.key not in eng.graphs.graphs:
                eng.graphs.capture(plan.key, body, plan.arrays, eng.device)
            got = step_leaves(eng.graphs.replay(plan.key, plan.arrays))
            err = max((g.double() - w.double()).abs().max().item()
                      for g, w in zip(got, want))
            equal = len(got) == len(want) and all(
                g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, want))
            print(f"step graph {name}: bucket {plan.key[:3]} samplers "
                  f"{[type(x).__name__ for x in plan.key[3]]} groups "
                  f"{plan.key[4]} verify {plan.key[5]}: hidden states and "
                  f"{len(got) - 1} head outputs replayed vs eager: "
                  f"{'bitwise equal' if equal else 'DIFFER'} (max abs "
                  f"{err:.3g})", flush=True)
            check(equal, f"step graph {name}: the replay's bits differ from "
                  "the eager step's")
            row = dict(bucket=list(plan.key[:3]), groups=list(plan.key[4]),
                       verify=plan.key[5], bitwise_equal=equal,
                       max_abs_err=err)
            if name == "greedy B8 T1":
                row.update(timer.readings(
                    lambda: eng.graphs.replay(plan.key, plan.arrays)))
                plain = timer.readings(lambda: body(*operands), "plain_")
                row.update(plain)
                row["bound_ms"], row["bound_by"] = step_bound(torch, eng,
                                                              plan)
                print(f"step graph {name}: replay {shown(row)}; eager body "
                      f"{shown(row, 'plain_')}; bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']})", flush=True)
            out["cases"][name] = row
            for r in reqs:
                eng.cancel(r)
    finally:
        eng.drafter = drafter

    gen = torch.Generator(device=eng.device).manual_seed(21)
    h = torch.randn(8, eng.cfg.d_model, generator=gen,
                    device=eng.device).to(torch.bfloat16)
    w = lm.lm_head_weight(eng.params, eng.cfg)
    heads = {"Temperature head": lambda: Temperature().head(eng.params,
                                                            eng.cfg, h),
             "f32 copy of W (the parent's head)":
                 lambda: torch.matmul(h.float(), w.float())}
    mem = {}
    for what, fn in heads.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = fn()
        torch.cuda.synchronize()
        mem[what] = dict(mb=(torch.cuda.max_memory_allocated() - base)
                         / 2 ** 20, **timer.readings(fn), logits=logits)
    new, old = mem.values()
    err = (new["logits"] - old["logits"]).abs().max().item()
    print(f"temperature head at B 8, D {eng.cfg.d_model}, V "
          f"{eng.cfg.vocab_size}: {new['mb']:.2f} MB allocated beyond its "
          f"inputs (limit 64), {shown(new)}; the f32 copy of W: "
          f"{old['mb']:.2f} MB, {shown(old)}; max abs difference "
          f"{err:.3g} (max |logit| {old['logits'].abs().max().item():.4g})",
          flush=True)
    check(new["mb"] <= 64, f"the Temperature head allocated {new['mb']:.1f} "
          "MB: more than 64")
    out["temperature_head"] = {k: {n: v for n, v in m.items()
                                   if n != "logits"}
                               for k, m in (("change", new),
                                            ("f32_copy", old))}
    out["temperature_head"]["max_abs_err"] = err
    print(f"step graph: {graph_line(llm)}", flush=True)
    del timer
    return out


def run_unit_path(torch, llm, prompts, outs):
    """Phase 4d: the full softmax unit on the main path's logits.  The
    final hidden states of the 12 prompts (one-shot prefills, not
    counted) times the head weight in f32 give (12, 151936) logits; then
    ``ops.softmax_stats``, ``ops.online_softmax`` and ``ops.softmax_xent``
    forward and backward run on them with the launch counts set to 0,
    labels = phase 4's first tokens.  The backward's softmax is a second
    ``online_softmax`` call; each one that takes the two-launch route
    runs ``softmax_stats``' kernel as its first launch."""
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm

    eng = llm.engine
    h = torch.cat([lm.prefill(eng.params, eng.cfg, torch.as_tensor(
        p, device=eng.device).long()[None], len(p))[0] for p in prompts])
    logits = torch.matmul(h.float(), lm.lm_head_weight(
        eng.params, eng.cfg).float())
    labels = torch.tensor([o.token_ids[0] for o in outs], device=eng.device)
    x = logits.clone().requires_grad_(True)
    torch.cuda.synchronize()
    reset_launches()
    m, l = ops.softmax_stats(logits)
    p = ops.online_softmax(logits)
    loss = ops.softmax_xent(x, labels)
    loss.mean().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(osm.online_softmax.launches_by_route)
    route = osm.plan_of(logits).route
    calls = {"softmax_stats": 1 + routes[osm.TWO_LAUNCH],
             "online_softmax": 1 + 1, "fused_xent": 1}
    print(f"unit path: logits {tuple(logits.shape)} f32; launches "
          f"{launches}; online_softmax by route {routes}; want {calls} "
          f"(online_softmax: 1 call + the backward's, both {route}; "
          f"softmax_stats: 1 call + each two-launch online_softmax's)",
          flush=True)
    check(routes[route] == sum(routes.values()) == 2,
          f"unit path: online_softmax's routes {routes}, want 2 x {route}")
    check(all(launches[n] == c for n, c in calls.items()),
          "unit path: a softmax-unit kernel's launches != its calls")
    check(all(c == 0 for n, c in launches.items() if n not in calls),
          "unit path: launched a kernel outside the softmax unit")
    errs = unit_errors(torch, logits, labels, m, l, p, loss.detach())
    xr = logits.clone().requires_grad_(True)
    ref.fused_xent(xr, labels).mean().backward()
    gerr = (x.grad - xr.grad).abs().max().item()
    ok = torch.allclose(x.grad, xr.grad, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    print(f"  softmax_xent backward: max_abs_err {gerr:.6g} vs autograd "
          f"through the plain version (rtol {UNIT_RTOL}, atol {UNIT_ATOL}):"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "softmax_xent backward disagrees with the plain gradient")

    # Theorem 1 through the full unit: argmax of the probabilities is
    # the comparator head's token, except at a near-tie of the top 2
    top2 = logits.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > HEAD_RTOL * top2[:, 0].abs()
    same = torch.argmax(p, dim=-1) == labels
    print(f"unit path: argmax(online_softmax) == phase 4's first token for "
          f"{int(same.sum())}/{len(prompts)} prompts ({int(decided.sum())} "
          f"decided by more than {HEAD_RTOL}*|max|)", flush=True)
    check(bool((same | ~decided).all()),
          "unit path: argmax(online_softmax) != the reduced head's token at "
          "a decided row")
    check(bool(torch.equal(m, top2[:, 0])),
          "unit path: the stats' max is not the row max")
    return launches, errs


def run_probe_path(torch, llm, prompts, max_new):
    """Phase 4e: ``repro_torch.probe.run_probe`` at full width over the
    12 prompts, ``max_new`` tokens: all five score modes at window None,
    then pseudo and maxonly at window 128, on the main path's weights and
    engine settings.  The launch counts are set to 0 before each probe
    and read after it; the report lists each engine run the probe made
    (one per arm, the exact baseline and the score run both in exact),
    so that every mode's paged-attention launches can be held to 28 x
    the decode steps of its runs and the flash launches to 28 x their
    prefills."""
    from repro_torch import probe
    from repro_torch.kernels import paged_attention as pa

    n_layers, out = llm.cfg.n_layers, {}
    for window, variants in ((None, ("base2", "pseudo", "pwl", "maxonly")),
                             (128, ("pseudo", "maxonly"))):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep = probe.run_probe(llm.engine.params, llm.cfg, prompts,
                              variants=variants, window=window,
                              max_new_tokens=max_new, n_slots=8,
                              max_len=1024)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        by_mode = dict(pa.paged_attention.launches_by_mode)
        runs = [(r["attn_approx"], r["decode_steps"], r["prefills"])
                for r in rep["runs"]]
        steps = {m: sum(s for mode, s, _ in runs if mode == m)
                 for m in by_mode}
        prefills = sum(p for _, _, p in runs)
        print(f"probe window={window}: {len(runs)} engine runs in "
              f"{wall:.3f} s (arms + the score run) {runs}; paged launches "
              f"by mode {by_mode}, want {n_layers} x decode steps "
              f"{steps}; flash {launches['flash_attention']}, want "
              f"{n_layers} x {prefills} prefills", flush=True)
        check(len(runs) == len(variants) + 2,
              f"probe window={window}: {len(runs)} engine runs, want "
              f"{len(variants) + 2}")
        for mode in ("exact",) + variants:
            check(steps[mode] > 0 and by_mode[mode] == n_layers * steps[mode],
                  f"probe window={window}: {mode} paged launches "
                  f"{by_mode[mode]} != {n_layers} x {steps[mode]} steps")
        check(sum(by_mode.values()) == launches["paged_attention"],
              "probe: launches by mode do not add up to the launches")
        check(all(p >= len(prompts) for _, _, p in runs)
              and launches["flash_attention"] == n_layers * prefills,
              f"probe window={window}: flash launches != {n_layers} x "
              "prefills, or an arm missed a prompt")
        ex = rep["variants"]["exact"]
        check(ex["divergence"] == 0.0 and ex["first_divergence"]
              == [None] * len(prompts), "probe: the exact arm diverged")
        for v in variants:
            row = rep["variants"][v]
            errs = list(row["score_error"].values())
            check(len(errs) == n_layers
                  and all(math.isfinite(e) and 0.0 <= e <= 1.0
                          for e in errs),
                  f"probe window={window}: {v} score errors not finite in "
                  f"[0, 1]: {errs}")
            worst = max(range(n_layers), key=lambda i: errs[i])
            mfd = row["mean_first_divergence"]
            print(f"probe window={window} {v}: divergence "
                  f"{row['divergence']:.4f} ({row['diverged_requests']}/"
                  f"{row['n_requests']}), mean first divergence "
                  f"{'none' if mfd is None else f'{mfd:.3f}'}, "
                  f"first divergence {row['first_divergence']}, worst "
                  f"layer {worst} score error {errs[worst]:.6g}",
                  flush=True)
        out[window] = dict(report=rep, launches_by_mode=by_mode,
                           decode_steps=steps, wall_s=wall)
    return out


def check_theorem1(torch, llm, prompts, outs, max_new):
    """The softmax baseline (f32 logits, softmax, argmax) over the same
    weights must give the same streams; a divergence is allowed only at
    a near-tie of the top-2 f32 logits."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    base = LLM(llm.engine.params, llm.cfg, head_mode="softmax", n_slots=8,
               max_len=1024, seed=0)
    t0 = time.perf_counter()
    souts = base.generate(prompts, SamplingParams(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = base.engine.stats
    n_tok = sum(len(o.token_ids) for o in souts)
    print(f"softmax baseline head: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tok/s; mean "
          f"{st['decode_ms'] / st['decode_steps']:.3f} ms/decode step "
          f"(first run of this engine, no warm-up); graphs: "
          f"{graph_line(base)}", flush=True)
    check(base.engine.graphs.replays > 0,
          "theorem 1: the softmax-baseline engine replayed no graph")
    compare_streams(torch, llm, prompts, outs, souts,
                    "theorem 1, the reduced head vs the softmax baseline")
    del base


def check_small_reference(torch):
    """The smoke config (f32) on the card against the plain versions on
    the CPU, from one set of weights: the same tokens, or a divergence
    only at a near-tie."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import init_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = _tree_to(cpu, "cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 33)]
    sp = SamplingParams(max_new_tokens=12)
    n0 = pa.paged_attention.launches
    a = LLM(cpu, cfg, n_slots=2, max_len=96).generate(prompts, sp)
    card = LLM(gpu, cfg, n_slots=2, max_len=96)
    b = card.generate(prompts, sp)
    check(pa.paged_attention.launches > n0, "smoke run launched no kernel")
    check(card.engine.graphs.replays > 0,
          "small reference: the card's engine replayed no graph")
    for x, y in zip(a, b):
        if x.token_ids == y.token_ids:
            continue
        llm = LLM(cpu, cfg, n_slots=1, max_len=96)
        k = next(i for i, (u, w) in enumerate(zip(x.token_ids, y.token_ids))
                 if u != w)
        gap, top = top2_gap_at(torch, llm, x.prompt_token_ids, x.token_ids,
                               k)
        print(f"small reference: rid {x.rid} diverges at step {k}, gap "
              f"{gap:.6g}", flush=True)
        check(gap <= HEAD_RTOL * abs(top), "card and CPU tokens diverge at "
              "a decided step on the smoke config")
    print(f"small reference: smoke config (f32, hd={cfg.head_dim}) tokens on "
          f"the card (graphed: {graph_line(card)}) match the plain versions "
          f"on the CPU for {len(prompts)} prompts", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.serve import step_graph

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        print(card, flush=True)

        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(_build.KERNELS)}, nvcc {_build.nvcc_path()})",
              flush=True)

        timer = Timer(torch)
        rng = np.random.default_rng(0)
        print(clocks_line(), flush=True)
        pa_rows = check_paged_attention(torch, timer, rng)
        mode_rows = check_paged_modes(torch, timer, rng)
        pinned_rows = check_paged_modes_pinned(torch, rng)
        unpinned_rows = check_paged_modes_unpinned(
            torch, timer, np.random.default_rng(1))
        pa_routes = paged_routes(torch, rng)
        invariance = check_paged_invariance(torch, rng)
        hd192_rows = check_head_dim_192(torch, timer, rng)
        head_rows = check_argmax_head(torch, timer)
        routes = head_routes(torch)
        topk_rows = check_topk_head(torch, timer)
        topk_passes = check_topk_passes(torch)
        verify_rows = check_verify_head(torch, timer)
        head_invariance = check_head_invariance(torch)
        wide_rows = check_wide_heads(torch, timer)
        flash_rows, fa_routes = check_flash_attention(torch, timer)
        unit_rows = check_softmax_units(torch, timer)
        unit_invariance = check_unit_invariance(torch)
        many_errs, many_route = check_many_rows(torch)
        xent_backward = check_xent_backward_memory(torch)
        print(clocks_line(), flush=True)
        del timer

        max_new = 32
        prng = np.random.default_rng(0)
        prompts = [prng.integers(0, 151936, size=int(n)).astype(np.int32)
                   for n in prng.integers(64, 513, size=12)]
        llm, outs, launches, summary = run_main_path(torch, prompts,
                                                     max_new)
        topk_launches, summary["sampled"] = run_sampled_path(
            torch, llm, prompts, outs, max_new)
        verify_launches, summary["spec"] = run_spec_path(
            torch, llm, [len(p) for p in prompts], max_new)
        summary["profile_eager"] = profile_decode(torch, llm, prompts,
                                                  graphed=False)
        summary["profile"] = profile_decode(torch, llm, prompts,
                                            graphed=True)
        eager_ms = summary["profile_eager"]["wall_ms"]
        graph_ms = summary["profile"]["wall_ms"]
        print(f"decode step (8 rows, profiler on): graphed {graph_ms:.3f} "
              f"ms against eager {eager_ms:.3f} ms ({eager_ms / graph_ms:.2f}"
              f"x); main path decode_ms/step graphed "
              f"{summary['graph']['decode_ms']:.3f} against eager "
              f"{summary['eager']['decode_ms']:.3f}", flush=True)
        check(graph_ms < eager_ms, "the graphed decode step is not faster "
              "than the eager one")
        for k in ("paged_kernels_per_step", "argmax_head_kernels_per_step"):
            check(summary["profile"].get(k)
                  == summary["profile_eager"].get(k),
                  f"decode profile: {k} graphed != eager")
        step = check_step_graph(torch, llm, prompts)
        unit_launches, unit_errs = run_unit_path(torch, llm, prompts, outs)
        with step_graph.eager_steps():            # the probe stays eager
            probe_runs = run_probe_path(torch, llm, prompts, max_new)
        check_theorem1(torch, llm, prompts, outs, max_new)
        del llm
        check_small_reference(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:172",
             launches=launches["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in pa_rows.values()),
             **{k: pa_rows[1][k] for k in TIMES + ("chunks",)},
             single_row={k: pa_rows["B1"][k] for k in TIMES + ("chunks",)},
             t4={k: pa_rows[4][k] for k in TIMES + ("chunks",)},
             t32={k: pa_rows[32][k] for k in TIMES + ("chunks",)},
             routes=pa_routes, invariance=invariance,
             hd192={k: v for k, v in hd192_rows.items()
                    if k.startswith("paged")},
             modes={mode: dict(
                 launches=probe_runs[None]["launches_by_mode"][mode],
                 max_abs_err=max(r["max_abs_err"] for (m, _, _), r
                                 in mode_rows.items() if m == mode),
                 pinned_max_abs_err=max(
                     (r["max_abs_err"] for (m, _, _), r
                      in pinned_rows.items() if m == mode), default=None),
                 **{k: mode_rows[(mode, 1, None)][k]
                    for k in TIMES + ("passes",)},
                 t4_window128={k: mode_rows[(mode, 4, 128)][k]
                               for k in TIMES},
                 **({} if mode not in ("exact", "base2", "pwl") else dict(
                     unpinned_f32_max_abs_err=max(
                         r["max_abs_err"] for (m, _, _), r
                         in unpinned_rows.items() if m == mode),
                     f32={k: unpinned_rows[(mode, 1, None)][k]
                          for k in ("ms", "device_ms", "host_ms")})))
                 for mode in ("exact", "base2", "pseudo", "pwl",
                              "maxonly")}),
        dict(name="fused_argmax_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_argmax_head.cu",
             replaces="src/repro/kernels/fused_argmax_head.py:75",
             launches=launches["fused_argmax_head"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *head_rows.values(), wide_rows["argmax_B1"],
                 wide_rows["argmax_B8"]]),
             **{k: head_rows[8][k] for k in TIMES},
             b1={k: head_rows[1][k] for k in TIMES},
             b64={k: head_rows[64][k] for k in TIMES},
             routes={k: v for k, v in routes.items()
                     if k.startswith("argmax")},
             invariance=head_invariance,
             d18432={k: v for k, v in wide_rows.items()
                     if k.startswith("argmax")}),
        dict(name="fused_topk_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_topk_head.cu",
             replaces="src/repro/kernels/fused_topk_head.py:107",
             launches=topk_launches["fused_topk_head"],
             max_abs_err=max(r["max_abs_err"] for r in [
                 *topk_rows.values(), wide_rows["topk_B8_k8"]]),
             **{k: topk_rows[(4, 8)][k] for k in TIMES},
             k64={k: topk_rows[(4, 64)][k] for k in TIMES},
             passes=topk_passes, d18432=wide_rows["topk_B8_k8"]),
        dict(name="fused_verify_head", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_argmax_head.cu",
             replaces="src/repro/kernels/fused_topk_head.py:170",
             launches=verify_launches["fused_verify_head"],
             max_abs_err=max(r["max_abs_err"] for r in verify_rows.values()),
             **{k: verify_rows[(8, 8)][k] for k in TIMES},
             t2={k: verify_rows[(8, 2)][k] for k in TIMES},
             t32_b1={k: verify_rows[(1, 32)][k] for k in TIMES},
             t32={k: verify_rows[(8, 32)][k] for k in TIMES},
             routes={k: v for k, v in routes.items()
                     if k.startswith("verify")},
             d18432=wide_rows["verify_B8_T8"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in flash_rows.values()),
             **{k: flash_rows["T512"][k] for k in TIMES},
             g8={k: flash_rows["T512_g8"][k] for k in TIMES},
             hd192={k: v for k, v in hd192_rows.items()
                    if k.startswith("flash")},
             routes=fa_routes),
        dict(name="step_graph", route="cuda",
             source="src/repro_torch/serve/step_graph.py",
             replaces="src/repro/serve/engine.py:164",
             launches=summary["graph_first_run"]["replays"],
             max_abs_err=max(c["max_abs_err"]
                             for c in step["cases"].values()),
             **{k: step["cases"]["greedy B8 T1"][k] for k in (
                 "ms", "device_ms", "host_ms", "plain_ms",
                 "plain_device_ms", "plain_host_ms", "bound_ms",
                 "bound_by")},
             **NO_LIBRARY, cases=step["cases"],
             captures_first_run=summary["graph_first_run"]["captures"],
             temperature_head=step["temperature_head"]),
    ]
    for name, replaces in (
            ("fused_xent", "src/repro/kernels/fused_xent.py:59"),
            ("softmax_stats", "src/repro/kernels/online_softmax.py:69"),
            ("online_softmax", "src/repro/kernels/online_softmax.py:106")):
        sizes = (12, 512) if name == "online_softmax" else (12, 512, 4096)
        plans = {b: unit_rows[(name, b)]["plan"] for b in sizes}
        entry = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/online_softmax.cu",
            replaces=replaces, launches=unit_launches[name],
            max_abs_err=max(unit_errs[name], many_errs[name], *(
                unit_rows[(name, b)]["max_abs_err"] for b in sizes)),
            **{k: unit_rows[(name, 12)][k] for k in TIMES},
            b512_bf16={k: unit_rows[(name, 512)][k] for k in TIMES},
            plan=plans[12], b512_bf16_plan=plans[512],
            launch_floor=unit_rows["floor"], invariance=unit_invariance)
        if name != "online_softmax":
            entry["b4096_bf16"] = {k: unit_rows[(name, 4096)][k]
                                   for k in TIMES + ("split_max_abs_err",)}
            entry["device_kernels_per_call"] = {
                **{f"B{b}": plans[b]["device_kernels_per_call"][name]
                   for b in sizes},
                "B70000": many_route["device_kernels_per_call"][name]}
        if name == "fused_xent":
            entry["backward_b4096_bf16"] = xent_backward
        kernels.append(entry)
    summary["probe"] = {
        str(w): {v: {k: row[k] for k in ("divergence",
                                         "mean_first_divergence")}
                 | {"worst_score_error": max(row["score_error"].values())}
                 for v, row in r["report"]["variants"].items()
                 if v != "exact"}
        for w, r in probe_runs.items()}
    print("main path summary: " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
