#!/usr/bin/env python3
"""Time one checkout's decode step end to end on one NVIDIA GPU.

    python3 scripts/step_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; another commit's unpacked ``src`` to compare two
versions in one run: parent, change, change, parent).  The workloads are
``chip_smoke.py``'s, at qwen3-0.6b's full width with seeded random
weights on 8 slots:

- ``greedy``: phase 4's 12 prompts of 64-512 tokens, 32 new tokens each;
- ``spec_k=4``: phase 4c's 12 repetitive prompts, greedy with
  ``spec_k=4``;
- ``profile``: 8 rows in pure decode, 5 steps under ``torch.profiler``
  (wall ms a step with the profiler on, device-busy ms, kernels a step).

A checkout without ``repro_torch.serve.step_graph`` steps eagerly and
runs each workload twice.  One with it runs each inside
``step_graph.eager_steps()`` once, then graphed three times (a bucket's
first step runs eagerly, its second captures; the third run replays
every bucket).  Each run prints decode ms a step (``decode_ms /
decode_steps``), tok/s, prefill ms and a SHA-256 of its token streams,
so two versions' tokens can be compared.  Writes every row to
``build/step_bench_<label>.json`` (gitignored).  Exits non-zero without
CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 32


def run_row(torch, llm, prompts, params, case, mode) -> dict:
    """One ``generate`` over ``prompts``, timed; the engine's counters
    and graph cache read before and after."""
    eng = llm.engine
    g = getattr(eng, "graphs", None)
    before = dict(eng.stats)
    n0 = (g.captures, g.replays) if g is not None else (0, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = {k: eng.stats[k] - before[k] for k in (
        "decode_steps", "decode_ms", "prefills", "prefill_ms")}
    toks = [list(map(int, o.token_ids)) for o in outs]
    n_tok = sum(map(len, toks))
    row = {"case": case, "mode": mode, "tokens": n_tok,
           "wall_s": wall, "tok_s": n_tok / wall,
           "decode_steps": st["decode_steps"],
           "decode_ms_per_step": st["decode_ms"] / st["decode_steps"],
           "prefills": st["prefills"],
           "prefill_ms_each": st["prefill_ms"] / st["prefills"],
           "tokens_sha256": hashlib.sha256(
               json.dumps(toks).encode()).hexdigest()}
    if g is not None:
        row.update(captures=g.captures - n0[0], replays=g.replays - n0[1])
    return row


def profile_row(torch, llm, sp, prompts, mode, steps=5) -> dict:
    """Wall, device-busy ms and kernels a step over ``steps`` pure
    decode steps of 8 rows (two steps run first, so a graphed window
    only replays), as ``chip_smoke.profile_decode`` reads them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = llm.engine
    for p in prompts[:8]:
        llm.submit(p, sp(max_new_tokens=steps + 6))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    while eng.has_work:
        eng.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    return {"case": "profile", "mode": mode, "wall_ms_per_step": wall_ms,
            "busy_ms_per_step": busy if kernels else None,
            "busy_share": busy / wall_ms if kernels else None,
            "kernels_per_step": len(kernels) / steps if kernels else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("step_bench: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.src)]
    from repro_torch.kernels import _build
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams as SP
    try:
        from repro_torch.serve import step_graph
    except ImportError:
        step_graph = None

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{args.label}: {card}; repro_torch from {_build.__file__}",
          flush=True)
    llm = LLM.from_arch("qwen3-0.6b", smoke=False, seed=0, n_slots=8,
                        max_len=1024)
    v = llm.cfg.vocab_size
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, v, size=int(n)).astype(np.int32)
               for n in prng.integers(64, 513, size=12)]
    rng = np.random.default_rng(4)
    spec_prompts = [np.tile(rng.integers(0, v, size=32),
                            len(p) // 32 + 1)[:len(p)].astype(np.int32)
                    for p in prompts]
    llm.generate([prompts[0][:16]], SP(max_new_tokens=2))
    torch.cuda.synchronize()                  # warm-up (cuBLAS, allocator)

    if step_graph is None:
        modes = [("eager", contextlib.nullcontext)] * 2
    else:
        modes = [("eager", step_graph.eager_steps)] + [
            (f"graphed run {n}", contextlib.nullcontext) for n in (1, 2, 3)]
    out = []
    for case, ps, params in (
            ("greedy", prompts, SP(max_new_tokens=MAX_NEW)),
            ("spec_k=4", spec_prompts,
             SP(max_new_tokens=MAX_NEW, spec_k=4))):
        for mode, ctx in modes:
            with ctx():
                out.append(run_row(torch, llm, ps, params, case, mode))
            print(json.dumps(out[-1]), flush=True)
    for mode, ctx in modes[:1] + [("graphed", contextlib.nullcontext)] * (
            step_graph is not None):
        with ctx():
            out.append(profile_row(torch, llm, SP, prompts, mode))
        print(json.dumps(out[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build",
                           f"step_bench_{args.label}.json"), "w") as f:
        json.dump({"label": args.label, "card": card, "rows": out}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
