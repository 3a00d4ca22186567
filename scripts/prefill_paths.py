#!/usr/bin/env python3
"""How far apart one-shot and chunked prefill are in bf16, on one NVIDIA
GPU, against the f32 trunk.

    python3 scripts/prefill_paths.py

At qwen3-0.6b's full width with seeded random weights (8 slots,
max_len 1024), ``chip_smoke.py`` phase 4's 12 prompts are served greedy
(32 new tokens) one-shot and at ``chunk_size=64``.  For every prompt
it prints the largest |logit| difference at the prompt's last position
between three paths -- the one-shot prefill (bf16), the chunked
prefill's final chunk row (bf16, eager) and a prefill of the f32 trunk
(the same weights in f32) -- and, where the two bf16 streams part, each
path's top-2 logit gap at that step and its margin between the two
tokens.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefill_paths: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams as SP

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    llm = LLM.from_arch("qwen3-0.6b", smoke=False, seed=0, n_slots=8,
                        max_len=1024)
    cfg, params = llm.cfg, llm.engine.params
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.float()

    params32 = f32(params)
    w = lm.lm_head_weight(params, cfg).float()
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in prng.integers(64, 513, size=12)]
    sp = SP(max_new_tokens=32)
    one = llm.generate(prompts, sp)
    chunked = LLM(params, cfg, n_slots=8, max_len=1024, seed=0,
                  prefix_cache=False, chunk_size=64).generate(prompts, sp)

    def prefill_logits(p, c, hist):
        t = torch.as_tensor(np.asarray(hist, np.int64), device="cuda")[None]
        h, _ = lm.prefill(p, c, t, len(hist))
        return (h.float() @ w)[0]

    def chunk_logits(hist):
        e = LLM(params, cfg, n_slots=1, max_len=1024, seed=0,
                prefix_cache=False, chunk_size=64)
        body, seen = e.engine._step_body, []

        def record(order, *operands):
            h, outs = body(order, *operands)
            seen.append(h[:, -1] if h.dim() == 3 else h)
            return h, outs

        e.engine._step_body = record
        with step_graph.eager_steps():
            e.generate([np.asarray(hist, np.int32)], SP(max_new_tokens=1))
        return (seen[-1].float() @ w)[0]

    def paths(hist):
        return {"one-shot bf16": prefill_logits(params, cfg, hist),
                "chunked bf16": chunk_logits(hist),
                "f32 trunk": prefill_logits(params32, cfg32, hist)}

    for r, (p, a, b) in enumerate(zip(prompts, one, chunked)):
        ls = paths(p)
        names = list(ls)
        diffs = ", ".join(
            f"{x} vs {y} {float((ls[x] - ls[y]).abs().max()):.5g}"
            for i, x in enumerate(names) for y in names[i + 1:])
        print(f"prompt {r} ({len(p)} tokens), last position, max |logit "
              f"diff|: {diffs}", flush=True)
        if a.token_ids == b.token_ids:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a.token_ids, b.token_ids))
                 if x != y)
        ta, tb = a.token_ids[k], b.token_ids[k]
        ls = paths(list(p) + list(a.token_ids[:k]))
        for name, lg in ls.items():
            top = lg.topk(2).values
            print(f"  parts at step {k} (one-shot {ta}, chunked {tb}): "
                  f"{name} top-2 gap {float(top[0] - top[1]):.6g} (max "
                  f"{float(top[0]):.6g}), logit[{ta}] - logit[{tb}] "
                  f"{float(lg[ta] - lg[tb]):.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
