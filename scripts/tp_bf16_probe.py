"""Why tensor-parallel bf16 greedy streams part from the unsharded engine's.

Runs on the card, in one call (``python3 scripts/tp_bf16_probe.py``,
~3 min): qwen3-0.6b at full width in bf16, ``chip_smoke.py`` phase 4k's
12 prompts of 64-512 tokens, 32 greedy tokens each, 8 slots of 1,024
positions, host weights from seed 0.  Five arms:

  unsharded     the plain engine (graphed), the reference
  split2        the same engine, one process, with every ``wo`` and
                ``w_out`` product computed as tp 2 computes it: two half-K
                bf16 GEMMs, each rounded to bf16, then their bf16 sum
  split2_f32    the same, with the two half-K products kept in f32 and
                their f32 sum cast to bf16 once
  tp2           two ranks over gloo sharing the card, as phase 4k
  tp2_f32sum    the same two ranks with each rank's ``wo`` / ``w_out``
                partial kept in f32 (``torch.mm(..., out_dtype=float32)``),
                summed in f32 over gloo and cast to bf16 once, as the
                unsharded GEMM rounds its f32 sum once

For each arm it prints the streams equal to ``unsharded``'s and to
``tp2``'s (the split arms also to their tp twin's), and each parting's
step and top-2 f32 logit gap (``chip_smoke.compare_streams``), and
writes them to ``chiprun_out/tp_bf16_probe.json``.  A split arm whose
streams are its tp twin's, where neither is ``unsharded``'s, puts the
partings on the split of the K sum alone, with no collective, sharded
head or plan involved.  The arms swap a product's arithmetic by wrapping
the layer's ``wo`` / ``w_out`` views (``lm._layer``) in objects that
define ``__rmatmul__``; nothing in the package changes.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

SEED = 0
MAX_NEW = 32
ROW_PARALLEL = ("wo", "w_out")
RANK_TIMEOUT_S = 600


class SplitSum:
    """``x @ w`` as tp 2 computes it: the two half-K products, each in
    the compute dtype, summed in the compute dtype."""

    def __init__(self, w):
        self.w = w

    def __rmatmul__(self, x):
        h = self.w.shape[0] // 2
        return x[..., :h] @ self.w[:h] + x[..., h:] @ self.w[h:]


class SplitSumF32:
    """``x @ w`` as ``tp2_f32sum`` computes it: the two half-K products in
    f32, their f32 sum cast to the compute dtype once."""

    def __init__(self, w):
        self.w = w

    def __rmatmul__(self, x):
        h = self.w.shape[0] // 2
        y = F32Partial(self.w[:h]).__rmatmul__(x[..., :h]) \
            + F32Partial(self.w[h:]).__rmatmul__(x[..., h:])
        return y.to(x.dtype)


class F32Partial:
    """A rank's ``x @ w`` kept in f32 (the all-reduce then sums f32 and
    ``f32_sum`` casts the result once)."""

    def __init__(self, w):
        self.w = w

    def __rmatmul__(self, x):
        import torch

        y = torch.mm(x.reshape(-1, x.shape[-1]), self.w,
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], y.shape[-1])


@contextlib.contextmanager
def wrapped(kind):
    """Every layer view built inside has its row-parallel products
    wrapped in ``kind``."""
    from repro_torch.models import lm

    inner = lm._layer

    def layer(sp, l):
        p = inner(sp, l)
        for key in ROW_PARALLEL:
            for sub in p.values():
                if isinstance(sub, dict) and key in sub:
                    sub[key] = kind(sub[key])
        return p

    lm._layer = layer
    try:
        yield
    finally:
        lm._layer = inner


def f32_sum(group):
    """Cast the trunk's f32 all-reduce results to bf16 once."""
    import torch

    inner = group.all_reduce_sum

    def reduce(x, kind):
        y = inner(x, kind)
        return y.to(torch.bfloat16) if kind == "trunk" else y

    group.all_reduce_sum = reduce
    return inner


def streams(outs):
    return [list(o.token_ids) for o in outs]


def rank_main(rank: int, d: str) -> None:
    """One of tp 2's ranks: the plain arm, then the f32-sum arm."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.parallel import comm
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = comm.Group.init(rank, 2, init_method=f"file://{d}/rdv",
                        device="cuda")
    cfg = get_config("qwen3-0.6b")
    host = seeded_params(cfg, SEED, "cpu")
    prompts, params = cs.tp_inputs(cfg.vocab_size, MAX_NEW)
    res = {}
    llm = LLM(host, cfg, tp=2, group=g, **cs.tp_engine_kwargs())
    res["tp2"] = streams(llm.generate(prompts["main"], params["greedy"]))
    del llm
    inner = f32_sum(g)
    with wrapped(F32Partial):
        llm = LLM(host, cfg, tp=2, group=g, **cs.tp_engine_kwargs())
        res["tp2_f32sum"] = streams(llm.generate(prompts["main"],
                                                 params["greedy"]))
    g.all_reduce_sum = inner
    with open(os.path.join(d, f"out{rank}.json"), "w") as f:
        json.dump(res, f)
    g.close()


def main() -> int:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.serve.api import LLM
    from repro_torch.weights import seeded_params

    if not torch.cuda.is_available():
        print("tp_bf16_probe: no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    d = os.path.join(ROOT, "build", "tp_bf16_probe")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), d],
        stdout=open(os.path.join(d, f"log{r}.txt"), "w"),
        stderr=subprocess.STDOUT, env=dict(os.environ, OMP_NUM_THREADS="2"))
        for r in range(2)]

    cfg = get_config("qwen3-0.6b")
    host = seeded_params(cfg, SEED, "cpu")
    prompts, params = cs.tp_inputs(cfg.vocab_size, MAX_NEW)
    dev = cs._tree_to(host, "cuda")
    got = {}
    llm = LLM(dev, cfg, **cs.tp_engine_kwargs())
    got["unsharded"] = llm.generate(prompts["main"], params["greedy"])
    del llm
    for arm, kind in (("split2", SplitSum), ("split2_f32", SplitSumF32)):
        with wrapped(kind):
            llm = LLM(dev, cfg, **cs.tp_engine_kwargs())
            got[arm] = llm.generate(prompts["main"], params["greedy"])
        del llm
    gap_llm = LLM(dev, dataclasses.replace(cfg, dtype="float32"),
                  **cs.tp_engine_kwargs())

    for r, p in enumerate(procs):
        try:
            p.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit(f"rank {r} ran past {RANK_TIMEOUT_S} s")
        if p.returncode:
            with open(os.path.join(d, f"log{r}.txt")) as f:
                print(f.read()[-3000:], file=sys.stderr)
            raise SystemExit(f"rank {r} exited {p.returncode}")
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"out{r}.json")) as f:
            ranks.append(json.load(f))
    for arm in ("tp2", "tp2_f32sum"):
        if ranks[1][arm] != ranks[0][arm]:
            raise SystemExit(f"{arm}: rank 1's tokens differ from rank 0's")
        got[arm] = [types.SimpleNamespace(token_ids=tuple(t), rid=o.rid)
                    for t, o in zip(ranks[0][arm], got["unsharded"])]

    report = {"card": card.strip(), "prompts": len(prompts["main"]),
              "max_new": MAX_NEW}
    for arm in ("split2", "split2_f32", "tp2", "tp2_f32sum"):
        report[arm] = {
            "same_as_unsharded": cs.compare_streams(
                torch, gap_llm, prompts["main"], got["unsharded"], got[arm],
                f"{arm} vs unsharded", gate=False)}
    for arm, twin in (("split2", "tp2"), ("split2_f32", "tp2_f32sum"),
                      ("tp2_f32sum", "tp2")):
        report[arm][f"same_as_{twin}"] = cs.compare_streams(
            torch, gap_llm, prompts["main"], got[twin], got[arm],
            f"{arm} vs {twin}", gate=False)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tp_bf16_probe.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
