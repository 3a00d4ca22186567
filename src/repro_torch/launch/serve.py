"""Serving driver: run the port's continuous-batching engine from the CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --requests 8 --slots 4 [--device cpu] \
      [--head-mode reduced|softmax|fused|temperature] \
      [--kv-layout paged|dense] [--scheduler fused|cohort] \
      [--top-k 4 --temperature 0.8] [--spec-k 4] \
      [--chunk-size 16 [--token-budget 64]] [--host-stride 8] \
      [--attn-approx pseudo [--attn-window 128]] [--serve-http 8000] \
      [--replicas 2]

  # tensor parallelism: one process per rank, rank 0 prints
  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch qwen3-0.6b --tp 2 [--smoke]
  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch rwkv6-7b --tp 4 [--smoke]

Counterpart of ``repro.launch.serve`` with the same flags, plus
``--device`` (default ``cuda``: the entry point runs on the card and
raises without one; ``cpu`` runs the plain kernel versions).  Weights
are random, drawn on the host from ``--seed`` (``weights.seeded_params``)
and moved to the device, so one seed serves one model under every
``--tp``, ``--head-mode`` and ``--device``.

``--serve-http PORT`` swaps the batch run for the network frontend
(``serve/server.py``): an SSE ``POST /v1/completions`` + ``GET
/v1/stats`` HTTP server over the ``LLM`` facade, the engine pumped from
a background thread; per-request SamplingParams arrive in the body.

``--kv-layout dense`` serves the reference's per-slot dense cache (the
paged path's oracle) and ``--scheduler cohort`` its one-step-per-
(position, sampler) baseline; as in the reference, a dense engine
refuses ``--attn-approx`` / ``--attn-window`` (``ValueError``) and
either mode warns and drops ``--chunk-size``, the cohort scheduler
``--host-stride`` too.

``--arch recurrentgemma-2b`` serves the hybrid family (RG-LRU layers
between windowed attention layers) on the dense per-slot store whatever
``--kv-layout`` asks; as in the reference it refuses ``--spec-k``, and
``--chunk-size`` and ``--host-stride`` warn and fall back.

``--tp N`` serves one rank a process under torchrun (the group comes
from its environment; ``parallel.comm.Group.from_env``): every rank
draws the same host weights from ``--seed``, keeps its slice and runs
the same batch, rank 0 prints.  Every served family splits:
``--arch rwkv6-7b --tp 2`` or ``--tp 4`` (its 64 heads of 64 whole),
``--arch recurrentgemma-2b --tp 2`` (5 of its 10 heads and RG-LRU gate
blocks a rank; tp 4 raises, 10 heads are not whole), the dense, moe
and vlm families; ``--arch internvl2-26b`` raises under any ``--tp``
(its vocabulary, 92,553, divides by neither 2 nor 4; the reference's
sharded head refuses it too).  ``--head-mode sharded`` without ``--tp``
keeps the trunk whole and splits the head over the group (a group of one
rank outside torchrun).  ``--replicas N`` serves the batch, or the HTTP
frontend, through the multi-replica ``serve.router.Router``; with
``--tp T`` too, torchrun starts ``N x T`` ranks and replica r is ranks
``[r T, (r + 1) T)`` (the rank-group router: world rank 0 routes and
prints).  ``--serve-http`` under ``--tp``: rank 0 serves HTTP and pumps,
every other rank follows its ticks until rank 0 stops.

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen3-0.6b --tp 2 --replicas 2 \
      [--serve-http 8000]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.attn_approx import VARIANTS
from repro_torch.parallel import comm
from repro_torch.serve import sampler as sampler_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.params import SamplingParams
from repro_torch.weights import seeded_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve a zoo arch with the port's engine.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain kernel versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--head-mode", default="reduced",
                    choices=["reduced", "softmax", "fused", "sharded",
                             "temperature"])
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "dense"])
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: n_slots * "
                         "ceil(max_len/block_size); smaller overcommits)")
    ap.add_argument("--top-k", type=int, default=1,
                    help=">1: top-k sampling via the k-winner comparator")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: speculative decoding, up to K prompt-lookup "
                         "draft tokens a step verified by the comparator "
                         "(greedy only; the same tokens)")
    ap.add_argument("--scheduler", default="fused",
                    choices=["fused", "cohort"])
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="chunked prefill: prompts enter the fused step "
                         "this many tokens an iteration (the same tokens)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="cap on real tokens per fused iteration (with "
                         "--chunk-size)")
    ap.add_argument("--host-stride", type=int, default=None,
                    help=">=1: device-resident decode, up to K fused "
                         "iterations a host dispatch with keyed sampling "
                         "on the device (the same tokens at any stride); "
                         "excludes --spec-k")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="prefix sharing (default on; needs --chunk-size)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--attn-approx", default=None, choices=list(VARIANTS),
                    help="approximate-attention score function of the "
                         "paged decode path (default exact)")
    ap.add_argument("--attn-window", type=int, default=None,
                    help="sliding-window mask over the paged kv view")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-http", type=int, default=None, metavar="PORT",
                    help="instead of the batch run: the SSE HTTP frontend "
                         "on this port, until interrupted")
    ap.add_argument("--http-host", default="127.0.0.1")
    return ap


def build(args, host: bool = False):
    """(params, cfg) from the arch and the seed (``weights.seeded_params``:
    the one tree ``--seed`` names on every device): on ``args.device``,
    or on the host for a rank that keeps only its slice (``host``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the card "
            "(pass --device cpu to run the plain kernel versions)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if host:
        device = torch.device("cpu")
    return seeded_params(cfg, args.seed, device), cfg


def engine_kwargs(args) -> dict:
    return dict(n_slots=args.slots, max_len=args.max_len, eos_id=1,
                head_mode=args.head_mode, kv_layout=args.kv_layout,
                block_size=args.block_size, num_blocks=args.num_blocks,
                scheduler=args.scheduler, chunk_size=args.chunk_size,
                token_budget=args.token_budget,
                host_stride=args.host_stride,
                prefix_cache=args.prefix_cache,
                attn_approx=args.attn_approx, attn_window=args.attn_window,
                tp=args.tp, seed=args.seed)


def main(argv=None) -> dict:
    """Run the CLI; returns the batch run's engine stats (None after
    ``--serve-http``)."""
    args = parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas}: must be >= 1")
    tp = args.tp or 1
    group = None
    if tp > 1 or args.head_mode == "sharded":
        group = comm.Group.from_env(device=args.device)
    try:
        return _serve(args, group)
    finally:
        if group is not None:
            group.close()


def _serve(args, group):
    """The batch run (or the HTTP frontend) of ``main``."""
    params, cfg = build(args, host=group is not None)
    kw = dict(engine_kwargs(args), group=group)
    sampler = sampler_mod.resolve(args.head_mode, args.top_k,
                                  args.temperature, cfg=cfg)
    if args.replicas > 1:
        from repro_torch.serve.router import Router

        if (args.tp or 1) == 1:
            kw.pop("group")      # unsharded replicas in this process
        front = Router(params, cfg, replicas=args.replicas, **kw)
    elif args.serve_http is not None:
        from repro_torch.serve.api import LLM

        front = LLM(params, cfg, **kw)
    if args.serve_http is not None:
        from repro_torch.serve.server import serve_forever

        serve_forever(front, host=args.http_host, port=args.serve_http)
        return None
    rng = np.random.default_rng(args.seed)
    prompts = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompts.append(rng.integers(0, cfg.vocab_size, plen).astype(np.int32))
    if args.replicas > 1:
        t0 = time.perf_counter()
        front.generate(prompts, SamplingParams(
            max_new_tokens=args.max_new, spec_k=args.spec_k,
            top_k=args.top_k, temperature=args.temperature,
            head_mode=args.head_mode))
        snap = front.stats
        if not getattr(front, "leader", True):
            return snap
        print(f"sampler={sampler} device={args.device} replicas="
              f"{args.replicas} tp={args.tp or 1} "
              f"routed={[r.served for r in front.replicas]} "
              f"served={snap['completed']} decode_steps="
              f"{snap['decode_steps']} wall={time.perf_counter() - t0:.2f}s",
              flush=True)
        return snap
    eng = ServeEngine(params, cfg, **kw)
    for rid, prompt in enumerate(prompts):
        if args.spec_k:
            # every sampling knob through the params, so an invalid
            # combination fails loudly at submit
            eng.submit(Request(rid, prompt, params=SamplingParams(
                max_new_tokens=args.max_new, spec_k=args.spec_k,
                top_k=args.top_k, temperature=args.temperature,
                head_mode=args.head_mode)))
        else:
            eng.submit(Request(rid, prompt, max_new_tokens=args.max_new,
                               sampler=sampler))
    t0 = time.perf_counter()
    stats = eng.run()
    dt = time.perf_counter() - t0
    snap = eng.snapshot()
    if group is not None and group.rank != 0:
        return snap
    spec = (f"drafted={stats['drafted']} accepted={stats['accepted']} "
            f"acceptance={stats['acceptance_rate']:.2f} "
            if args.spec_k else "")
    chunk = (f"prefill_chunks={stats['prefill_chunks']} "
             if eng.chunk_size is not None else "")
    stride = (f"host_syncs={stats['host_syncs']} "
              f"tok/dispatch={snap['tokens_per_dispatch']:.2f} "
              if eng.host_stride is not None else "")
    prefix = (f"prefix_hits={stats['prefix_hits']} "
              f"prefix_hit_tokens={stats['prefix_hit_tokens']} "
              f"cow_copies={snap['cow_copies']} "
              if eng.prefix_cache else "")
    tpinfo = (f"tp={eng.tp} world={group.world} backend={group.backend} "
               f"collective_bytes={group.bytes} " if group is not None
               else "")
    layout = "paged" if eng.store.any_paged else "dense"
    print(f"sampler={sampler} device={args.device} kv={layout} "
          f"sched={args.scheduler} {tpinfo}{chunk}{stride}{prefix}"
          f"served={stats['completed']} "
          f"decode_steps={stats['decode_steps']} "
          f"iterations={stats['iterations']} "
          f"rows/step="
          f"{stats['fused_rows'] / max(stats['decode_steps'], 1):.2f} "
          f"preempt={stats['preemptions']} {spec}wall={dt:.2f}s",
          flush=True)
    return snap


if __name__ == "__main__":
    main()
