"""Serving demo of the PyTorch/CUDA port: the LLM facade over continuous
batching, a paged KV pool and the reduced unit as the decode head.

The counterpart of ``examples/serve_demo.py`` on ``repro_torch``:

  - ``LLM.generate(prompts, params)``: batched, order-preserving, mixed
    greedy comparator / top-k comparator bus / Gumbel-max temperature
    requests, one fused ragged decode step per iteration;
  - ``LLM.stream``: per-token chunks while another request is in
    flight, the top-k candidate ids riding along;
  - stop sequences (``finish_reason='stop'``);
  - Theorem 1 at the API level: greedy through the reduced comparator
    and through the full softmax unit gives the same tokens;
  - speculative decoding (``spec_k``): the plain greedy tokens in fewer
    iterations;
  - prefix sharing on a chunked engine: the tokens of sharing off, fewer
    prompt tokens prefilled;
  - the device-resident loop (``host_stride``): the same mixed trace at
    strides 1, 4 and 8 gives the same tokens, with several tokens per
    host dispatch.

  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu
  python examples/serve_demo_torch.py          # on the card (default)
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.params import SamplingParams  # noqa: E402

ENGINE = dict(n_slots=4, max_len=96, eos_id=1, block_size=16)


def mixed(rng, vocab, n):
    """n prompts and a mixed queue: top-4 bus, Gumbel-max, greedy."""
    prompts = [rng.integers(0, vocab, int(rng.integers(4, 24))).astype(
        np.int32) for _ in range(n)]
    plist = [SamplingParams(max_new_tokens=int(rng.integers(4, 12)),
                            seed=rid, **(
                                {"top_k": 4, "temperature": 0.8}
                                if rid % 3 == 0 else
                                {"head_mode": "temperature",
                                 "temperature": 0.8}
                                if rid % 3 == 1 else {}))
             for rid in range(n)]
    return prompts, plist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    args = ap.parse_args(argv)
    llm = LLM.from_arch("qwen3-0.6b", smoke=True, device=args.device,
                        **ENGINE)
    cfg = llm.cfg
    rng = np.random.default_rng(0)
    n_req = 12
    prompts, plist = mixed(rng, cfg.vocab_size, n_req)

    t0 = time.perf_counter()
    outs = llm.generate(prompts, plist)
    dt = time.perf_counter() - t0
    stats, kv = llm.stats, llm.kv_usage()
    print(f"served {n_req} requests in {dt:.2f}s on {args.device} "
          f"({llm.engine.n_slots} slots, paged KV)")
    print(f"fused ragged decode: {stats['decode_steps']} steps over "
          f"{stats['iterations']} iterations "
          f"({stats['fused_rows'] / max(stats['decode_steps'], 1):.2f} "
          f"rows/step), head calls {stats['head_calls']}")
    for o in outs:
        kind = ("top-k" if o.params.top_k > 1 else
                "gumbel" if o.params.head_mode == "temperature" else
                "greedy")
        print(f"  rid={o.rid:2d} {kind:6s} prompt={len(o.prompt_token_ids):2d}"
              f" generated={len(o.token_ids):2d} finish={o.finish_reason:6s}"
              f" ttft={o.timing.ttft_ms:6.1f}ms")
    assert stats["completed"] == n_req
    assert stats["decode_steps"] == stats["iterations"]
    assert kv["blocks_free"] == kv["num_blocks"]

    it = llm.stream(prompts[0], SamplingParams(max_new_tokens=8,
                                               n_candidates=4))
    other = llm.submit(prompts[1], SamplingParams(max_new_tokens=8))
    first = next(it)
    in_flight = not other.done
    rest = list(it)
    print(f"\nstreamed rid={first.rid}: first token {first.token} with "
          f"candidates {first.candidate_ids}, "
          f"{'another request in flight' if in_flight else 'queue idle'}; "
          f"{1 + len(rest)} chunks, finish {rest[-1].finish_reason}")
    assert first.finish_reason is None
    llm._drive_until(lambda: other.done)

    probe = llm.generate(prompts[2], SamplingParams(max_new_tokens=8))[0]
    stop = probe.token_ids[1:3]
    stopped = llm.generate(prompts[2], SamplingParams(max_new_tokens=8,
                                                      stop=[stop]))[0]
    print(f"stop sequence {stop}: '{stopped.finish_reason}' after "
          f"{len(stopped.token_ids)} tokens")
    assert stopped.finish_reason == "stop"
    assert stopped.token_ids == probe.token_ids[:3]

    grd = llm.generate(prompts, SamplingParams(max_new_tokens=8))
    soft = llm.generate(prompts, SamplingParams(max_new_tokens=8,
                                                head_mode="softmax"))
    same = sum(g.token_ids == s.token_ids for g, s in zip(grd, soft))
    print(f"reduced vs softmax: {same}/{n_req} generations identical")
    assert same == n_req, "Theorem 1 violated: reduced != softmax tokens"

    rep = [np.tile(rng.integers(0, cfg.vocab_size, 4), 5).astype(np.int32)
           for _ in range(4)]
    plain = llm.generate(rep, SamplingParams(max_new_tokens=16))
    it0 = llm.stats["iterations"]
    spec = llm.generate(rep, SamplingParams(max_new_tokens=16, spec_k=4))
    s = llm.stats
    print(f"speculative (spec_k=4): {sum(len(o.token_ids) for o in spec)} "
          f"tokens in {s['iterations'] - it0} iterations, acceptance "
          f"{s['acceptance_rate']:.2f}, identical to plain greedy")
    assert [o.token_ids for o in spec] == [o.token_ids for o in plain]

    system = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    chats = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 12))).astype(np.int32)])
        for _ in range(8)]
    shared = LLM(llm.engine.params, cfg, chunk_size=16, **ENGINE)
    on = shared.generate(chats, SamplingParams(max_new_tokens=8))
    cold = LLM(llm.engine.params, cfg, chunk_size=16, **ENGINE)
    off = cold.generate(chats, SamplingParams(max_new_tokens=8,
                                              prefix_cache=False))
    st = shared.stats
    print(f"prefix sharing: {st['prefix_hits']} hits, "
          f"{st['prefill_tokens']} prompt tokens prefilled against "
          f"{cold.stats['prefill_tokens']} cold, same tokens")
    assert [o.token_ids for o in on] == [o.token_ids for o in off]
    assert st["prefill_tokens"] < cold.stats["prefill_tokens"]

    print("\ndevice-resident loop (host_stride), the mixed trace again:")
    runs = {}
    for stride in (1, 4, 8):
        keyed = LLM(llm.engine.params, cfg, host_stride=stride, **ENGINE)
        t0 = time.perf_counter()
        got = keyed.generate(prompts, plist)
        dt = time.perf_counter() - t0
        ks = keyed.stats
        runs[stride] = [o.token_ids for o in got]
        print(f"  host_stride={stride}: {ks['emitted_tokens']} tokens, "
              f"{ks['host_syncs']} host syncs "
              f"({ks['tokens_per_dispatch']:.2f} tokens a dispatch), "
              f"{ks['decode_steps']} decode dispatches, {dt:.2f}s")
        assert ks["host_syncs"] == ks["prefills"] + ks["decode_steps"]
    assert runs[1] == runs[4] == runs[8], "host_stride changed the tokens"
    print("  every stride served the same tokens")


if __name__ == "__main__":
    main()
