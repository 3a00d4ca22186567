"""Tensor-parallel serving on the CPU: the port's ranks over gloo against
the JAX package's engine, unsharded.

The JAX side runs in the test process on the bridged smoke weights (the
reference's own tests, ``tests/test_tp_serving.py``, show its sharded
engine equals its unsharded one).  The port's side runs as ``world``
subprocesses -- one rank each, a ``parallel.comm.Group`` over gloo with a
``file://`` rendezvous under ``tmp_path`` (no TCP port for xdist's
workers to race for), each waited on with a timeout of its own -- which
load the same numpy tree and write what they served as JSON.  The ranks
of tp 2 and tp 4 start together and run while the JAX engines do.  The
same rank processes hold the control plane: ``Router(replicas=2,
tp=2)`` over the world of 4, and the HTTP server under tp (an ``LLM`` at
world 2, the rank-group router at world 4) on groups whose collectives
time out after 5 s, rank 0 serving while the other ranks follow.  The
MoE family rides the same ranks: phi3.5-moe's smoke config (4 experts,
top-2) at tp 2 and tp 4, llama4-maverick's (``(attn, moe)`` units, a
shared expert, top-1) at tp 2, each rank holding its range of experts
(``parallel.moe_ep``) against the JAX engine unsharded.  So does
training on a (data, model) mesh: qwen3's smoke config at 1x2 and 2x1
(world 2) and 2x2 (world 4), held to the JAX package's single-device
``make_train_step`` in this process and, at 2x2, to
``repro.launch.train.train`` on a ``(2, 2)`` mesh of four forced host
devices (a subprocess beside the ranks); then a 2x2 checkpoint read at
1x1 and by ``repro.checkpoint``, and ``pipeline_apply`` over 4 ranks.

Tolerances: tokens are compared exactly.  The sharded heads' ids are
compared exactly and their values at rtol 1e-5 (f32: the frameworks sum
D in another order); across the ranks of one group every output must be
identical.  Training (f32, as ``tests/test_torch_train.py``): each
step's loss within 1e-5, its grad_norm at rtol 1e-5, each gradient leaf
within 5e-5 of its largest |value|.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.core import reduced_softmax as jrs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import reduced_softmax as trs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.weights import shard_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
RANK_TIMEOUT_S = 120          # each rank process
GROUP_TIMEOUT_S = 30          # every collective of a rank's group
# the HTTP scenarios' groups time out after IDLE_TIMEOUT_S; the server
# sits idle for IDLE_S first (world 2: past that timeout)
IDLE_TIMEOUT_S = 5
IDLE_S = {2: 6.5, 4: 0.5}
RTOL = 1e-5
# the O(k)-not-O(V) case of tests/test_tp_serving.py:406-430
BYTES_SHAPE = dict(b=8, d=64, v=4096, k=4)

# One rank: the scenarios of its world, each result (or its error) under
# its name in out<rank>.json.  Weights: the bridged tree (jtree.pkl) and
# its copy with an exact tie between vocabulary ids 10 and 200 (tie.pkl);
# head inputs: heads.npz.
RANK_SCRIPT = textwrap.dedent(r'''
    import dataclasses, functools, json, pickle, sys, threading, time
    import traceback
    import urllib.error, urllib.request
    import numpy as np
    import torch
    from repro_torch import weights
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import reduced_softmax as rs
    from repro_torch.models import lm
    from repro_torch.parallel import comm, sharding
    from repro_torch.serve.api import LLM
    from repro_torch.serve import step_graph
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.params import SamplingParams
    from repro_torch.serve.router import Router
    from repro_torch.serve.server import make_server, serve_forever

    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    g = comm.Group.init(rank, world, init_method=f"file://{d}/rdv{world}",
                        device="cpu", timeout_s=float(sys.argv[4]))
    cfg = smoke_config(get_config("qwen3-0.6b"))
    def tree(name):
        with open(f"{d}/{name}", "rb") as f:
            return weights.from_numpy_params(pickle.load(f), cfg, "cpu")
    params, tie = tree("jtree.pkl"), tree("tie.pkl")
    inputs = dict(np.load(f"{d}/heads.npz"))
    def named_cfg(name):
        # "<arch>" or "<arch>@<V>": the smoke config, its vocab_size V
        arch, _, v = name.partition("@")
        c = smoke_config(get_config(arch))
        return dataclasses.replace(c, vocab_size=int(v)) if v else c

    VLM, ENCDEC = "internvl2-26b", "seamless-m4t-large-v2"
    arch_cfgs = {a: named_cfg(a) for a in (
        "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "rwkv6-7b",
        "recurrentgemma-2b", VLM, ENCDEC, VLM + "@255", ENCDEC + "@258")}
    FAMILY_TRAIN = ("phi3.5-moe-42b-a6.6b", "rwkv6-7b", "recurrentgemma-2b",
                    VLM, ENCDEC)
    out = {}

    def scenario(fn, name=None):
        name = name or fn.__name__
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
        return fn

    def arch_tree(arch):
        with open(f"{d}/{arch}.pkl", "rb") as f:
            return pickle.load(f)

    def serve(spec_k=0, host_stride=None, **kw):
        # the body of tests/test_tp_serving.py:280-324
        kw = {"chunk_size": 8, **kw}
        eng = ServeEngine(params, cfg, n_slots=3, max_len=64,
                          head_mode="reduced", host_stride=host_stride,
                          seed=7, tp=world, group=g, **kw)
        prompts = [np.arange(2, 2 + n, dtype=np.int32) % cfg.vocab_size
                   for n in (5, 9, 13, 4)]
        reqs = []
        for r, p in enumerate(prompts):
            mixed = spec_k == 0 and r == 1
            sp = SamplingParams(max_new_tokens=10, spec_k=spec_k,
                                top_k=4 if mixed else 1,
                                temperature=0.8 if mixed else 1.0, seed=r)
            reqs.append(Request(rid=r, prompt=p.copy(), params=sp))
            eng.submit(reqs[-1])
        eng.run(max_iters=200)
        on_card = step_graph.graphed           # what the card would do
        step_graph.graphed = lambda device: True
        would_graph = eng._graphed()
        step_graph.graphed = on_card
        return {"tokens": [list(r.generated) for r in reqs],
                "head_mode": eng.head_mode, "tp": eng.tp,
                "accepted": eng.stats["accepted"],
                "captures": eng.graphs.captures,
                "would_graph": would_graph,
                "bytes": dict(g.bytes)}

    @scenario
    def base():
        return serve()

    def serve_arch(arch):
        # the bridged tree of another family, every rank its slice (a
        # moe layer's experts, a recurrent layer's channels), greedy rows
        # and one TopK row, no chunking (it falls back where it must)
        mcfg = arch_cfgs[arch]
        mparams = weights.from_numpy_params(arch_tree(arch), mcfg, "cpu")
        b0 = dict(g.bytes)
        eng = ServeEngine(mparams, mcfg, n_slots=3, max_len=48, seed=7,
                          eos_id=-1, tp=world, group=g)
        reqs = []
        for r, n in enumerate((5, 9, 13, 4)):
            p = (np.arange(2, 2 + n, dtype=np.int32) * 7) % mcfg.vocab_size
            sp = SamplingParams(max_new_tokens=10, top_k=4 if r == 1 else 1,
                                temperature=0.8 if r == 1 else 1.0, seed=r)
            reqs.append(Request(rid=r, prompt=p, params=sp))
            eng.submit(reqs[-1])
        eng.run(max_iters=200)
        res = {"tokens": [list(r.generated) for r in reqs],
               "tp": eng.tp, "head_mode": eng.head_mode,
               "paged": eng.store.any_paged,
               "spec_capable": eng.spec_capable, "bytes": {
                   k: n - b0.get(k, 0) for k, n in g.bytes.items()}}
        if mcfg.moe is not None:
            res.update(experts=list(eng.cfg.shard.experts),
                       num_experts=eng.cfg.moe.num_experts,
                       held=int(eng.params["decoder"][0][
                           "slot0" if mcfg.moe.interleave_step == 1
                           else "slot1"]["moe"]["w_gate"].shape[1]))
            return res
        # the rank's recurrent channels and its state's width
        res["chan"] = list(eng.cfg.shard.chan)
        slot = eng.store.denses[0]["slot0"] if not eng.store.any_paged \
            else None
        if mcfg.family == "ssm":
            res["state"] = list(slot["wkv"].shape)
        elif mcfg.family == "hybrid":
            res["state"] = list(slot["rec"]["h"].shape)
        return res

    @scenario
    def moe_phi():
        return serve_arch("phi3.5-moe-42b-a6.6b")

    for arch in ("rwkv6-7b", "recurrentgemma-2b", "internvl2-26b"):
        scenario(functools.partial(serve_arch, arch), f"family_{arch}")

    @scenario
    def spec():
        return serve(spec_k=4)

    @scenario
    def stride():
        return serve(host_stride=4)

    @scenario
    def compressed():
        # compressed_psum of this rank's gradients and error buffers
        # (psum.npz, every rank's) over the group
        from repro_torch.optim import compression
        ps = np.load(f"{d}/psum.npz")
        mine = {k[:-len(f"_{rank}")]: torch.from_numpy(ps[k])
                for k in ps.files if k.endswith(f"_{rank}")}
        grads = {"a": mine["g_a"], "b": [mine["g_b"]]}
        errs = {"a": mine["e_a"], "b": [mine["e_b"]]}
        synced, new_err = compression.compressed_psum(grads, g, errs,
                                                      block=64)
        return {"synced": [synced["a"].tolist(), synced["b"][0].tolist()],
                "err": [new_err["a"].tolist(), new_err["b"][0].tolist()]}

    @scenario
    def heads():
        # each rank's contiguous slice of W through the sharded unit
        h, w = (torch.from_numpy(inputs[k]) for k in ("h", "w"))
        v = w.shape[1]
        lo, hi = rank * v // world, (rank + 1) * v // world
        wl = w.t()[lo:hi].contiguous().t()
        idx = rs.sharded_reduced_head(h, wl, g, v_lo=lo)
        dist_idx = rs.distributed_argmax(h @ wl, g, v_lo=lo)
        vals, ids = rs.sharded_reduced_topk(h, wl, 4, g, v_lo=lo,
                                            vocab_size=v)
        ht = torch.from_numpy(inputs["ht"])
        cand = torch.from_numpy(inputs["cand"])
        vids, acc = rs.sharded_verify_draft(ht, wl, cand, g, v_lo=lo)
        ws = torch.from_numpy(inputs["w_small"])
        vs = ws.shape[1]
        a, b = rank * vs // world, (rank + 1) * vs // world
        svals, sids = rs.sharded_reduced_topk(
            h, ws.t()[a:b].contiguous().t(), 8, g, v_lo=a, vocab_size=vs)
        return {"argmax": idx.tolist(), "dist_argmax": dist_idx.tolist(),
                "topk_vals": vals.tolist(),
                "topk_ids": ids.tolist(), "verify_ids": vids.tolist(),
                "accept": acc.tolist(), "narrow_vals": svals.tolist(),
                "narrow_ids": sids.tolist()}

    @scenario
    def head_bytes():
        rng = np.random.default_rng(1)
        b, dd, v, k = (int(x) for x in inputs["bytes_shape"])
        h = torch.from_numpy(rng.normal(size=(b, dd)).astype(np.float32))
        lo, hi = rank * v // world, (rank + 1) * v // world
        wl = torch.from_numpy(rng.normal(size=(hi - lo, dd))
                              .astype(np.float32)).t()
        g.bytes.clear()
        rs.sharded_reduced_topk(h, wl, k, g, v_lo=lo, vocab_size=v)
        comparator = dict(g.bytes)
        g.bytes.clear()
        rs.sharded_reduced_head(h, wl, g, v_lo=lo)
        argmax = dict(g.bytes)
        g.bytes.clear()
        g.all_gather(h @ wl, "logits")         # the Temperature head's
        return {"topk": comparator, "argmax": argmax,
                "logits": dict(g.bytes)}

    def roundtrip(front):
        # the checks of tests/test_serve_api.py:294 against world rank
        # 0's server; every other rank follows until rank 0 stops
        if rank != 0:
            t0 = time.monotonic()
            serve_forever(front)
            return {"followed_s": time.monotonic() - t0}
        srv = make_server(front, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(body):
            req = urllib.request.Request(
                f"{base}/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=60)

        def code(fn):
            try:
                fn()
            except urllib.error.HTTPError as e:
                return e.code, "error" in json.loads(e.read())
            return 200, False

        res = {}
        try:
            time.sleep(float(sys.argv[5]))      # idle past the timeout
            res["idle_pump_alive"] = front._pumping
            prompt = [5, 11, 7, 3, 19, 2]
            full = json.loads(post({"prompt": prompt,
                                    "max_new_tokens": 5}).read())
            raw = post({"prompt": prompt, "max_new_tokens": 5,
                        "stream": True}).read().decode()
            lines = [l[6:] for l in raw.splitlines()
                     if l.startswith("data: ")]
            res.update(
                full=full["token_ids"], finish=full["finish_reason"],
                tok_s=full["timing"]["tok_s"], done=lines[-1],
                streamed=[json.loads(l)["token"] for l in lines[:-1]],
                last_finish=json.loads(lines[-2])["finish_reason"],
                stats=json.loads(urllib.request.urlopen(
                    f"{base}/v1/stats", timeout=60).read()),
                health=json.loads(urllib.request.urlopen(
                    f"{base}/healthz", timeout=60).read()),
                not_found=code(lambda: urllib.request.urlopen(
                    f"{base}/no/such", timeout=60)),
                bad_prompt=code(lambda: post({"prompt": "not token ids"})),
                bad_stream=code(lambda: post({"prompt": prompt,
                                              "stream": True,
                                              "top_k": 500})))
        finally:
            srv.shutdown()
            front.stop_pump()
        res["pump_error"] = repr(front._pump_error)
        return res

    @scenario
    def encdec_greedy():
        # seamless's smoke config at tp ``world``: lm.prefill over the
        # source frames (encdec.npz), then greedy lm.decode_step on the
        # dense cache, each token from the sharded argmax head on the
        # rank's vocabulary slice; the encoder and every xattn layer's
        # cross-attention at the rank's heads
        from repro_torch.serve.sampler import Greedy

        ecfg = arch_cfgs[ENCDEC]
        split = sharding.plan(ecfg, rank, world, group=g)
        local = sharding.local_config(ecfg, split)
        ep = weights.cast_params(weights.shard_params(
            weights.from_numpy_params(arch_tree(ENCDEC), ecfg, "cpu"),
            ecfg, split), local)
        v = np.load(f"{d}/encdec.npz")
        toks = torch.from_numpy(v["tokens"]).long()
        src = torch.from_numpy(v["src"])
        steps, t, head = int(v["steps"]), toks.shape[1], Greedy("sharded")
        b0 = dict(g.bytes)
        h, cache = lm.prefill(ep, local, toks, t + steps, src_embeds=src)
        outs = [head.head(ep, local, h).long()]
        for i in range(steps):
            h, cache = lm.decode_step(ep, local, outs[-1][:, None], cache,
                                      torch.tensor(t + i))
            outs.append(head.head(ep, local, h).long())
        return {"tokens": torch.stack(outs, 1).tolist(),
                "xk": list(cache[0]["slot0"]["xk"].shape),
                "vocab": list(split.vocab), "bytes": {
                    k: n - b0.get(k, 0) for k, n in g.bytes.items()
                    if n - b0.get(k, 0)}}

    if world == 2:
        @scenario
        def moe_llama4():
            return serve_arch("llama4-maverick-400b-a17b")

        @scenario
        def vlm_prefix():
            # lm.prefill with the image prefix on the rank's slice of the
            # bridged internvl2 smoke tree (vlm.npz: tokens and images)
            vcfg = arch_cfgs["internvl2-26b"]
            split = sharding.plan(vcfg, rank, world, group=g)
            local = sharding.local_config(vcfg, split)
            vp = weights.shard_params(weights.from_numpy_params(
                arch_tree("internvl2-26b"), vcfg, "cpu"), vcfg, split)
            vp = weights.cast_params(vp, local)
            v = np.load(f"{d}/vlm.npz")
            toks = torch.from_numpy(v["tokens"]).long()
            img = torch.from_numpy(v["image"])
            h, _ = lm.prefill(vp, local, toks, 32, image_embeds=img)
            plain, _ = lm.prefill(vp, local, toks, 32)
            return {"h": h.tolist(), "plain": plain.tolist(),
                    "argmax": torch.argmax(lm.logits_fn(vp, local, h),
                                           -1).tolist()}

        @scenario
        def http():
            # LLM(tp=2) behind the server, on a group whose collectives
            # time out after IDLE_TIMEOUT_S: it idles longer, then serves
            short = g.split(2, timeout_s=float(sys.argv[6]))
            llm = LLM(params, cfg, n_slots=2, max_len=64, eos_id=-1, tp=2,
                      group=short)
            return roundtrip(llm)

        @scenario
        def silent():
            # each rank goes silent on a group of its own: rank 1's
            # follower (rank 0 never ticks) and rank 0's pump (rank 1
            # never steps) must both raise within the group's timeout
            a = g.split(2, timeout_s=float(sys.argv[6]))
            b = g.split(2, timeout_s=float(sys.argv[6]))
            kw = dict(n_slots=2, max_len=32, eos_id=-1, tp=2)
            la, lb = LLM(params, cfg, group=a, **kw), \
                LLM(params, cfg, group=b, **kw)
            t0 = time.monotonic()
            raised = None
            try:
                if rank == 1:
                    la.follow()
                else:
                    lb.start_pump()
                    lb.generate([[3, 4, 5]],
                                SamplingParams(max_new_tokens=3))
            except RuntimeError as e:
                raised = f"{e} / {e.__cause__!r}"
            seconds = time.monotonic() - t0
            if rank == 0:
                lb.stop_pump()
            g.agree(7, "after the silent groups")   # both ranks here again
            return {"raised": raised, "seconds": seconds}

        @scenario
        def dense():
            # the dense layout composes with tp: each slot's max_len row
            # holds the rank's kv heads
            return serve(kv_layout="dense", chunk_size=None)

        @scenario
        def preempt():
            # tests/test_tp_serving.py:327-365 at tp 2, a 4-block pool
            rng = np.random.default_rng(5)
            prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
                       for _ in range(3)]
            res = {}
            for mode in ("reduced", "softmax"):
                eng = ServeEngine(params, cfg, n_slots=2, max_len=64,
                                  head_mode=mode, tp=2, group=g, seed=7,
                                  kv_layout="paged", block_size=8,
                                  num_blocks=4)
                reqs = [Request(i, p.copy(),
                                params=SamplingParams(max_new_tokens=12))
                        for i, p in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                eng.run(max_iters=300)
                res[mode] = {"tokens": [list(r.generated) for r in reqs],
                             "preemptions": eng.stats["preemptions"],
                             "head_mode": eng.head_mode}
            return res

        @scenario
        def diverge():
            # rank 1 is handed another request than rank 0's: the group
            # must fail, on every rank, within its timeout
            llm = LLM(params, cfg, n_slots=2, max_len=32, tp=2, group=g)
            p = [3, 4, 5] if rank == 0 else [3, 4, 6]
            try:
                llm.generate([p], SamplingParams(max_new_tokens=3))
            except RuntimeError as e:
                return {"raised": str(e)}
            return {"raised": None}

    if world == 4:
        @scenario
        def router():
            # tests/test_tp_serving.py:368-403: Router(replicas=2, tp=2),
            # replica r the world ranks [2r, 2r + 2); then seeded TopK and
            # Temperature requests
            rng = np.random.default_rng(3)
            prompts = [rng.integers(0, cfg.vocab_size, 5 + 3 * i)
                       .astype(np.int32) for i in range(4)]
            router = Router(params, cfg, replicas=2, tp=2, group=g,
                            n_slots=2, max_len=48, eos_id=-1)
            outs = router.generate([p.copy() for p in prompts], [
                SamplingParams(max_new_tokens=6, seed=100 + i)
                for i in range(4)])
            pay = router.stats_payload()
            served = [r.served for r in router.replicas]
            mixed = router.generate([p.copy() for p in prompts], [
                SamplingParams(max_new_tokens=6, top_k=4, temperature=0.8,
                               seed=200 + i) if i % 2 else
                SamplingParams(max_new_tokens=6, temperature=0.7,
                               seed=200 + i) for i in range(4)])
            # replica 1 drained: new work goes to replica 0 alone
            router.drain(1, wait=True)
            drained = router.generate([p.copy() for p in prompts[:2]], [
                SamplingParams(max_new_tokens=6, seed=100 + i)
                for i in range(2)])
            after = [r.served for r in router.replicas]
            router.undrain(1)
            return {"tokens": [list(o.token_ids) for o in outs],
                    "mixed": [list(o.token_ids) for o in mixed],
                    "drained": [list(o.token_ids) for o in drained],
                    "served_after_drain": after,
                    "served": served, "index": router.index,
                    "engine_tp": router.engine.tp,
                    "engine_ranks": list(router.sub.ranks),
                    "emitted": pay["engine"]["emitted_tokens"],
                    "per_replica": [r["engine"]["emitted_tokens"]
                                    for r in pay["replicas"]],
                    "completed": pay["engine"]["completed"]}

        @scenario
        def router_http():
            router = Router(params, cfg, replicas=2, tp=2, group=g,
                            n_slots=2, max_len=64, eos_id=-1)
            return roundtrip(router)

        @scenario
        def head_only():
            # tests/test_distributed.py:147-180: the trunk whole on 4
            # ranks, the head sharded, ids 10 and 200 tied across shards
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab_size, size=7)
                       .astype(np.int32) for _ in range(3)]
            eng = ServeEngine(tie, cfg, n_slots=2, max_len=32, eos_id=1,
                              head_mode="sharded", group=g)
            reqs = [Request(i, p.copy(), 4) for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            return {"tokens": [list(r.generated) for r in reqs],
                    "tp": eng.tp, "trunk_heads": eng.cfg.n_heads}

    # -- training on a (data, model) mesh of this world's ranks: the
    # bridged qwen3 smoke tree, the global batches of TokenPipeline
    # (train.json: the shape, AdamW's settings, a loss mask)
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.parallel.pipeline import pipeline_apply
    from unittest import mock

    with open(f"{d}/train.json") as f:
        tc = json.load(f)
    tshape = ShapeSpec("t", tc["seq"], tc["batch"], "train")

    def opt_cfg(**kw):
        return opt_mod.AdamWConfig(lr=tc["lr"], warmup_steps=tc["warmup"],
                                   total_steps=tc["total"], **kw)

    def save_tree(name, t):
        np.savez(f"{d}/{name}.npz", **{tree_mod.key(p): x.detach().numpy()
                                       for p, x in tree_mod.items(t)})

    def fresh(mesh):
        # the rank's own copy of its slice (a row slice is a view)
        return tree_mod.map_tree(lambda _, t: t.clone(), mesh.shard(params))

    def mesh_bytes(mesh):
        out = {}
        for grp in (mesh.data, mesh.model, mesh.kv):
            for k, n in (grp.bytes if grp is not None else {}).items():
                out[k] = out.get(k, 0) + n
        return out

    def train_mesh(D, M):
        mesh = steps_mod.make_mesh(cfg, g, D, M)
        tag = f"{D}x{M}"
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                             tshape, "cpu", data=D, d=mesh.plan.d)
        res = {"d": mesh.plan.d, "m": mesh.plan.m, "rows": pipe.rows.tolist(),
               "data_ranks": list(mesh.data.ranks) if mesh.data else None,
               "model_ranks": list(mesh.model.ranks) if mesh.model else None}
        # the rank's state bytes (its cut of the masters and AdamW's m /
        # v, and the step)
        mine = fresh(mesh)
        ost = opt_mod.init_state(opt_cfg(), mine)
        res["state_bytes"] = [sum(t.numel() * t.element_size()
                                  for t in tree_mod.leaves(x))
                              for x in (mine, ost)]
        # the first step's gradients, each rank's part, then made whole
        # (the qk-norm parts summed over the model group) and gathered;
        # the data group's all-reduced and reduce-scattered gradients'
        # shapes recorded
        loss, grads = steps_mod.rank_grads(mine, mesh.cfg, pipe.batch(0),
                                           data=mesh.data, dcut=mesh.dcut)
        res["q_norm_part"] = grads["decoder"][0]["slot0"]["attn"][
            "q_norm"].tolist()
        if mesh.data is not None:
            seen = {"reduced": [], "scattered": []}
            ar, rs = mesh.data.all_reduce_sum, mesh.data.reduce_scatter_sum

            def reduced(x, kind):
                if kind == "grad":
                    seen["reduced"].append(list(x.shape))
                return ar(x, kind)

            def scattered(x, axis, kind):
                seen["scattered"].append(list(x.shape))
                return rs(x, axis, kind)
            with mock.patch.object(mesh.data, "all_reduce_sum", reduced), \
                    mock.patch.object(mesh.data, "reduce_scatter_sum",
                                      scattered):
                steps_mod.loss_and_grads(fresh(mesh), mesh.cfg,
                                         pipe.batch(0), mesh)
            res["grad_collectives"] = seen
        steps_mod.complete_grads(loss, grads, mesh)
        whole = mesh.gather(grads)
        if rank == 0:
            save_tree(f"grads_{tag}", whole)
        # three AdamW steps, the bytes of each by kind
        state = {"params": mine, "opt": ost}
        step = steps_mod.make_train_step(mesh.cfg, opt_cfg(), mesh)
        losses, norms = [], []
        for s in range(tc["steps"]):
            b0 = mesh_bytes(mesh)
            state, m = step(state, pipe.batch(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            res["step_bytes"] = {k: n - b0.get(k, 0)
                                 for k, n in mesh_bytes(mesh).items()
                                 if n - b0.get(k, 0)}
        res.update(losses=losses, norms=norms)
        # a masked loss whose token counts differ between the data shards
        mask = torch.tensor(tc["mask"], dtype=torch.float32)[pipe.rows]
        mb = dict(pipe.batch(0), loss_mask=mask)
        mloss, mgrads = steps_mod.loss_and_grads(fresh(mesh), mesh.cfg, mb,
                                                 mesh)
        res.update(masked_loss=float(mloss), mask_count=float(mask.sum()))
        mwhole = mesh.gather(mgrads)
        if rank == 0:
            save_tree(f"masked_{tag}", mwhole)
        # the factored second moment: taken at model 1, refused under a
        # split model axis
        try:
            fstep = steps_mod.make_train_step(
                mesh.cfg, opt_cfg(factored=True), mesh)
            fp = fresh(mesh)
            fstate = {"params": fp,
                      "opt": opt_mod.init_state(opt_cfg(factored=True), fp)}
            fl = []
            for s in range(2):
                fstate, fm = fstep(fstate, pipe.batch(s))
                fl.append([float(fm["loss"]), float(fm["grad_norm"])])
            res["factored"] = {"steps": fl}
        except ValueError as e:
            res["factored"] = {"refused": str(e)}
        return res, mesh

    if world == 2:
        for D, M in ((1, 2), (2, 1)):
            scenario(lambda D=D, M=M: train_mesh(D, M)[0],
                     f"train_{D}x{M}")

    if world == 4:
        @scenario
        def train_2x2():
            res, mesh = train_mesh(2, 2)
            # launch.train.train on the mesh for 2 steps, a checkpoint
            # of the whole layout written at step 2 by rank 0; every rank
            # then restores it straight into its own slice
            st, losses = train_mod.train(
                cfg, tshape, opt_cfg(), mesh=mesh, steps=2,
                ckpt_dir=f"{d}/ckpt", ckpt_every=2, params=params,
                log=lambda *a: None)
            g.agree(2, "the checkpoint written")
            back = CheckpointManager(f"{d}/ckpt").restore(
                2, steps_mod.train_state_struct(cfg, opt_cfg()), cfg=cfg,
                split=mesh.split, dcut=mesh.dcut)
            res["train_losses"] = losses
            res["restored_equal"] = all(
                torch.equal(a, b) for a, b in zip(tree_mod.leaves(st),
                                                  tree_mod.leaves(back)))
            return res

        @scenario
        def pipeline():
            # GPipe over the 4 ranks: stage s is tanh(x @ W_s + b_s)
            rng = np.random.default_rng(21)
            ws = rng.standard_normal((4, 8, 8)).astype(np.float32) * 0.5
            bs = rng.standard_normal((4, 8)).astype(np.float32) * 0.1
            x = rng.standard_normal((8, 8)).astype(np.float32)
            b0 = dict(g.bytes)
            y = pipeline_apply(
                lambda p, h: torch.tanh(h @ p[0] + p[1]),
                (torch.from_numpy(ws[rank]), torch.from_numpy(bs[rank])),
                torch.from_numpy(x), g, n_microbatches=4)
            return {"y": y.tolist(),
                    "pipe_bytes": g.bytes.get("pipe", 0) - b0.get("pipe", 0)}

    # -- the moe, ssm, hybrid, vlm and encdec families trained on a mesh:
    # each one's bridged tree (the serving scenarios' <arch>.pkl) on
    # train.json's global batches, a data shard the rows of its block --
    # the first step's gradients made whole and gathered (rank 0 writes
    # them), then three AdamW steps, the last one's bytes by kind; qwen3
    # at 1x4, its 2 kv heads copied; and the vlm and encdec smoke configs
    # with a vocabulary that does not divide by M (<arch>@<V>)

    class Rows:
        # the global batch's rows of data shard d of D: a vlm or encdec
        # config's stub embeddings of those rows too (TokenPipeline at
        # data=D draws a shard's stub embeddings afresh, as the
        # reference's does, which the single-device step never sees)
        def __init__(self, fcfg, D, d):
            self.pipe = TokenPipeline(DataConfig(vocab_size=fcfg.vocab_size),
                                      fcfg, tshape, "cpu")
            self.lo, self.n = d * tc["batch"] // D, tc["batch"] // D

        def batch(self, step):
            return {k: v[self.lo:self.lo + self.n]
                    for k, v in self.pipe.batch(step).items()}

    def family_mesh(arch, D, M):
        fcfg = cfg if arch == "qwen3-0.6b" else arch_cfgs[arch]
        host = params if arch == "qwen3-0.6b" else \
            weights.from_numpy_params(arch_tree(arch), fcfg, "cpu")
        mesh = steps_mod.make_mesh(fcfg, g, D, M)
        tag = f"{arch}_{D}x{M}"
        pipe = Rows(fcfg, D, mesh.plan.d)
        res = {"d": mesh.plan.d, "m": mesh.plan.m,
               "vocab": list(mesh.split.vocab) if mesh.split else None,
               "kv_ranks": list(mesh.kv.ranks) if mesh.kv else None}
        mine = tree_mod.map_tree(lambda _, t: t.clone(), mesh.shard(host))
        loss, grads = steps_mod.rank_grads(mine, mesh.cfg, pipe.batch(0),
                                           data=mesh.data, dcut=mesh.dcut)
        if mesh.kv is not None:
            # a copied kv head's wk gradient before its sum: this rank's
            # q heads' part
            attn = [sl for seg in grads["decoder"] for sl in seg.values()
                    if "attn" in sl][0]["attn"]
            res["wk_part"] = attn["wk"].tolist()
        steps_mod.complete_grads(loss, grads, mesh)
        whole = mesh.gather(grads)
        if rank == 0:
            save_tree(f"grads_{tag}", whole)
        state = {"params": mine, "opt": opt_mod.init_state(opt_cfg(), mine)}
        step = steps_mod.make_train_step(mesh.cfg, opt_cfg(), mesh)
        losses, norms = [], []
        for s in range(tc["steps"]):
            b0 = mesh_bytes(mesh)
            state, m = step(state, pipe.batch(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            res["step_bytes"] = {k: n - b0.get(k, 0)
                                 for k, n in mesh_bytes(mesh).items()
                                 if n - b0.get(k, 0)}
        res.update(losses=losses, norms=norms)
        return res, mesh, state, host, pipe

    def trap(arch, name, fn, leaf, module=comm):
        # the gathered first-step gradient of ``leaf`` (keys from the
        # root where the first is a root key, else from the decoder's
        # first slot) with ``module``'s ``name`` swapped for ``fn``: the
        # fix taken out
        fcfg = arch_cfgs[arch]
        host = weights.from_numpy_params(arch_tree(arch), fcfg, "cpu")
        mesh = steps_mod.make_mesh(fcfg, g, 1, world)
        pipe = TokenPipeline(DataConfig(vocab_size=fcfg.vocab_size), fcfg,
                             tshape, "cpu")
        mine = tree_mod.map_tree(lambda _, t: t.clone(), mesh.shard(host))
        with mock.patch.object(module, name, fn):
            _, grads = steps_mod.loss_and_grads(mine, mesh.cfg,
                                                pipe.batch(0), mesh)
        node = mesh.gather(grads)
        if leaf[0] not in node:
            node = node["decoder"][0]["slot0"]
        for k in leaf:
            node = node[k]
        return node.tolist()

    if world == 2:
        for arch in FAMILY_TRAIN:
            for D, M in ((1, 2), (2, 1)):
                if (arch, M) != (ENCDEC, 2):     # ckpt_1x2's below
                    scenario(lambda arch=arch, D=D, M=M: family_mesh(
                        arch, D, M)[0], f"train_{arch}_{D}x{M}")

        @scenario
        def rwkv_ckpt():
            # rwkv6's 1x2 state after its steps: written whole, and each
            # rank's live slice beside it
            _, mesh, state, _, _ = family_mesh("rwkv6-7b", 1, 2)
            train_mod.save_state(CheckpointManager(f"{d}/ckpt_rwkv"),
                                 tc["steps"], state, mesh)
            save_tree(f"rwkv_state_{rank}", state)
            return {}

        @scenario
        def trap_router():
            return trap("phi3.5-moe-42b-a6.6b", "share_grad",
                        lambda x, group: x, ("moe", "router"))

        @scenario
        def trap_kv():
            return trap("rwkv6-7b", "sum_to_group", comm.reduce_from_group,
                        ("w_k_cm",))

        @scenario
        def trap_whole_head():
            # a whole vocabulary's head behind the copy of a cut one's
            return trap(VLM + "@255", "logits_fn", lm.local_logits,
                        ("final_norm",), module=lm)

        @scenario
        def trap_cross():
            # the encoder's output read by the xattn layers without its
            # "cross" copy
            copy = comm.copy_to_group

            def no_cross(x, group, kind):
                return x if kind == "cross" else copy(x, group, kind)
            return trap(ENCDEC, "copy_to_group", no_cross,
                        ("encoder", 0, "slot0", "attn", "wq"))

        def ckpt_1x2(arch):
            # the arch at 1x2, then launch.train.train on the mesh for 2
            # steps, the whole state checkpointed at step 2
            res, mesh, _, host, _ = family_mesh(arch, 1, 2)
            _, losses = train_mod.train(
                arch_cfgs[arch], tshape, opt_cfg(), mesh=mesh, steps=2,
                ckpt_dir=f"{d}/ckpt_{arch}", ckpt_every=2, params=host,
                log=lambda *a: None)
            return dict(res, train_losses=losses)

        for arch in (ENCDEC, VLM + "@255"):
            scenario(functools.partial(ckpt_1x2, arch), f"train_{arch}_1x2")

    if world == 4:
        for arch, D, M in (("rwkv6-7b", 2, 2), ("recurrentgemma-2b", 2, 2),
                           ("qwen3-0.6b", 1, 4), (VLM, 2, 2), (ENCDEC, 2, 2),
                           (ENCDEC + "@258", 1, 4)):
            scenario(lambda arch=arch, D=D, M=M: family_mesh(
                arch, D, M)[0], f"train_{arch}_{D}x{M}")

        def train_phi_2x2():
            arch = "phi3.5-moe-42b-a6.6b"
            res, mesh, _, host, _ = family_mesh(arch, 2, 2)
            # launch.train.train on the mesh for 2 steps, the whole state
            # checkpointed at step 2
            _, losses = train_mod.train(
                arch_cfgs[arch], tshape, opt_cfg(), mesh=mesh, steps=2,
                ckpt_dir=f"{d}/ckpt_phi", ckpt_every=2, params=host,
                log=lambda *a: None)
            res["train_losses"] = losses
            return res

        scenario(train_phi_2x2, "train_phi3.5-moe-42b-a6.6b_2x2")

    with open(f"{d}/out{world}_{rank}.json", "w") as f:
        json.dump(out, f)
    g.close()
''')


# One rank of a torchrun launch (RANK, WORLD_SIZE, LOCAL_RANK,
# MASTER_ADDR/PORT in its environment): the CLI's batch run at --tp 2,
# then LLM.from_arch(tp=2) on a second port, both building their group
# from that environment (comm.Group.from_env over env://).
TORCHRUN_SCRIPT = textwrap.dedent(r'''
    import contextlib, io, json, os, sys
    import torch
    from repro_torch.launch import serve
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    torch.set_num_threads(1)
    d, rank = sys.argv[1], int(os.environ["RANK"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        snap = serve.main(sys.argv[3:] + ["--tp", "2"])
    os.environ["MASTER_PORT"] = sys.argv[2]
    llm = LLM.from_arch("qwen3-0.6b", device="cpu", tp=2, n_slots=3,
                        max_len=64)
    outs = llm.generate(json.loads(os.environ["PROMPTS"]), [
        SamplingParams(max_new_tokens=6),
        SamplingParams(max_new_tokens=6, top_k=4, temperature=0.8, seed=1)])
    res = {"printed": printed.getvalue(), "snap": snap,
           "tokens": [list(o.token_ids) for o in outs],
           "tp": llm.engine.tp, "head_mode": llm.engine.head_mode,
           "backend": llm.engine.group.backend}
    llm.engine.group.close()
    with open(f"{d}/torchrun{rank}.json", "w") as f:
        json.dump(res, f)
''')
CLI_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new", "6"]
PROMPTS = [[5, 11, 7, 3], [2, 9, 4]]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, d: Path):
    """Start ``world`` rank processes of RANK_SCRIPT; returns them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    script = d / "rank.py"
    script.write_text(RANK_SCRIPT)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(d),
         str(GROUP_TIMEOUT_S), str(IDLE_S[world]), str(IDLE_TIMEOUT_S)],
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs, world: int, d: Path) -> list:
    """Wait on each rank with its own timeout (killing the lot on one
    miss) and read every rank's results."""
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} of {world} ran past {RANK_TIMEOUT_S} s")
        assert p.returncode == 0, f"rank {r} of {world}: {err[-3000:]}"
    return [json.loads((d / f"out{world}_{r}.json").read_text())
            for r in range(world)]


def _jax_serve(params, spec_k=0, host_stride=None, **kw):
    kw = {"chunk_size": 8, **kw}
    eng = JEngine(params, JCFG, n_slots=3, max_len=64, head_mode="reduced",
                  host_stride=host_stride, seed=7, **kw)
    prompts = [np.arange(2, 2 + n, dtype=np.int32) % JCFG.vocab_size
               for n in (5, 9, 13, 4)]
    reqs = []
    for r, p in enumerate(prompts):
        mixed = spec_k == 0 and r == 1
        sp = JSP(max_new_tokens=10, spec_k=spec_k, top_k=4 if mixed else 1,
                 temperature=0.8 if mixed else 1.0, seed=r)
        reqs.append(JRequest(rid=r, prompt=p.copy(), params=sp))
        eng.submit(reqs[-1])
    eng.run(max_iters=200)
    return [list(r.generated) for r in reqs]


MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
# the recurrent and vlm families under tp, at smoke size
FAMILY_ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "internvl2-26b")


def _jax_arch(arch, params):
    """The rank script's ``serve_arch`` on the JAX engine, unsharded; a
    moe config on its dense layout (the reference's byte-identity
    oracle, which its paged layout departs from behind a
    capacity-dropping layer: ``tests/test_torch_moe.py``)."""
    cfg = j_smoke(J_ARCHS[arch])
    eng = JEngine(params, cfg, n_slots=3, max_len=48, seed=7, eos_id=-1,
                  kv_layout="dense" if cfg.moe is not None else "paged")
    reqs = []
    for r, n in enumerate((5, 9, 13, 4)):
        p = (np.arange(2, 2 + n, dtype=np.int32) * 7) % cfg.vocab_size
        sp = JSP(max_new_tokens=10, top_k=4 if r == 1 else 1,
                 temperature=0.8 if r == 1 else 1.0, seed=r)
        reqs.append(JRequest(rid=r, prompt=p, params=sp))
        eng.submit(reqs[-1])
    eng.run(max_iters=200)
    return [list(r.generated) for r in reqs]


def _jax_preempt(params):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JCFG.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    eng = JEngine(params, JCFG, n_slots=2, max_len=64, head_mode="softmax",
                  seed=7, kv_layout="paged", block_size=8)
    reqs = [JRequest(i, p.copy(), params=JSP(max_new_tokens=12))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=300)
    return [list(r.generated) for r in reqs]


def _jax_tie(params):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, size=7).astype(np.int32)
               for _ in range(3)]
    eng = JEngine(params, JCFG, n_slots=2, max_len=32, eos_id=1,
                  head_mode="reduced")
    reqs = [JRequest(i, p.copy(), 4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs]


def _jax_llm(params):
    """One unsharded JAX ``LLM``: the router scenario's greedy and mixed
    batches (tests/test_tp_serving.py:368-403) and the HTTP prompt."""
    from repro.serve.api import LLM as JLLM

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, JCFG.vocab_size, 5 + 3 * i).astype(np.int32)
               for i in range(4)]
    llm = JLLM(params, JCFG, n_slots=2, max_len=48, eos_id=-1)
    greedy = llm.generate([p.copy() for p in prompts],
                          [JSP(max_new_tokens=6, seed=100 + i)
                           for i in range(4)])
    mixed = llm.generate([p.copy() for p in prompts], [
        JSP(max_new_tokens=6, top_k=4, temperature=0.8, seed=200 + i)
        if i % 2 else JSP(max_new_tokens=6, temperature=0.7, seed=200 + i)
        for i in range(4)])
    http = JLLM(params, JCFG, n_slots=2, max_len=64, eos_id=-1).generate(
        [5, 11, 7, 3, 19, 2], JSP(max_new_tokens=5))[0]
    return {"router": [list(o.token_ids) for o in greedy],
            "router_mixed": [list(o.token_ids) for o in mixed],
            "http": list(http.token_ids)}


def _vlm_inputs():
    """The image-prefix prefill's operands: 16 token ids and 8 stub image
    embeddings (D 64) for each of 2 rows, numpy seed 12."""
    rng = np.random.default_rng(12)
    cfg = j_smoke(J_ARCHS["internvl2-26b"])
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 16))
            .astype(np.int32),
            "image": rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}


def _jax_vlm_prefix(params):
    """JAX ``lm.prefill`` with the image prefix: the last hidden state
    and the argmax of its logits."""
    cfg = j_smoke(J_ARCHS["internvl2-26b"])
    v = _vlm_inputs()
    h, _ = jlm.prefill(params, cfg, {"tokens": jnp.asarray(v["tokens"]),
                                     "image_embeds": jnp.asarray(v["image"])},
                       32)
    return {"h": np.asarray(h),
            "argmax": np.asarray(jnp.argmax(jlm.logits_fn(
                jlm.cast_params(params, cfg), cfg, h), -1)).tolist()}


def _head_inputs():
    """numpy-seeded head operands: h (8, 64) rows near one direction m,
    W (64, 256) whose ids 10 and 200 are both m -- an exact tie that wins
    every row by far (|m|^2 ~ 64 against a std of ~8 for the others) --
    the verify's (2, 4, 64) rows and draft ids, and a 16-id W for k 8
    over 4-id shards."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=64).astype(np.float32)
    h = (m + 0.1 * rng.normal(size=(8, 64))).astype(np.float32)
    w = rng.normal(size=(64, 256)).astype(np.float32)
    w[:, 10] = w[:, 200] = m
    ht = rng.normal(size=(2, 4, 64)).astype(np.float32)
    ids = np.argmax(np.einsum("btd,dv->btv", ht, w), -1)
    cand = ids[:, :3].astype(np.int32).copy()
    cand[1, 1] = (cand[1, 1] + 1) % 256        # row 1 accepts one draft
    return dict(h=h, w=w, ht=ht, cand=cand,
                w_small=rng.normal(size=(64, 16)).astype(np.float32),
                bytes_shape=np.asarray([BYTES_SHAPE[k] for k in "bdvk"]))


def _psum_inputs(world=4):
    """Each rank's gradients ``g_a`` (3, 300), ``g_b`` (70,) and error
    buffers ``e_a``, ``e_b`` for ``compressed_psum`` at block 64 (the
    tails pad), f32, keyed ``<name>_<rank>``; ranks of either world read
    theirs."""
    rng = np.random.default_rng(9)
    out = {}
    for r in range(world):
        scale = rng.choice([1e-3, 1.0, 30.0], size=(3, 1))
        out[f"g_a_{r}"] = (rng.normal(size=(3, 300)) * scale).astype(
            np.float32)
        out[f"g_b_{r}"] = rng.normal(size=70).astype(np.float32)
        out[f"e_a_{r}"] = (rng.normal(size=(3, 300)) * 1e-3).astype(
            np.float32)
        out[f"e_b_{r}"] = (rng.normal(size=70) * 1e-3).astype(np.float32)
    return out


# training on a mesh: qwen3's smoke config, a global batch of 4 x 16 from
# TokenPipeline (DataConfig seed 0), AdamW as launch.train's CLI builds
# it (lr 3e-3, warmup 10, total 10; clip 1.0, which the first step's
# norm of ~4.3 crosses), 3 steps; the loss mask keeps 3 tokens of data
# shard 0's rows and 30 of shard 1's
TRAIN = dict(batch=4, seq=16, steps=3, lr=3e-3, warmup=10, total=10)
TRAIN_MESHES = {"1x2": 2, "2x1": 2, "2x2": 4}
LOSS_TOL = 1e-5               # f32, as tests/test_torch_train.py
GRAD_TOL = 5e-5               # of each leaf's largest |value|


def _train_mask():
    mask = np.zeros((TRAIN["batch"], TRAIN["seq"]), np.float32)
    mask[0, [1, 5]] = mask[1, 9] = 1                     # shard 0: 3
    mask[2:, 1:] = 1                                     # shard 1: 30
    return mask


# the reference's own runs on a (2, 2) mesh of forced host devices:
# repro.launch.train.train, 3 steps, of each arch in argv[3] (qwen3-0.6b
# and phi3.5-moe), their losses to argv[1]
JAX_MESH_SCRIPT = textwrap.dedent(r'''
    import json, sys
    import jax
    from repro.configs import ARCHS, smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch.mesh import make_mesh
    from repro.launch.train import train
    from repro.optim import optimizer as opt_mod

    t = json.loads(sys.argv[2])
    opt = opt_mod.AdamWConfig(lr=t["lr"], warmup_steps=t["warmup"],
                              total_steps=t["total"])
    out = {}
    for arch in json.loads(sys.argv[3]):
        _, losses = train(smoke_config(ARCHS[arch]),
                          ShapeSpec("t", t["seq"], t["batch"], "train"),
                          opt, mesh=make_mesh((2, 2), ("data", "model")),
                          steps=t["steps"], log=lambda *a: None)
        out[arch] = {"losses": losses, "devices": len(jax.devices())}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
''')
# the moe, ssm, hybrid, vlm and encdec families trained on a mesh (the
# rank script's family_mesh), each mesh of TRAIN_MESHES; qwen3 at 1x4
# beside them; and "<arch>@<V>", the vlm and encdec smoke configs with
# vocab_size V in both packages, at a mesh whose M does not divide V
# (255: neither 2 nor 4, internvl2-26b's case; 258: 2 and not 4,
# seamless-m4t-large-v2's), the vocabulary kept whole on every rank
PHI = "phi3.5-moe-42b-a6.6b"
VLM, ENCDEC = "internvl2-26b", "seamless-m4t-large-v2"
FAMILY_TRAIN = (PHI, "rwkv6-7b", "recurrentgemma-2b", VLM, ENCDEC)
WHOLE_VOCAB = {VLM + "@255": "1x2", ENCDEC + "@258": "1x4"}
FAMILY_MESHES = [(a, m) for a in FAMILY_TRAIN for m in TRAIN_MESHES] + [
    ("qwen3-0.6b", "1x4")] + list(WHOLE_VOCAB.items())


def _named(name):
    """(JAX smoke config, port smoke config) of ``"<arch>"`` or
    ``"<arch>@<V>"`` (vocab_size V in both)."""
    arch, _, v = name.partition("@")
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
    if v:
        jcfg = dataclasses.replace(jcfg, vocab_size=int(v))
        tcfg = dataclasses.replace(tcfg, vocab_size=int(v))
    return jcfg, tcfg


def _encdec_inputs():
    """seamless's split greedy decode: 2 rows of 8 token ids over 12
    stub source frames (D 64), 16 steps; numpy seed 13."""
    rng = np.random.default_rng(13)
    cfg = j_smoke(J_ARCHS[ENCDEC])
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 8))
            .astype(np.int32),
            "src": rng.standard_normal((2, 12, cfg.d_model))
            .astype(np.float32), "steps": np.int64(16)}


def _jax_encdec_greedy(params):
    """JAX ``lm.prefill`` over ``_encdec_inputs`` and greedy
    ``lm.decode_step``s on its cache, argmax of ``logits_fn``: the tokens
    (2, steps + 1)."""
    cfg = j_smoke(J_ARCHS[ENCDEC])
    v = _encdec_inputs()
    t, steps = v["tokens"].shape[1], int(v["steps"])
    cast = jlm.cast_params(params, cfg)

    def pick(h):
        return jnp.argmax(jlm.logits_fn(cast, cfg, h), -1).astype(jnp.int32)

    h, cache = jlm.prefill(params, cfg, {
        "tokens": jnp.asarray(v["tokens"]),
        "src_embeds": jnp.asarray(v["src"])}, t + steps)
    out = [pick(h)]
    step = jax.jit(lambda p, tok, c, pos: jlm.decode_step(p, cfg, tok, c,
                                                           pos))
    for i in range(steps):
        h, cache = step(params, out[-1][:, None], cache, jnp.int32(t + i))
        out.append(pick(h))
    return np.stack([np.asarray(o) for o in out], 1).tolist()


def _jax_train(jparams, arch="qwen3-0.6b"):
    """The JAX package's single-device step on the mesh runs' global
    batches of ``arch``: each step's loss and grad_norm and the first
    step's gradients; for qwen3 also the masked loss's and its
    gradients, and two steps of the factored second moment."""
    from repro.launch import steps as jsteps
    from repro.models import api as japi
    from repro.optim import optimizer as jopt
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    jcfg, tcfg = _named(arch)
    qwen = arch == "qwen3-0.6b"
    pipe = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size), tcfg,
                         ShapeSpec("t", TRAIN["seq"], TRAIN["batch"],
                                   "train"))
    batches = [{k: jnp.asarray(v.numpy()) for k, v in pipe.batch(s).items()}
               for s in range(TRAIN["steps"])]
    out = {}
    for name, factored in (("plain", False), ("factored", True))[
            :2 if qwen else 1]:
        opt = jopt.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                               total_steps=TRAIN["total"], factored=factored)
        step = jax.jit(jsteps.make_train_step(jcfg, opt))
        state = {"params": jparams, "opt": jopt.init_state(opt, jparams)}
        res = []
        for b in batches[:2 if factored else None]:
            state, m = step(state, b)
            res.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = res
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.train_loss(p, jcfg, b)))
    _, g = vg(jparams, batches[0])
    out["grads"] = jax.tree.map(np.asarray, g)
    if qwen:
        mloss, mg = vg(jparams, dict(batches[0],
                                     loss_mask=jnp.asarray(_train_mask())))
        out["masked_loss"], out["masked"] = float(mloss), jax.tree.map(
            np.asarray, mg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results and the JAX side's, computed once."""
    d = tmp_path_factory.mktemp("tp")
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    w = np.array(tree["embed"]).T.copy()             # tied head (D, V)
    w[:, 200] = w[:, 10]
    tie = dict(tree, embed=w.T.copy())
    for name, t in (("jtree.pkl", tree), ("tie.pkl", tie)):
        with open(d / name, "wb") as f:
            pickle.dump(t, f)
    heads = _head_inputs()
    np.savez(d / "heads.npz", **heads)
    np.savez(d / "psum.npz", **_psum_inputs())
    np.savez(d / "vlm.npz", **_vlm_inputs())
    np.savez(d / "encdec.npz", **_encdec_inputs())
    (d / "train.json").write_text(json.dumps(
        dict(TRAIN, mask=_train_mask().tolist())))
    (d / "jax_mesh.py").write_text(JAX_MESH_SCRIPT)
    jmesh = subprocess.Popen(
        [sys.executable, str(d / "jax_mesh.py"), str(d / "jax_mesh.json"),
         json.dumps(TRAIN), json.dumps(["qwen3-0.6b", PHI])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(
            os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    arch_params = {}
    for arch in MOE_ARCHS + FAMILY_ARCHS + (ENCDEC,) + tuple(WHOLE_VOCAB):
        arch_params[arch] = jlm.init_params(_named(arch)[0],
                                            jax.random.PRNGKey(0))
        with open(d / f"{arch}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, arch_params[arch]), f)
    procs = {world: _spawn(world, d) for world in (2, 4)}
    jtie = dict(jparams, embed=jnp.asarray(tie["embed"]))
    want = {"base": _jax_serve(jparams), "spec": _jax_serve(jparams, 4),
            **_jax_llm(jparams),
            "stride": _jax_serve(jparams, host_stride=4),
            "dense": _jax_serve(jparams, kv_layout="dense",
                                chunk_size=None),
            "preempt": _jax_preempt(jparams), "tie": _jax_tie(jtie),
            **{a: _jax_arch(a, arch_params[a])
               for a in MOE_ARCHS + FAMILY_ARCHS},
            "encdec_greedy": _jax_encdec_greedy(arch_params[ENCDEC]),
            "vlm_prefix": _jax_vlm_prefix(arch_params["internvl2-26b"]),
            "train": _jax_train(jparams),
            "family_train": {a: _jax_train(arch_params[a], a)
                             for a in FAMILY_TRAIN + tuple(WHOLE_VOCAB)}}
    got = {world: _wait(p, world, d) for world, p in procs.items()}
    try:
        _, err = jmesh.communicate(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        jmesh.kill()
        pytest.fail(f"the reference's (2, 2) mesh run ran past "
                    f"{RANK_TIMEOUT_S} s")
    assert jmesh.returncode == 0, err[-3000:]
    want["jax_mesh"] = json.loads((d / "jax_mesh.json").read_text())
    want["dir"] = d
    return got, want, heads


def _ok(res: dict, name: str):
    r = res[name]
    assert "error" not in r, r.get("trace", r.get("error"))
    return r


# -- the split ---------------------------------------------------------------
# the axis each split leaf is cut along (the rest are replicated); rows of
# a row-parallel weight, columns of a column-parallel one, channels of a
# per-channel leaf, gate blocks of the RG-LRU's block stacks
SPLIT_AXIS = {"embed": 0, "lm_head": -1, "wq": -1, "wk": -1, "wv": -1,
              "wo": -2, "w_gate": -1, "w_up": -1, "w_in": -1, "w_out": -2,
              "w_r": -1, "w_k": -1, "w_v": -1, "w_g": -1, "w_r_cm": -1,
              "w0": -1, "u": -1, "ln_x": -1, "wB": -1, "w_o": -2,
              "w_k_cm": -1, "w_v_cm": -2, "w_x": -1, "w_gate_in": -1,
              "conv_w": -1, "conv_b": -1, "b_a": -1, "b_i": -1, "lam": -1,
              "w_a": -3, "w_i": -3}


def _named_leaves(tree) -> list:
    """(key names, leaf) of every leaf of a numpy tree, in order."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out.append((tuple(str(getattr(e, "key", getattr(e, "idx", e)))
                          for e in path), leaf))
    return out


def _bridged(arch, seed=1):
    """(JAX smoke config, port smoke config, numpy tree) of ``arch``."""
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
    return jcfg, tcfg, jax.tree.map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ("qwen3-0.6b",) + FAMILY_ARCHS + (ENCDEC,))
def test_split_slices_concatenate_to_the_whole(arch, world):
    """shard_params' slices put back together along each rule's axis
    (``SPLIT_AXIS``) are the whole tree: columns (wq; wk, wv by kv head
    where they divide, else each rank a copy of the kv head its q heads
    read; the MLP's in-columns; rwkv6's r/k/v/g, w_r_cm and per-channel
    leaves; the RG-LRU's projections, conv and gates by channel), rows
    (wo, w_out, rwkv6's w_o and w_v_cm), gate blocks (w_a, w_i), the
    vocabulary (embed, an untied lm_head); an encoder's layers and each
    xattn layer's cross-attention by the same names; every other leaf
    (norms -- lnx and encoder_norm too --, rwkv6's mu_* and wA)
    replicated; every slice contiguous."""
    _, tcfg, tree = _bridged(arch)
    hd = tcfg.head_dim
    splits = [sharding.plan(tcfg, r, world) for r in range(world)]
    parts = [_named_leaves(shard_params(tree, tcfg, sp)) for sp in splits]
    for i, (names, whole) in enumerate(_named_leaves(tree)):
        mine = [p[i][1] for p in parts]
        key = names[-1]
        assert all(m.flags.c_contiguous for m in mine), names
        if key in ("wk", "wv") and tcfg.n_kv_heads % world:
            for sp, m in zip(splits, mine):       # copies of whole heads
                np.testing.assert_array_equal(
                    m, whole[..., sp.kv[0] * hd:sp.kv[1] * hd])
            continue
        if key not in SPLIT_AXIS:
            for m in mine:
                np.testing.assert_array_equal(m, whole)
            continue
        axis = SPLIT_AXIS[key]
        assert mine[0].shape[axis] * world == whole.shape[axis], names
        np.testing.assert_array_equal(np.concatenate(mine, axis=axis), whole)


@pytest.mark.parametrize("arch", ("qwen3-0.6b",) + FAMILY_ARCHS + (ENCDEC,))
def test_rank_param_count_is_what_shard_params_holds(arch):
    """``rank_param_count`` (the engine's memory check on the card) counts
    what ``shard_params`` keeps -- an encoder's layers and
    ``encoder_norm``, each xattn layer's cross-attention and ``lnx``
    included -- on every rank at tp 2 and 4 of the smoke tree and of its
    whole-vocabulary training split (V 255 / 258: ``train_plan``); and,
    at full width, what ``shard_leaf`` keeps of each leaf of
    ``param_shapes`` (zero-stride views, nothing allocated) on every
    rank of each model axis the config splits in training: rwkv6-7b,
    qwen3-0.6b, internvl2-26b and seamless-m4t-large-v2 at 2 / 4 (the
    last two's vocabulary whole where it does not divide),
    recurrentgemma-2b at 2."""
    from repro_torch.tree import map_tree
    from repro_torch.weights import param_shapes

    _, tcfg, tree = _bridged(arch)
    named = [(tcfg, tree)]
    if arch in (VLM, ENCDEC):
        wcfg = dataclasses.replace(tcfg, vocab_size=255)
        named.append((wcfg, map_tree(lambda _, s: np.broadcast_to(
            np.float32(0), s[0]), param_shapes(wcfg))))
    for cfg, t in named:
        for world in (2, 4):
            for r in range(world):
                sp = sharding.train_plan(cfg, r, 1, world).split
                held = sum(a.size for a in jax.tree.leaves(
                    shard_params(t, cfg, sp)))
                assert sharding.rank_param_count(cfg, sp) == held, (
                    cfg.vocab_size, world, r)
    full = get_config(arch)
    shapes = map_tree(lambda _, s: np.broadcast_to(np.float32(0), s[0]),
                      param_shapes(full))
    worlds = {"recurrentgemma-2b": (2,)}.get(arch, (2, 4))
    for world in worlds:
        for r in range(world):
            sp = sharding.train_plan(full, r, 1, world).split
            kept = map_tree(lambda path, x: sharding.shard_leaf(
                path, x, full, sp), shapes)
            held = sum(a.size for a in jax.tree.leaves(kept))
            assert sharding.rank_param_count(full, sp) == held, (world, r)


def test_plan_names_why_a_config_does_not_split():
    """recurrentgemma-2b splits at tp 2 (5 q heads over a copy of its one
    kv head, 5 gate blocks of 256 lru channels) and not at tp 4, whose
    10 / 4 heads are not whole; internvl2-26b's vocabulary (92,553 = 3 x
    30,851) divides by neither 2 nor 4, so neither package serves it
    under tp (the reference's sharded head, a shard_map over V, refuses
    it too), while training keeps it whole on every rank
    (``whole_vocab``, the reference's ``param_specs``); rwkv6-7b splits
    its 64 heads of 64 at tp 2 and 4; the encdec family plans (8 of 16
    heads a rank at 2, V / 2 ids) and the engine still refuses it."""
    rg = get_config("recurrentgemma-2b")
    sp = sharding.plan(rg, 1, 2)
    assert (sp.q, sp.kv, sp.chan) == ((5, 10), (0, 1), (1280, 2560))
    local = sharding.local_config(rg, sp)
    assert (local.n_heads, local.n_kv_heads, local.lru_width,
            local.d_ff) == (5, 1, 1280, 3840)
    with pytest.raises(ValueError, match=r"n_heads=10 does not divide by "
                       r"the world size 4: whole heads a rank, and the "
                       r"RG-LRU's 10 gate blocks"):
        sharding.plan(rg, 0, 4)
    vl = get_config("internvl2-26b")
    for world in (2, 4):
        with pytest.raises(ValueError, match=r"vocab_size=92553 does not "
                           rf"divide by the world size {world}: the sharded "
                           "head cuts V into equal slices"):
            sharding.plan(vl, 0, world)
        sp = sharding.plan(vl, world - 1, world, whole_vocab=True)
        assert sp.vocab == (0, 92553) and sp.q[1] == 48
    rw = get_config("rwkv6-7b")
    for world in (2, 4):
        sp = sharding.plan(rw, world - 1, world)
        per = 4096 // world
        assert sp.chan == (4096 - per, 4096) and sp.q == (64 - 64 // world,
                                                          64)
        assert sharding.local_config(rw, sp).d_ff == 14336 // world
    sm = get_config(ENCDEC)
    sp = sharding.plan(sm, 1, 2)
    assert (sp.q, sp.kv, sp.ff, sp.vocab) == ((8, 16), (8, 16),
                                              (4096, 8192), (128103, 256206))
    with pytest.raises(ValueError, match="encoder-decoder config is not "
                       "served"):
        TEngine({}, sharding.local_config(sm, sp), tp=2,
                group=types.SimpleNamespace(world=2, rank=1))


def test_split_keeps_whole_heads_and_copies_kv_heads():
    """tp 4 over 4 q / 2 kv heads: one q head a rank and a copy of the kv
    head it reads (ranks 0-1 kv head 0, ranks 2-3 kv head 1); q heads
    that do not divide by the world (4 over 8) raise."""
    hd = TCFG.head_dim
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(JCFG, jax.random.PRNGKey(1)))
    wk = tree["decoder"][0]["slot0"]["attn"]["wk"]
    for r in range(4):
        split = sharding.plan(TCFG, r, 4)
        local = sharding.local_config(TCFG, split)
        assert (local.n_heads, local.n_kv_heads, local.d_ff) == (1, 1, 32)
        kv = r // 2
        got = shard_params(tree, TCFG, split)["decoder"][0]["slot0"]["attn"]
        np.testing.assert_array_equal(got["wk"],
                                      wk[..., kv * hd:(kv + 1) * hd])
    assert sharding.plan(TCFG, 1, 2).kv == (1, 2)        # split at tp 2
    with pytest.raises(ValueError, match="n_heads=4 does not divide"):
        sharding.plan(TCFG, 0, 8)


def test_engine_refuses_a_group_of_another_world():
    group = types.SimpleNamespace(world=4, rank=0)
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(JCFG, jax.random.PRNGKey(1)))
    from repro_torch.weights import from_numpy_params
    params = from_numpy_params(tree, TCFG, "cpu")
    with pytest.raises(ValueError, match="process group of world 2"):
        TEngine(params, TCFG, tp=2, group=group)


def test_merges_of_slices_equal_the_unsharded_heads():
    """The merges alone, in one process: slices of a W run one at a time,
    their (val, idx) tables stacked and merged -- the unsharded heads'
    ids and values bit for bit on the CPU, the tie to the lower id."""
    heads = _head_inputs()
    h, w = torch.from_numpy(heads["h"]), torch.from_numpy(heads["w"])
    want_i, want_v = (torch.argmax(h @ w, -1).to(torch.int32),
                      torch.amax(h @ w, -1))
    for world in (2, 4, 8):
        per = w.shape[1] // world
        tabs = [trs.shard_argmax_table(h, w[:, r * per:(r + 1) * per],
                                       r * per) for r in range(world)]
        idx, val = trs.merge_argmax(torch.stack([t[0] for t in tabs]),
                                    torch.stack([t[1] for t in tabs]))
        assert torch.equal(idx, want_i) and torch.equal(val, want_v)
        assert (idx == 10).all()
        tk = [trs.shard_topk_table(h, w[:, r * per:(r + 1) * per], 6,
                                   v_lo=r * per, rank=r, ranks=world,
                                   vocab_size=256) for r in range(world)]
        vals, ids = trs.merge_topk(torch.stack([t[0] for t in tk]),
                                   torch.stack([t[1] for t in tk]), 6)
        ref_v, ref_i = trs.reduced_topk(h @ w, 6)
        assert torch.equal(ids, ref_i) and torch.equal(vals, ref_v)


# -- the engine against the JAX engine ---------------------------------------
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["base", "spec", "stride"])
def test_tp_engine_matches_jax(runs, world, name):
    """tp 2 / 4 over gloo == the JAX engine unsharded, token for token:
    chunk 8 with mixed samplers, spec_k=4 (the verify ran), host_stride=4
    (the body of tests/test_tp_serving.py:280-324); the engine upgraded
    its head to 'sharded', captured no graph and moved comparator and
    trunk bytes; on the card too it would run its step eagerly."""
    got, want, _ = runs
    res = _ok(got[world][0], name)
    assert res["tokens"] == want[name]
    assert res["tp"] == world and res["head_mode"] == "sharded"
    assert res["captures"] == 0 and res["would_graph"] is False
    assert res["bytes"]["head"] > 0 and res["bytes"]["trunk"] > 0
    if name == "spec":
        assert res["accepted"] > 0


@pytest.mark.parametrize("world,arch,name", [
    (2, MOE_ARCHS[0], "moe_phi"), (4, MOE_ARCHS[0], "moe_phi"),
    (2, MOE_ARCHS[1], "moe_llama4")])
def test_tp_moe_matches_unsharded_jax(runs, world, arch, name):
    """phi3.5-moe smoke (4 experts, top-2) at tp 2 and tp 4, llama4-maverick
    smoke (a shared expert, MoE every other layer) at tp 2: every rank
    holds E / world experts of the 4 and routes over all 4 at the global
    capacity, and its f32 tokens -- greedy rows and a TopK / Temperature
    row -- are the unsharded JAX engine's on every rank."""
    got, want, _ = runs
    for rank in range(world):
        res = _ok(got[world][rank], name)
        assert res["tokens"] == want[arch]
        per = 4 // world
        assert res["experts"] == [rank * per, (rank + 1) * per]
        assert res["held"] == per and res["num_experts"] == 4
        assert res["tp"] == world and res["head_mode"] == "sharded"
        assert res["paged"] and res["bytes"]["trunk"] > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tp_recurrent_and_vlm_families_match_unsharded_jax(runs, world,
                                                           arch):
    """rwkv6's, recurrentgemma-2b's and internvl2-26b's smoke configs at
    tp 2 and tp 4 over gloo: greedy rows and a TopK row, on bridged f32
    weights, are the unsharded JAX engine's tokens on every rank; the
    head upgraded to 'sharded' and the trunk's collectives ran; a
    recurrent rank holds its channels (rwkv6 4 / world heads of 16 in
    its wkv state, the RG-LRU 64 / world lru channels in its h) on the
    per-slot store and stays not ``spec_capable``, as unsharded; the vlm
    engine pages and may speculate."""
    got, want, _ = runs
    for rank in range(world):
        res = _ok(got[world][rank], f"family_{arch}")
        assert res["tokens"] == want[arch], rank
        assert res["tp"] == world and res["head_mode"] == "sharded"
        assert res["bytes"]["trunk"] > 0 and res["bytes"]["head"] > 0
        per = 64 // world
        if arch == "rwkv6-7b":
            assert res["chan"] == [rank * per, (rank + 1) * per]
            assert res["state"][2:] == [4 // world, 16, 16]
        elif arch == "recurrentgemma-2b":
            assert res["chan"] == [rank * per, (rank + 1) * per]
            assert res["state"][-1] == per
        recurrent = arch != "internvl2-26b"
        assert res["paged"] == res["spec_capable"] == (not recurrent)


def test_tp_vlm_image_prefix_prefill_matches_jax(runs):
    """``lm.prefill`` with internvl2's stub image embeddings at tp 2: the
    token embeddings summed over the ranks, then the image embeddings in
    the first 8 positions on every rank -- the last hidden state within
    1e-4 of JAX's ``lm.prefill`` and its argmax exact, on both ranks;
    without the images the state differs (the prefix was used)."""
    got, want, _ = runs
    ref = want["vlm_prefix"]
    for rank in range(2):
        res = _ok(got[2][rank], "vlm_prefix")
        np.testing.assert_allclose(np.asarray(res["h"]), ref["h"],
                                   atol=1e-4, rtol=1e-4)
        assert res["argmax"] == ref["argmax"]
        assert np.abs(np.asarray(res["plain"]) - ref["h"]).max() > 1e-2


def test_moe_split_follows_the_path():
    """The split of a moe tree: expert stacks along E (their names are
    the dense MLP's), the shared expert and a dense slot's MLP by columns
    and rows, the router and the norms whole; the slices put back
    together are the whole tree; ``local_config`` keeps ``moe`` whole;
    ``rank_param_count`` counts what ``shard_params`` keeps; experts that
    do not divide by the world raise."""
    for arch in MOE_ARCHS:
        jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
        tree = jax.tree.map(np.asarray,
                            jlm.init_params(jcfg, jax.random.PRNGKey(1)))
        for world in (2, 4):
            splits = [sharding.plan(tcfg, r, world) for r in range(world)]
            parts = [shard_params(tree, tcfg, sp) for sp in splits]
            slots = tree["decoder"][0]
            for name, slot in slots.items():
                lp = [p["decoder"][0][name] for p in parts]
                if "moe" in slot:
                    moe = slot["moe"]
                    for key in ("w_gate", "w_up", "w_out"):
                        assert lp[0]["moe"][key].shape[1] == 4 // world
                        np.testing.assert_array_equal(np.concatenate(
                            [p["moe"][key] for p in lp], axis=1), moe[key])
                    for p in lp:
                        np.testing.assert_array_equal(p["moe"]["router"],
                                                      moe["router"])
                    mlps = ([(moe["shared"], [p["moe"]["shared"]
                                              for p in lp])]
                            if "shared" in moe else [])
                else:
                    mlps = [(slot["mlp"], [p["mlp"] for p in lp])]
                for whole, cut in mlps:
                    for key, axis in (("w_gate", -1), ("w_up", -1),
                                      ("w_out", -2)):
                        np.testing.assert_array_equal(np.concatenate(
                            [c[key] for c in cut], axis=axis), whole[key])
            for sp, part in zip(splits, parts):
                local = sharding.local_config(tcfg, sp)
                assert local.moe == tcfg.moe and local.shard is sp
                held = sum(a.size for a in jax.tree.leaves(part))
                assert sharding.rank_param_count(tcfg, sp) == held
    wide = dataclasses.replace(
        smoke_config(get_config(MOE_ARCHS[0])),
        moe=dataclasses.replace(smoke_config(get_config(
            MOE_ARCHS[0])).moe, num_experts=6))
    with pytest.raises(ValueError, match="num_experts=6 does not divide"):
        sharding.plan(wide, 0, 4)


def test_tp_dense_layout_matches_jax(runs):
    """tp 2 on the dense layout (each slot's max_len row holding the
    rank's kv heads; one-shot admission), mixed samplers: the JAX dense
    engine's tokens."""
    got, want, _ = runs
    res = _ok(got[2][0], "dense")
    assert res["tokens"] == want["dense"]
    assert res["head_mode"] == "sharded" and res["captures"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same_outputs(runs, world):
    got, _, _ = runs
    for name in ("base", "spec", "stride", "heads"):
        first = _ok(got[world][0], name)
        for r in range(1, world):
            other = _ok(got[world][r], name)
            for key in ("tokens", "argmax", "topk_ids", "verify_ids"):
                assert other.get(key) == first.get(key), (name, r, key)


def test_tp_forced_preemption_matches_jax_softmax(runs):
    """tp 2 on a 4-block pool (preemption and re-prefill): sharded ==
    reduced == softmax, the JAX softmax engine's streams."""
    got, want, _ = runs
    res = _ok(got[2][0], "preempt")
    assert res["reduced"]["head_mode"] == "sharded"
    assert res["reduced"]["tokens"] == want["preempt"]
    assert res["softmax"]["tokens"] == want["preempt"]
    assert res["reduced"]["preemptions"] >= 1


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_the_reference_mean(runs, world):
    """``optim.compression.compressed_psum`` over the group's ranks: the
    synced gradient is the mean over ranks of the reference's
    ``decompress(compress(g_r + e_r))`` (bitwise at world 2, where the
    sum of two is one rounding; at world 4, whose gloo sum order is its
    own, within three f32 roundings of the terms' |sum|), on every rank,
    and each rank's new error buffer is the reference's residual (within
    one ulp of its block's scale)."""
    from repro.optim import compression as jcomp

    got, _, _ = runs
    ps = _psum_inputs()
    want, resid, scales = [], [], []
    for r in range(world):
        leaves = []
        for name, shape in (("a", (3, 300)), ("b", (70,))):
            x = jnp.asarray(ps[f"g_{name}_{r}"] + ps[f"e_{name}_{r}"])
            q, sc, err = jcomp.compress(x, 64)
            leaves.append((np.asarray(jcomp.decompress(q, sc, shape)),
                           np.asarray(err), np.repeat(np.asarray(sc)[:, 0],
                                                      64)[:x.size]))
        want.append([w for w, _, _ in leaves])
        resid.append([e for _, e, _ in leaves])
        scales.append([s for _, _, s in leaves])
    mean = [sum(w[i] for w in want) / np.float32(world) for i in range(2)]
    for r, res in enumerate(got[world]):
        c = _ok(res, "compressed")
        for i in range(2):
            synced = np.asarray(c["synced"][i], np.float32)
            if world == 2:
                np.testing.assert_array_equal(synced, mean[i])
            else:   # another order of 4 terms: 3 roundings of their |sum|
                bound = 3 * 2.0 ** -23 * sum(np.abs(w[i]) for w in want) \
                    / world
                assert np.all(np.abs(synced - mean[i]) <= bound), (r, i)
            err = np.asarray(c["err"][i], np.float32).reshape(-1)
            assert np.all(np.abs(err - resid[r][i].reshape(-1))
                          <= np.spacing(scales[r][i])), (r, i)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_heads_match_jax(runs, world):
    """sharded_reduced_head / _topk / _verify_draft over the ranks'
    slices (and distributed_argmax over their logit slices) == the JAX
    package's fused_reduced_head, fused_reduced_topk and
    ops.verify_draft on the whole W; the exact tie of ids 10 and 200
    (shards 0 and 3 at tp 4, 0 and 1 at tp 2) resolves to 10."""
    got, _, heads = runs
    res = _ok(got[world][0], "heads")
    h, w = jnp.asarray(heads["h"]), jnp.asarray(heads["w"])
    want = np.asarray(jrs.fused_reduced_head(h, w))
    assert res["argmax"] == res["dist_argmax"] == want.tolist()
    assert set(res["argmax"]) == {10}
    jv, ji = jrs.fused_reduced_topk(h, w, 4)
    assert res["topk_ids"] == np.asarray(ji).tolist()
    np.testing.assert_allclose(res["topk_vals"], np.asarray(jv), rtol=RTOL)
    assert [row[:2] for row in res["topk_ids"]] == [[10, 200]] * 8
    vi, va = jops.verify_draft(jnp.asarray(heads["ht"]), w,
                               jnp.asarray(heads["cand"]))
    assert res["verify_ids"] == np.asarray(vi).tolist()
    assert res["accept"] == np.asarray(va).tolist() == [3, 1]


def test_sharded_topk_shard_narrower_than_k(runs):
    """k 8 over a 16-id W at tp 4: 4 ids a shard, each padded with -inf
    sentinels at unique out-of-vocabulary ids -- the merge is the JAX top-k
    of the whole W, with no sentinel in it."""
    got, _, heads = runs
    res = _ok(got[4][0], "heads")
    jv, ji = jrs.fused_reduced_topk(jnp.asarray(heads["h"]),
                                    jnp.asarray(heads["w_small"]), 8)
    assert res["narrow_ids"] == np.asarray(ji).tolist()
    np.testing.assert_allclose(res["narrow_vals"], np.asarray(jv),
                               rtol=RTOL)
    assert max(max(r) for r in res["narrow_ids"]) < 16


def test_head_only_sharded_engine_with_a_cross_shard_tie(runs):
    """head_mode='sharded' on a group of 4 with tp None: the trunk whole,
    the head split; ids 10 and 200 tied across shards -- the JAX engine's
    tokens, 200 never emitted (tests/test_distributed.py:147-180)."""
    got, want, _ = runs
    res = _ok(got[4][0], "head_only")
    assert res["tp"] == 1 and res["trunk_heads"] == TCFG.n_heads
    assert res["tokens"] == want["tie"]
    assert all(200 not in t for t in res["tokens"])


@pytest.mark.parametrize("world", [2, 4])
def test_comparator_head_bytes_are_o_k_not_o_v(runs, world):
    """The byte counter at B 8, D 64, V 4,096, k 4: the top-k comparator
    moves B * ranks * k (val, idx) pairs -- under a quarter of one f32
    logit sweep B * V * 4, as tests/test_tp_serving.py:406-430 asserts on
    compiled HLO -- and the argmax one pair a row a rank; the Temperature
    head's gather moves the sweep itself."""
    got, _, _ = runs
    res = _ok(got[world][0], "head_bytes")
    b, v, k = BYTES_SHAPE["b"], BYTES_SHAPE["v"], BYTES_SHAPE["k"]
    sweep = b * v * 4
    assert res["topk"] == {"head": b * world * k * 8}
    assert res["topk"]["head"] < sweep / 4
    assert res["argmax"] == {"head": b * world * 8}
    assert res["logits"] == {"logits": sweep}


def test_plan_digest_fails_a_diverged_group(runs):
    """Rank 1 handed another request than rank 0's: both ranks raise
    RuntimeError at the digest, and neither hangs (the ranks finished
    within their timeouts)."""
    got, _, _ = runs
    for r in range(2):
        res = _ok(got[2][r], "diverge")
        assert res["raised"] and "diverged" in res["raised"]


def test_cli_and_from_arch_under_torchrun_environment(tmp_path):
    """The entry points a user launches under torchrun: two ranks with
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT in their
    environment run ``launch.serve.main([..., "--tp", "2"])`` -- rank 0
    prints, rank 1 returns silently, both serve the batch the unsharded
    CLI serves, step for step -- and then ``LLM.from_arch(tp=2)``, whose
    tokens are the unsharded ``from_arch``'s: one seed names one host
    tree (``weights.seeded_params``) on every device and every tp."""
    from repro_torch.launch import serve
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    script = tmp_path / "torchrun_rank.py"
    script.write_text(TORCHRUN_SCRIPT)
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path), str(ports[1])]
        + CLI_ARGS, env=dict(
            os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
            RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(ports[0]), PROMPTS=json.dumps(PROMPTS)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    want_snap = serve.main(CLI_ARGS)
    want = LLM.from_arch("qwen3-0.6b", device="cpu", n_slots=3,
                         max_len=64).generate(PROMPTS, [
        SamplingParams(max_new_tokens=6),
        SamplingParams(max_new_tokens=6, top_k=4, temperature=0.8, seed=1)])
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"torchrun rank {r} ran past {RANK_TIMEOUT_S} s")
        assert p.returncode == 0, f"torchrun rank {r}: {err[-3000:]}"
    got = [json.loads((tmp_path / f"torchrun{r}.json").read_text())
           for r in range(2)]
    assert "tp=2 world=2 backend=gloo" in got[0]["printed"]
    assert "served=4" in got[0]["printed"] and got[1]["printed"] == ""
    counts = ("completed", "prefills", "decode_steps", "iterations",
              "emitted_tokens", "prefill_tokens", "preemptions")
    for res in got:
        assert res["snap"]["tp"] == 2
        assert {k: res["snap"][k] for k in counts} \
            == {k: want_snap[k] for k in counts}
        assert res["tp"] == 2 and res["head_mode"] == "sharded"
        assert res["backend"] == "gloo"
        assert res["tokens"] == [list(o.token_ids) for o in want]


# -- the control plane: Router(tp > 1) and HTTP under --tp -------------------
def test_router_over_rank_groups_matches_unsharded_jax_llm(runs):
    """Router(replicas=2, tp=2) over a world of 4 (replica r the ranks
    [2r, 2r + 2), each a tp 2 engine): the unsharded JAX LLM's tokens for
    the seeded greedy batch and for seeded TopK / Temperature requests,
    every rank returning them; both replicas served; the aggregated
    emitted_tokens is 24, the sum over the replicas; with replica 1
    drained (``drain(1, wait=True)``, every rank calling) new requests go
    to replica 0 alone, with the same tokens."""
    got, want, _ = runs
    for r in range(4):
        res = _ok(got[4][r], "router")
        assert res["tokens"] == want["router"]
        assert res["mixed"] == want["router_mixed"]
        assert res["engine_tp"] == 2 and res["index"] == r // 2
        assert res["engine_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert res["emitted"] == 24 == sum(res["per_replica"])
        assert res["completed"] == 4
        assert res["drained"] == want["router"][:2]
    lead = _ok(got[4][0], "router")
    assert lead["served"] == [2, 2] and all(n > 0 for n in lead["served"])
    # after mixed (2 + 2 more) and replica 1's drain, both went to 0
    assert lead["served_after_drain"] == [6, 4]


@pytest.mark.parametrize("world", [2, 4])
def test_http_under_tp_roundtrip(runs, world):
    """tests/test_serve_api.py:294 against world rank 0's server: LLM(tp=2)
    at world 2, Router(replicas=2, tp=2) at world 4.  Plain and streamed
    completions give the unsharded JAX LLM's tokens, /v1/stats keeps its
    invariants, /healthz is ok, unknown paths 404 and bad requests 400
    with a JSON error."""
    got, want, _ = runs
    res = _ok(got[world][0], "http" if world == 2 else "router_http")
    assert res["full"] == res["streamed"] == want["http"]
    assert res["finish"] == res["last_finish"] == "length"
    assert res["tok_s"] > 0 and res["done"] == "[DONE]"
    eng = res["stats"]["engine"]
    assert eng["decode_steps"] == eng["iterations"]
    assert eng["emitted_tokens"] == 10 == sum(
        r["engine"]["emitted_tokens"] for r in res["stats"]["replicas"])
    assert res["stats"]["kv"]["blocks_free"] == res["stats"]["kv"][
        "num_blocks"]
    assert res["health"]["ok"] is True
    assert res["not_found"] == [404, True]
    assert res["bad_prompt"] == [400, True]
    assert res["bad_stream"] == [400, True]


def test_idle_http_server_outlives_its_group_timeout(runs):
    """The tp 2 server's group times out after 5 s; it sat idle 6.5 s (the
    pump's idle ticks every quarter of the timeout kept the follower
    inside it) and then served."""
    got, want, _ = runs
    res = _ok(got[2][0], "http")
    assert IDLE_S[2] > IDLE_TIMEOUT_S
    assert res["idle_pump_alive"] is True
    assert res["full"] == want["http"]
    assert res["pump_error"] == "None"


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_leaves_its_loop_on_stop(runs, world):
    """After server.shutdown() and stop_pump() on rank 0, every other rank
    returned from serve_forever (its follow loop) and the process exited 0
    (``_wait`` asserts every return code)."""
    got, _, _ = runs
    name = "http" if world == 2 else "router_http"
    for r in range(1, world):
        assert _ok(got[world][r], name)["followed_s"] > 0


def test_a_silent_rank_fails_the_group_within_its_timeout(runs):
    """On groups with a 5 s timeout: rank 1 following a rank 0 that never
    ticks raises; rank 0's pump whose follower never steps dies and its
    generate raises; both within the timeout (plus a margin), both ranks
    then meet again on the world group."""
    got, _, _ = runs
    for r in range(2):
        res = _ok(got[2][r], "silent")
        assert res["raised"], res
        assert res["seconds"] < 2 * IDLE_TIMEOUT_S + 5, res


# -- training on a (data, model) mesh -----------------------------------------
def _mesh_res(runs, mesh: str) -> list:
    """Every rank's result of the mesh's training scenario."""
    got, _, _ = runs
    return [_ok(r, f"train_{mesh}") for r in got[TRAIN_MESHES[mesh]]]


def _fsdp_bytes(cfg, split, D: int) -> int:
    """The bytes a rank's f32 step (no remat) gathers over its data group
    (kind ``"fsdp"``): every data-cut leaf at the rank's model cut, once
    (a unit's in the unit, the embedding once for the lookup and the
    tied head)."""
    import math

    from repro_torch import tree as tree_mod
    from repro_torch import weights as tweights

    return 4 * sum(
        math.prod(sharding.rank_shape(path, shape, cfg, split))
        for path, (shape, _) in tree_mod.items(tweights.param_shapes(cfg))
        if sharding.data_axis(path, cfg, D) is not None)


def _grads_close(d, name, want_tree):
    """The gathered gradients rank 0 wrote against the JAX tree, each leaf
    within GRAD_TOL of its largest |value|."""
    got = np.load(d / f"{name}.npz")
    leaves = _named_leaves(want_tree)
    assert set(got.files) == {"/".join(k) for k, _ in leaves}
    for k, want in leaves:
        g = got["/".join(k)]
        assert g.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(g - want).max()) <= GRAD_TOL * scale, k


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_mesh_training_matches_the_jax_single_device_step(runs, mesh):
    """qwen3-0.6b's smoke config trained on a (data, model) mesh of
    gloo ranks (bridged weights, TokenPipeline's global batches, 3 AdamW
    steps): every step's loss and grad_norm are the JAX package's
    single-device ``make_train_step``'s (loss within 1e-5, grad_norm at
    rtol 1e-5; the first step's norm, ~4.3, crosses the clip at 1.0), and
    the first step's gradients, gathered to the whole layout, are its
    gradients, every leaf within 5e-5 of its largest |value|.  Every rank
    reports the same losses."""
    _, want, _ = runs
    res = _mesh_res(runs, mesh)
    jt = want["train"]["plain"]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert r["norms"] == res[0]["norms"]
    for (jl, jn), loss, norm in zip(jt, res[0]["losses"], res[0]["norms"]):
        assert abs(loss - jl) <= LOSS_TOL
        assert abs(norm - jn) <= RTOL * jn
    assert jt[0][1] > 1.0 and res[0]["norms"][0] > 1.0   # clipped
    _grads_close(want["dir"], f"grads_{mesh}", want["train"]["grads"])


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_mesh_masked_loss_with_uneven_counts_matches_jax(runs, mesh):
    """A loss mask that keeps 3 tokens of data shard 0's rows and 30 of
    shard 1's: the loss is the global masked sum over the GLOBAL count
    (all-reduced over the data group), so the mesh gives JAX's masked
    loss and gradients; a mean of the shards' means would weigh shard
    0's 3 tokens as much as shard 1's 30."""
    _, want, _ = runs
    res = _mesh_res(runs, mesh)
    counts = sorted({r["mask_count"] for r in res})
    assert counts == [3.0, 30.0]
    for r in res:
        assert abs(r["masked_loss"] - want["train"]["masked_loss"]) \
            <= LOSS_TOL
    _grads_close(want["dir"], f"masked_{mesh}", want["train"]["masked"])


def test_mesh_qk_norm_gradient_needs_its_model_group_sum(runs):
    """At 1x2 each rank's qk-norm scale gradient, before the model
    group's sum, is its own heads' part, which misses JAX's gradient by
    far; the summed gradient (checked leaf for leaf in
    ``test_mesh_training_matches_the_jax_single_device_step``) is
    JAX's."""
    _, want, _ = runs
    jq = np.asarray(want["train"]["grads"]["decoder"][0]["slot0"]["attn"][
        "q_norm"])
    parts = [np.asarray(r["q_norm_part"], np.float32)
             for r in _mesh_res(runs, "1x2")]
    scale = np.abs(jq).max()
    for p in parts:
        assert np.abs(p - jq).max() > 0.05 * scale
    assert np.abs(parts[0] + parts[1] - jq).max() <= GRAD_TOL * scale


def test_mesh_factored_is_matched_at_model_1_and_refused_under_a_split(runs):
    """``factored=True``: at 2x1 (no split) two steps give the JAX
    package's factored losses and norms; at 1x2 and 2x2 the step refuses
    it, naming the means a split would cut."""
    _, want, _ = runs
    jf = want["train"]["factored"]
    for r in _mesh_res(runs, "2x1"):
        for (jl, jn), (loss, norm) in zip(jf, r["factored"]["steps"]):
            assert abs(loss - jl) <= LOSS_TOL
            assert abs(norm - jn) <= RTOL * jn
    for mesh in ("1x2", "2x2"):
        for r in _mesh_res(runs, mesh):
            assert "factored=True under a split" in r["factored"]["refused"]


def test_mesh_groups_rows_and_step_bytes(runs):
    """The mesh's layout and traffic: at 2x2 rank ``r``'s model group is
    ranks {2 (r // 2), 2 (r // 2) + 1} and its data group {r mod 2, r mod
    2 + 2} (the strided split), its rows of the global batch its data
    index's block.  A step's bytes by kind, f32 at smoke size (64 rows a
    data shard at D 1, 32 at D 2; d 64; no remat): the embedding's one
    all-reduce, the trunk's 2 layers x (2 forward + 2 backward), the
    head's input gradient, each rows x 64 x 4 bytes; the qk-norm parts
    (2 layers x 2 x 16 f32) and the global norm's one scalar.  At D 2
    (FSDP) the data group gathers every data-cut leaf of the rank's model
    slice once (``fsdp``) and sums every leaf's gradient in f32
    (``grad``: the cut leaves' reduce-scatters count their inputs, the
    rest all-reduces -- the same bytes as the rank's slice), and the
    global norm's cut parts (one f32, two beside a model split) are
    summed over it."""
    from repro_torch.parallel import sharding as shd

    for r, res in enumerate(_mesh_res(runs, "2x2")):
        assert res["model_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert res["data_ranks"] == [r % 2, r % 2 + 2]
        assert (res["d"], res["m"]) == (r // 2, r % 2)
        assert res["rows"] == [2 * (r // 2), 2 * (r // 2) + 1]
    full = shd.rank_param_count(TCFG, shd.plan(TCFG, 0, 1))
    half = shd.rank_param_count(TCFG, shd.plan(TCFG, 0, 2))
    for mesh, rows, grad in (("1x2", 64, 0), ("2x1", 32, full),
                             ("2x2", 32, half)):
        got = _mesh_res(runs, mesh)[0]["step_bytes"]
        act = rows * TCFG.d_model * 4
        want = {"digest": got.get("digest")}
        if mesh != "2x1":
            want.update(embed=act, trunk=TCFG.n_layers * 4 * act, head=act,
                        norm=TCFG.n_layers * 2 * TCFG.head_dim * 4 + 4,
                        loss=rows * 2 * 2 * 4 + rows * 4)
        if grad:
            split = shd.train_plan(TCFG, 0, 2, int(mesh[-1])).split
            want["grad"] = grad * 4
            want["loss"] = want.get("loss", 0) + 4
            want["fsdp"] = _fsdp_bytes(TCFG, split, 2)
            want["norm"] = want.get("norm", 0) + (4 if mesh == "2x1" else 8)
        want = {k: v for k, v in want.items() if v}
        assert got == want, (mesh, got, want)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_fsdp_rank_holds_its_cut_of_the_state(runs, mesh):
    """FSDP: at D 2 each rank holds its 1/D cut of every leaf the
    reference cuts over data, on top of its model slice -- its f32
    masters are exactly 4 bytes a parameter of
    ``sharding.rank_param_count(split, dcut)``, AdamW's m / v twice that
    plus the 4-byte step -- and those bytes are the dry-run's
    (``segment_cost.train_cell``) for the same cell, exactly; they are
    less than the replicated layout's (the same count without the data
    cut)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import segment_cost
    from repro_torch.optim import optimizer as opt_mod

    D, M = (int(x) for x in mesh.split("x"))
    shape = ShapeSpec("t", TRAIN["seq"], TRAIN["batch"], "train")
    for r, res in enumerate(_mesh_res(runs, mesh)):
        plan = sharding.train_plan(TCFG, r, D, M)
        n = sharding.rank_param_count(TCFG, plan.split, plan.dcut)
        assert res["state_bytes"] == [4 * n, 8 * n + 4]
        assert n < sharding.rank_param_count(
            TCFG, plan.split or sharding.plan(TCFG, 0, 1))
        cell = segment_cost.train_cell(TCFG, opt_mod.AdamWConfig(), shape,
                                       D, M, r, walk=False)
        assert res["state_bytes"] == [cell["memory"]["params"],
                                      cell["memory"]["optimizer"]]


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_fsdp_data_cut_gradients_are_reduce_scattered_never_all_reduced(
        runs, mesh):
    """A step's data-group collectives of gradients: every data-cut leaf's
    gradient is reduce-scattered in the backward -- each layer's at the
    rank's model cut, the embedding's once -- and the all-reduce of kind
    ``"grad"`` sums only the leaves the data axis replicates (the norm
    scales), leaf by leaf in the tree's order."""
    from repro_torch import tree as tree_mod
    from repro_torch import weights as tweights

    D, M = (int(x) for x in mesh.split("x"))
    for r, res in enumerate(_mesh_res(runs, mesh)):
        plan = sharding.train_plan(TCFG, r, D, M)
        reduced, scattered = [], []
        for path, (shape, _) in tree_mod.items(
                tweights.param_shapes(TCFG)):
            mine = list(sharding.rank_shape(path, shape, TCFG, plan.split,
                                            plan.dcut))
            if sharding.data_axis(path, TCFG, D) is None:
                reduced.append(mine)
                continue
            whole = list(sharding.rank_shape(path, shape, TCFG,
                                             plan.split))
            layers = 1 if path == ("embed",) else whole[0]
            scattered += [whole[1:] if path != ("embed",) else whole] \
                * layers
        seen = res["grad_collectives"]
        assert seen["reduced"] == reduced
        assert sorted(seen["scattered"]) == sorted(scattered)


@pytest.mark.parametrize("arch,mesh", [("qwen3-0.6b", m)
                                       for m in TRAIN_MESHES] + [
    (a, m) for a, m in FAMILY_MESHES if a != "qwen3-0.6b"] + [
    ("qwen3-0.6b@1x4", "1x4")])
def test_dryrun_walk_counts_the_mesh_step_bytes(runs, arch, mesh):
    """The dry-run's walk of rank 0's training step on the ``meta``
    device over counting groups (``launch.segment_cost.train_step_walk``:
    ``loss_and_grads`` and the AdamW update, in this process) counts,
    kind by kind, exactly the collective bytes rank 0's last gloo step
    recorded (its digest aside: the walk leaves the step's host checks
    out)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import segment_cost
    from repro_torch.optim import optimizer as opt_mod

    name = arch.partition("@1x4")[0]
    D, M = (int(x) for x in mesh.split("x"))
    res = (_mesh_res(runs, mesh) if name == arch == "qwen3-0.6b"
           else _family_res(runs, name, mesh))
    got = {k: n for k, n in res[0]["step_bytes"].items() if k != "digest"}
    shape = ShapeSpec("t", TRAIN["seq"], TRAIN["batch"], "train")
    walked, _ = segment_cost.train_step_walk(
        _named(name)[1], opt_mod.AdamWConfig(), shape, D, M)
    assert walked.coll_breakdown == got


def test_mesh_2x2_losses_match_the_reference_on_its_own_2x2_mesh(runs):
    """``repro.launch.train.train`` on a ``(2, 2)`` mesh of four forced
    host devices (its pjit over ``train_specs``): its three losses are
    the port's 2x2 losses within 1e-5, and ``launch.train.train`` on the
    port's mesh gives the same first two losses as its step."""
    _, want, _ = runs
    ref = want["jax_mesh"]["qwen3-0.6b"]
    assert ref["devices"] == 4
    res = _mesh_res(runs, "2x2")
    for a, b in zip(ref["losses"], res[0]["losses"]):
        assert abs(a - b) <= LOSS_TOL
    for r in res:
        assert r["train_losses"] == r["losses"][:2]


def test_mesh_2x2_checkpoint_reads_at_1x1_and_in_the_jax_package(runs,
                                                                 tmp_path):
    """A checkpoint written at 2x2 (the whole layout, by rank 0, at step
    2): every rank restored it straight into its slice, bit for bit its
    live state; a 1x1 run of the port resumes from it and its next step's
    loss is the uninterrupted 2x2 run's third; ``repro.checkpoint``
    reads it, leaf for leaf the port's restore."""
    import shutil

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import optimizer as opt_mod

    _, want, _ = runs
    res = _mesh_res(runs, "2x2")
    assert all(r["restored_equal"] for r in res)
    ckpt = tmp_path / "ckpt"
    shutil.copytree(want["dir"] / "ckpt", ckpt)
    opt = opt_mod.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              total_steps=TRAIN["total"])
    whole = CheckpointManager(ckpt).restore(
        2, steps_mod.train_state_struct(TCFG, opt))
    from repro.launch import steps as jsteps
    from repro.optim import optimizer as jopt

    jstate = JManager(ckpt).restore(2, jsteps.train_state_struct(
        JCFG, jopt.AdamWConfig()))
    for (path, a), (_, b) in zip(_named_leaves(jax.tree.map(
            np.asarray, jstate)), _named_leaves(jax.tree.map(
                lambda t: t.numpy(), whole))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _, losses = train_mod.train(
        TCFG, ShapeSpec("t", TRAIN["seq"], TRAIN["batch"], "train"), opt,
        device="cpu", steps=3, ckpt_dir=ckpt, log=lambda *a: None)
    assert len(losses) == 1
    assert abs(losses[0] - res[0]["losses"][2]) <= LOSS_TOL


def test_pipeline_apply_matches_the_stages_in_sequence(runs):
    """``parallel.pipeline.pipeline_apply`` over 4 gloo ranks, 4
    microbatches of 2: every rank's result is ``tanh(x @ W_s + b_s)``
    applied for s = 0..3 in sequence on the whole batch (within 1e-6:
    BLAS may round a (2, 8) product otherwise than an (8, 8) one), and
    the activations moved are 3 stages x 4 microbatches sent plus the
    broadcast."""
    got, _, _ = runs
    rng = np.random.default_rng(21)
    ws = rng.standard_normal((4, 8, 8)).astype(np.float32) * 0.5
    bs = rng.standard_normal((4, 8)).astype(np.float32) * 0.1
    h = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    for s in range(4):
        h = torch.tanh(h @ torch.from_numpy(ws[s]) + torch.from_numpy(bs[s]))
    for r, res in enumerate(got[4]):
        p = _ok(res, "pipeline")
        np.testing.assert_allclose(np.asarray(p["y"], np.float32),
                                   h.numpy(), atol=1e-6, rtol=0)
        sent = 4 * 2 * 8 * 4 if r < 3 else 0
        assert p["pipe_bytes"] == sent + 8 * 8 * 4


# -- the moe, ssm and hybrid families trained on a mesh -------------------------
def _family_res(runs, arch: str, mesh: str) -> list:
    got, _, _ = runs
    world = 4 if mesh in ("2x2", "1x4") else 2
    return [_ok(r, f"train_{arch}_{mesh}") for r in got[world]]


def _family_want(runs, arch: str) -> dict:
    _, want, _ = runs
    return want["train"] if arch == "qwen3-0.6b" else \
        want["family_train"][arch]


def _jax_leaf(tree, *keys):
    for k in keys:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch,mesh", FAMILY_MESHES)
def test_family_mesh_training_matches_the_jax_single_device_step(runs, arch,
                                                                  mesh):
    """phi3.5-moe (expert parallelism, the router loss over the data
    group), rwkv6 (whole heads; the channel-mix's summed ``kv`` and
    gathered product) and recurrentgemma (whole gate blocks; its one MQA
    kv head copied to every model rank) trained on a (data, model) mesh
    of gloo ranks, and qwen3 at 1x4 (its 2 kv heads copied to 2 ranks
    each): every step's loss and grad_norm are the JAX package's
    single-device ``make_train_step``'s (loss within 1e-5, grad_norm at
    rtol 1e-5) and the first step's gradients, gathered to the whole
    layout, its gradients, every leaf within 5e-5 of its largest
    |value|; every rank reports the same losses."""
    _, want, _ = runs
    res = _family_res(runs, arch, mesh)
    jt = _family_want(runs, arch)
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert r["norms"] == res[0]["norms"]
    for (jl, jn), loss, norm in zip(jt["plain"], res[0]["losses"],
                                    res[0]["norms"]):
        assert abs(loss - jl) <= LOSS_TOL
        assert abs(norm - jn) <= RTOL * jn
    _grads_close(want["dir"], f"grads_{arch}_{mesh}", jt["grads"])


@pytest.mark.parametrize("arch,mesh,copies", [
    ("recurrentgemma-2b", "1x2", [[0, 1]]),
    ("recurrentgemma-2b", "2x2", [[0, 1], [2, 3]]),
    ("qwen3-0.6b", "1x4", [[0, 1], [2, 3]])])
def test_copied_kv_head_gradient_needs_its_copy_group_sum(runs, arch, mesh,
                                                          copies):
    """A kv head copied to several model ranks: the ranks holding one copy
    form its group (``TrainMesh.kv``), and rank 0's wk gradient before
    that group's sum -- its own q heads' part -- misses JAX's gradient of
    those columns by far; the summed gradient (gathered and held leaf for
    leaf in ``test_family_mesh_training_matches_the_jax_single_device_step``)
    is JAX's.  A step's ``kv`` bytes are both attention leaves of the
    rank's copy, f32 (at D 2 its data cut: half the D rows, FSDP)."""
    res = _family_res(runs, arch, mesh)
    for r, rr in enumerate(res):
        assert rr["kv_ranks"] == next(c for c in copies if r in c)
    jt = _family_want(runs, arch)["grads"]
    seg = jt["decoder"][0]
    slot = next(k for k in sorted(seg) if "attn" in seg[k])
    jwk = _jax_leaf(seg, slot, "attn", "wk")
    cfg = smoke_config(get_config(arch))
    D = int(mesh[0])
    part = np.asarray(res[0]["wk_part"], np.float32)
    # rank 0's kv head, and at D 2 its data index's half of the D rows
    want = jwk[..., :cfg.d_model // D, :cfg.head_dim]
    assert part.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(part - want).max() > 0.05 * scale
    n_attn = sum(u.count("attn") * c for u, c in tlm.segments(cfg))
    assert res[0]["step_bytes"]["kv"] == \
        n_attn * 2 * cfg.d_model * cfg.head_dim * 4 // D


def test_router_gradient_with_its_loss_counted_per_rank_misses_jax(runs):
    """phi3.5-moe at 1x2: every model rank computes the router loss whole.
    With ``comm.share_grad`` taken out of ``parallel.moe_ep`` each rank's
    router gradient carries all of it, the model group's sum counts it
    twice, and the router's gradient misses JAX's; with it (the
    reference's ``pmean``) the sum is JAX's."""
    got, want, _ = runs
    jr = _jax_leaf(want["family_train"][PHI]["grads"], "decoder", 0,
                   "slot0", "moe", "router")
    trap = np.asarray(_ok(got[2][0], "trap_router"), np.float32)
    scale = np.abs(jr).max()
    assert np.abs(trap - jr).max() > 10 * GRAD_TOL * scale
    fixed = np.load(want["dir"] / f"grads_{PHI}_1x2.npz")[
        "decoder/0/slot0/moe/router"]
    assert np.abs(fixed - jr).max() <= GRAD_TOL * scale


def test_rwkv_kv_sum_with_an_identity_backward_misses_jax(runs):
    """rwkv6 at 1x2: each rank multiplies only its own columns of the
    channel-mix's summed ``kv``, so the gradient of its partial ``kv`` is
    the ranks' column gradients summed.  With ``comm.sum_to_group``
    swapped for ``reduce_from_group`` (whose backward is the identity)
    the ``w_k_cm`` gradient misses JAX's; with it the gradient is
    JAX's."""
    got, want, _ = runs
    jw = _jax_leaf(want["family_train"]["rwkv6-7b"]["grads"], "decoder", 0,
                   "slot0", "w_k_cm")
    trap = np.asarray(_ok(got[2][0], "trap_kv"), np.float32)
    scale = np.abs(jw).max()
    assert np.abs(trap - jw).max() > 10 * GRAD_TOL * scale
    fixed = np.load(want["dir"] / "grads_rwkv6-7b_1x2.npz")[
        "decoder/0/slot0/w_k_cm"]
    assert np.abs(fixed - jw).max() <= GRAD_TOL * scale


def test_phi_2x2_losses_match_the_reference_on_its_own_2x2_mesh(runs):
    """``repro.launch.train.train`` of phi3.5-moe's smoke config on a
    ``(2, 2)`` mesh of four forced host devices (GSPMD: expert
    parallelism and the router loss over the whole batch): its three
    losses are the port's 2x2 losses within 1e-5, and
    ``launch.train.train`` on the port's mesh gives the same first two
    losses as its step."""
    _, want, _ = runs
    ref = want["jax_mesh"][PHI]
    assert ref["devices"] == 4
    res = _family_res(runs, PHI, "2x2")
    for a, b in zip(ref["losses"], res[0]["losses"]):
        assert abs(a - b) <= LOSS_TOL
    for r in res:
        assert r["train_losses"] == r["losses"][:2]


def test_phi_2x2_checkpoint_resumes_at_1x1_and_reads_in_the_jax_package(
        runs, tmp_path):
    """phi3.5-moe's whole state written at 2x2 (step 2, by rank 0: the
    expert stacks gathered along E): a 1x1 run of the port resumes from
    it and its next loss is the uninterrupted 2x2 run's third, and
    ``repro.checkpoint`` reads it leaf for leaf as the port's restore."""
    import shutil

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.launch import steps as jsteps
    from repro.optim import optimizer as jopt
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import optimizer as opt_mod

    _, want, _ = runs
    res = _family_res(runs, PHI, "2x2")
    ckpt = tmp_path / "ckpt"
    shutil.copytree(want["dir"] / "ckpt_phi", ckpt)
    tcfg, jcfg = smoke_config(get_config(PHI)), j_smoke(J_ARCHS[PHI])
    opt = opt_mod.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              total_steps=TRAIN["total"])
    whole = CheckpointManager(ckpt).restore(
        2, steps_mod.train_state_struct(tcfg, opt))
    jstate = JManager(ckpt).restore(2, jsteps.train_state_struct(
        jcfg, jopt.AdamWConfig()))
    for (path, a), (_, b) in zip(_named_leaves(jax.tree.map(
            np.asarray, jstate)), _named_leaves(jax.tree.map(
                lambda t: t.numpy(), whole))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _, losses = train_mod.train(
        tcfg, ShapeSpec("t", TRAIN["seq"], TRAIN["batch"], "train"), opt,
        device="cpu", steps=3, ckpt_dir=ckpt, log=lambda *a: None)
    assert len(losses) == 1
    assert abs(losses[0] - res[0]["losses"][2]) <= LOSS_TOL


def test_rwkv_1x2_state_reshards_into_2x2_through_restore(runs):
    """rwkv6's whole train state written from 1x2 (gathered over the
    model group after three steps) restores through
    ``CheckpointManager.restore(split=, dcut=)`` straight into each rank
    of a 2x2 mesh (``train_plan``'s split and data cut), bit for bit its
    data index's 1/D (FSDP: ``wB``'s within its channels) of the 1x2 rank
    of its model index's live state (params, AdamW's m / v and step)."""
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import optimizer as opt_mod

    got, want, _ = runs
    for r in got[2]:
        _ok(r, "rwkv_ckpt")
    cfg = smoke_config(get_config("rwkv6-7b"))
    opt = opt_mod.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              total_steps=TRAIN["total"])
    mgr = CheckpointManager(want["dir"] / "ckpt_rwkv")
    struct = steps_mod.train_state_struct(cfg, opt)
    cut_some = False
    for r in range(4):
        plan = sharding.train_plan(cfg, r, 2, 2)
        back = mgr.restore(TRAIN["steps"], struct, cfg=cfg,
                           split=plan.split, dcut=plan.dcut)
        live = np.load(want["dir"] / f"rwkv_state_{r % 2}.npz")
        for path, t in tree_mod.items(back):
            own = sharding.shard_leaf(path, live[tree_mod.key(path)], cfg,
                                      None, plan.dcut)
            cut_some |= own.shape != live[tree_mod.key(path)].shape
            np.testing.assert_array_equal(t.numpy(), own,
                                          err_msg=str(path))
    assert cut_some


# -- the vlm and encdec families trained on a mesh ---------------------------
@pytest.mark.parametrize("arch,mesh", [(ENCDEC, "1x2"), (VLM, "2x2"),
                                       *WHOLE_VOCAB.items()])
def test_vlm_and_encdec_mesh_step_bytes_by_kind(runs, arch, mesh):
    """A training step's collective bytes by kind, f32 at smoke size (no
    remat; ``act`` = a data shard's 64 or 32 rows x 64 x 4 bytes): each
    dense or ``enc`` layer 4 ``act`` of ``trunk`` (two sums forward, two
    inputs' gradients backward), an ``xattn`` layer 6 (its
    cross-attention's pair too), the encoder's output one ``act`` of
    ``cross`` (its gradient summed once); where the vocabulary is cut
    the embedding's sum and the head input's gradient (``embed``,
    ``head``) and the vocabulary-parallel loss's stats and label pick
    (``loss``); where it is kept whole (V 255 at M 2, 258 at M 4) none
    of the three: the lookup, head and loss are each rank's whole ones.
    A copied kv head (seamless@258 at M 4: 2 kv heads) sums each
    attention's wk / wv gradient over its copy's ranks (``kv``); the
    global norm one f32 (``norm``); at D 2 every leaf of the rank's slice
    (``grad``: reduce-scattered where the data axis cuts it, else
    all-reduced), each data-cut leaf gathered once (``fsdp``), the
    global norm's two cut parts over the data group, and the loss's
    count and value (``loss``)."""
    jcfg, cfg = _named(arch)
    D, M = (int(x) for x in mesh.split("x"))
    whole = cfg.vocab_size % M != 0
    rows = TRAIN["batch"] // D * TRAIN["seq"]
    act = rows * cfg.d_model * 4
    kinds = tlm.layer_types(cfg)
    n_enc = cfg.n_encoder_layers
    res = _family_res(runs, arch, mesh)
    for r, rr in enumerate(res):
        lo = 0 if whole else r % M * cfg.vocab_size // M
        assert rr["vocab"] == [lo, cfg.vocab_size if whole
                               else lo + cfg.vocab_size // M]
    got = res[0]["step_bytes"]
    want = {"digest": got.get("digest"), "norm": 4,
            "trunk": (4 * (n_enc + kinds.count("attn"))
                      + 6 * kinds.count("xattn")) * act,
            "cross": act if n_enc else 0}
    if not whole:
        want.update(embed=act, head=act, loss=rows * 2 * M * 4 + rows * 4)
    copies = sharding.kv_copies(cfg, M)
    if copies is not None:
        n_attn = n_enc + len(kinds) + kinds.count("xattn")
        want["kv"] = n_attn * 2 * cfg.d_model * cfg.head_dim * 4
    if D > 1:
        split = sharding.train_plan(cfg, 0, D, M).split
        want["grad"] = sharding.rank_param_count(cfg, split) * 4
        want["loss"] = want.get("loss", 0) + 4
        want["fsdp"] = _fsdp_bytes(cfg, split, D)
        want["norm"] += 8 if M > 1 else 4
    want = {k: v for k, v in want.items() if v}
    assert got == want, (got, want)


def test_whole_head_behind_the_copy_misses_jax(runs):
    """internvl2@255 at 1x2: the vocabulary, 255 ids, is whole on both
    ranks, so the head's input gradient is whole on each already.  With
    ``lm.logits_fn`` swapped for ``lm.local_logits`` (the whole head
    behind ``comm.copy_to_group``, as a cut vocabulary's is) the copy's
    backward sums it over the 2 ranks: the final norm's gradient is 2
    times JAX's and misses it; without the copy (the port) it is JAX's."""
    got, want, _ = runs
    name = VLM + "@255"
    jf = _jax_leaf(want["family_train"][name]["grads"], "final_norm")
    trap = np.asarray(_ok(got[2][0], "trap_whole_head"), np.float32)
    scale = np.abs(jf).max()
    assert np.abs(trap - jf).max() > 0.5 * scale
    assert np.abs(trap - 2 * jf).max() <= 2 * GRAD_TOL * scale
    fixed = np.load(want["dir"] / f"grads_{name}_1x2.npz")["final_norm"]
    assert np.abs(fixed - jf).max() <= GRAD_TOL * scale


def test_encoder_output_without_its_cross_copy_misses_jax(runs):
    """seamless at 1x2: every xattn layer's kv heads read the encoder's
    output, and each rank's heads give a part of its gradient.  With the
    ``"cross"`` copy taken out of ``lm._encoder_output`` the encoder's
    gradients are the rank's part, and the encoder's wq gradient misses
    JAX's; with it (one all-reduce a step) it is JAX's."""
    got, want, _ = runs
    jw = _jax_leaf(want["family_train"][ENCDEC]["grads"], "encoder", 0,
                   "slot0", "attn", "wq")
    trap = np.asarray(_ok(got[2][0], "trap_cross"), np.float32)
    scale = np.abs(jw).max()
    assert np.abs(trap - jw).max() > 10 * GRAD_TOL * scale
    fixed = np.load(want["dir"] / f"grads_{ENCDEC}_1x2.npz")[
        "encoder/0/slot0/attn/wq"]
    assert np.abs(fixed - jw).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("world", [2, 4])
def test_encdec_split_greedy_decode_matches_unsharded_jax(runs, world):
    """seamless's smoke config at tp 2 and 4 (f32, bridged weights):
    ``lm.prefill`` over 12 stub source frames, then 16 greedy
    ``lm.decode_step``s, each token from the sharded argmax head on the
    rank's V / tp slice, give the JAX package's unsharded tokens on every
    rank; each rank's read-only cross cache holds its kv heads (at tp 4
    a copy of one of the 2), and the serving step moves trunk and head
    bytes but no ``"cross"`` ones (no gradient)."""
    got, want, _ = runs
    cfg = smoke_config(get_config(ENCDEC))
    per = cfg.vocab_size // world
    for rank in range(world):
        res = _ok(got[world][rank], "encdec_greedy")
        assert res["tokens"] == want["encdec_greedy"], rank
        assert res["vocab"] == [rank * per, (rank + 1) * per]
        assert res["xk"] == [cfg.n_layers, 2, 12,
                             max(cfg.n_kv_heads // world, 1), cfg.head_dim]
        assert res["bytes"]["trunk"] > 0 and res["bytes"]["head"] > 0
        assert "cross" not in res["bytes"]


@pytest.mark.parametrize("arch", [ENCDEC, VLM + "@255"])
def test_1x2_state_resumes_at_1x1_and_reads_in_the_jax_package(
        runs, tmp_path, arch):
    """seamless's and internvl2@255's whole states written from 1x2 (step
    2 of ``launch.train.train`` on the mesh, by rank 0: the encoder's and
    the cross-attention's slices gathered, a cut vocabulary's too; the
    whole 255-id embedding and head as they are): a 1x1 run of the port
    resumes from it and its next loss is the 1x2 step's third, and
    ``repro.checkpoint`` reads it leaf for leaf as the port's restore.
    ``launch.train.train``'s two losses are its step's."""
    import shutil

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.launch import steps as jsteps
    from repro.optim import optimizer as jopt
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import optimizer as opt_mod

    _, want, _ = runs
    res = _family_res(runs, arch, "1x2")
    for r in res:
        assert r["train_losses"] == r["losses"][:2]
    ckpt = tmp_path / "ckpt"
    shutil.copytree(want["dir"] / f"ckpt_{arch}", ckpt)
    jcfg, tcfg = _named(arch)
    opt = opt_mod.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              total_steps=TRAIN["total"])
    whole = CheckpointManager(ckpt).restore(
        2, steps_mod.train_state_struct(tcfg, opt))
    jstate = JManager(ckpt).restore(2, jsteps.train_state_struct(
        jcfg, jopt.AdamWConfig()))
    for (path, a), (_, b) in zip(_named_leaves(jax.tree.map(
            np.asarray, jstate)), _named_leaves(jax.tree.map(
                lambda t: t.numpy(), whole))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _, losses = train_mod.train(
        tcfg, ShapeSpec("t", TRAIN["seq"], TRAIN["batch"], "train"), opt,
        device="cpu", steps=3, ckpt_dir=ckpt, log=lambda *a: None)
    assert len(losses) == 1
    assert abs(losses[0] - res[0]["losses"][2]) <= LOSS_TOL
