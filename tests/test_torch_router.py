"""The port's multi-replica router against the JAX package's, on the CPU.

The host-side cases of ``tests/test_tp_serving.py:87-265`` -- the
/v1/stats merge rules, routing order, session and prefix affinity, drain
and health, generate equal to a single ``LLM``, stream and pump, bad
replicas -- each run on the port's ``serve.router`` and on the JAX
package's ``serve.router`` (or its functions) over the same trace and
the same bridged smoke weights, and compared.  Tokens are compared
exactly.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro.serve.router import Router as JRouter  # noqa: E402
from repro.serve.router import aggregate_engine_stats as j_agg  # noqa: E402
from repro.serve.router import aggregate_kv as j_agg_kv  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402
from repro_torch.serve.router import Router as TRouter  # noqa: E402
from repro_torch.serve.router import aggregate_engine_stats, aggregate_kv  # noqa: E402
from repro_torch.serve.server import make_server  # noqa: E402

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
FLEET = dict(n_slots=2, max_len=32, eos_id=-1)


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(tree, TCFG, "cpu")


def _prompts(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, size=5 + 3 * i).astype(np.int32)
            for i in range(n)]


def _both(bridged, **kw):
    """(the port's Router, the JAX package's) over the same weights."""
    jparams, tparams = bridged
    return TRouter(tparams, TCFG, **kw), JRouter(jparams, JCFG, **kw)


# -- the merge rules ---------------------------------------------------------
SNAPS = [{"emitted_tokens": 10, "decode_steps": 5, "drafted": 4,
          "accepted": 3, "host_syncs": 5, "peak_in_use": 7,
          "attn_approx": "exact", "attn_window": None},
         {"emitted_tokens": 6, "decode_steps": 3, "drafted": 0,
          "accepted": 0, "host_syncs": 3, "peak_in_use": 2}]


@pytest.mark.parametrize("pools", [None, [[10.0, 30.0], [20.0]]])
def test_aggregate_engine_stats_merge_rules(pools):
    """Counters sum, peaks max, ratios from the summed terms, percentiles
    from the pooled samples (None without) -- the JAX function's dict."""
    agg = aggregate_engine_stats(SNAPS, ttft_pools=pools)
    assert agg == j_agg(SNAPS, ttft_pools=pools)
    assert agg["emitted_tokens"] == 16 and agg["peak_in_use"] == 7
    assert agg["acceptance_rate"] == 3 / 4
    assert agg["tokens_per_dispatch"] == 16 / 8
    assert agg["ttft_ms_p50"] == (None if pools is None else 20.0)
    assert aggregate_engine_stats([]) == {}


def test_aggregate_kv_merge_rules():
    u1 = {"layout": "paged", "block_size": 8, "num_blocks": 16,
          "blocks_in_use": 4, "peak_in_use": 9}
    u2 = {"layout": "paged", "block_size": 8, "num_blocks": 16,
          "blocks_in_use": 2, "peak_in_use": 3}
    agg = aggregate_kv([u1, u2])
    assert agg == j_agg_kv([u1, u2])
    assert agg["num_blocks"] == 32 and agg["blocks_in_use"] == 6
    assert agg["peak_in_use"] == 9 and agg["block_size"] == 8


def test_llm_stats_payload_is_one_replica_fleet(bridged):
    llm = TLLM(bridged[1], TCFG, **FLEET)
    llm.generate(_prompts(2), TSP(max_new_tokens=4))
    p = llm.stats_payload()
    assert len(p["replicas"]) == 1 and p["replicas"][0]["healthy"] is True
    assert p["engine"]["emitted_tokens"] == \
        p["replicas"][0]["engine"]["emitted_tokens"] == 8
    assert p["kv"] == p["replicas"][0]["kv"]


# -- routing -----------------------------------------------------------------
def test_router_least_loaded_and_order(bridged):
    """generate submits all four before stepping: least-loaded alternates
    0, 1, 0, 1 (ties to the lowest index), as the JAX router does, with
    its tokens in prompt order; the aggregate is the replicas' sum."""
    t, j = _both(bridged, replicas=2, **FLEET)
    outs = t.generate(_prompts(4), TSP(max_new_tokens=4))
    jouts = j.generate(_prompts(4), JSP(max_new_tokens=4))
    assert [list(o.token_ids) for o in outs] == \
        [list(o.token_ids) for o in jouts]
    assert [r.served for r in t.replicas] == \
        [r.served for r in j.replicas] == [2, 2]
    p = t.stats_payload()
    for k in ("emitted_tokens", "decode_steps", "completed"):
        assert p["engine"][k] == sum(r["engine"][k] for r in p["replicas"])
    assert p["engine"]["emitted_tokens"] == 16
    assert p["kv"]["num_blocks"] == \
        sum(r["kv"]["num_blocks"] for r in p["replicas"])


def test_router_session_affinity(bridged):
    t, j = _both(bridged, replicas=3, **FLEET)
    prompts = _prompts(6)
    for router, sp in ((t, TSP), (j, JSP)):
        idxs = [router.route(p, session="conv-1") for p in prompts]
        assert len(set(idxs)) == 1                     # sticky
        assert router.route(prompts[0], session="conv-2") == idxs[0]
        router.replicas[idxs[0]].llm.submit(prompts[0],
                                            sp(max_new_tokens=2))
        assert router.route(prompts[1], session="conv-3") != idxs[0]
    assert t._sessions == j._sessions


def test_router_prefix_affinity(bridged):
    """A replica holding the prompt's prefix in its trie wins routing
    though another is as idle; an unrelated prompt falls to least load."""
    kw = dict(replicas=2, n_slots=2, max_len=64, eos_id=-1,
              kv_layout="paged", block_size=8, chunk_size=8)
    t, j = _both(bridged, **kw)
    shared = np.arange(2, 26, dtype=np.int32) % TCFG.vocab_size   # 3 blocks
    follow = np.concatenate([shared, np.array([7, 9], np.int32)])
    cold = np.random.default_rng(0).integers(
        0, TCFG.vocab_size, size=8).astype(np.int32)
    for router, sp in ((t, TSP), (j, JSP)):
        router.generate([shared], sp(max_new_tokens=2))
        assert router.replicas[0].served == 1
        assert router.replicas[0].prefix_hit(shared) > 0
        assert router.replicas[1].prefix_hit(shared) == 0
        assert router.route(follow) == 0
    assert t.replicas[0].prefix_hit(shared) == j.replicas[0].prefix_hit(
        shared)
    assert t.route(cold) == j.route(cold)


def test_router_drain_and_health(bridged):
    t, j = _both(bridged, replicas=2, **FLEET)
    prompts = _prompts(2)
    for router, sp in ((t, TSP), (j, JSP)):
        router.route(prompts[0], session="s0")
        pinned = router._sessions["s0"]
        router.drain(pinned)
        assert "s0" not in router._sessions
        for p in prompts:
            assert router.route(p) == 1 - pinned
            assert router.route(p, session="s0") == 1 - pinned
        h = router.health()
        assert h["ok"] is True
        assert h["replicas"][pinned]["draining"] is True
        router.drain(1 - pinned)
        assert router.health()["ok"] is False
        with pytest.raises(RuntimeError, match="no healthy replica"):
            router.route(prompts[0])
        router.undrain(pinned)
        assert router.route(prompts[0]) == pinned
        router.undrain(1 - pinned)
        outs = router.generate(prompts, sp(max_new_tokens=3))
        assert all(len(o.token_ids) == 3 for o in outs)
    assert t.health() == {**j.health(), "replicas": t.health()["replicas"]}
    assert [r.served for r in t.replicas] == [r.served for r in j.replicas]


def test_router_generate_matches_single_llm(bridged):
    """Replication is invisible in the tokens: the port's 2-replica fleet,
    its single LLM and the JAX single LLM emit the same streams (sampled
    rows pin explicit seeds)."""
    jparams, tparams = bridged
    prompts = _prompts(4)
    plist = [dict(max_new_tokens=6, seed=100 + i,
                  top_k=3 if i == 1 else 1,
                  temperature=0.8 if i == 1 else 1.0) for i in range(4)]
    want = [list(o.token_ids) for o in JLLM(jparams, JCFG, n_slots=2,
                                            max_len=48, eos_id=-1).generate(
        [p.copy() for p in prompts], [JSP(**k) for k in plist])]
    single = TLLM(tparams, TCFG, n_slots=2, max_len=48, eos_id=-1)
    router = TRouter(tparams, TCFG, replicas=2, n_slots=2, max_len=48,
                     eos_id=-1)
    tsp = [TSP(**k) for k in plist]
    assert [list(o.token_ids) for o in single.generate(
        [p.copy() for p in prompts], tsp)] == want
    assert [list(o.token_ids) for o in router.generate(
        [p.copy() for p in prompts], tsp)] == want
    assert all(r.served > 0 for r in router.replicas)


def test_router_stream_and_pump(bridged):
    router = TRouter(bridged[1], TCFG, replicas=2, **FLEET)
    want = [list(o.token_ids) for o in JLLM(bridged[0], JCFG, **FLEET)
            .generate([_prompts(1)[0]], JSP(max_new_tokens=5))][0]
    router.start_pump()
    try:
        toks = [c.token for c in router.stream(_prompts(1)[0],
                                               TSP(max_new_tokens=5))]
        assert toks == want
        assert router.health()["ok"] is True
        assert all(r["pumping"] for r in router.health()["replicas"])
    finally:
        router.stop_pump()


@pytest.mark.parametrize("kw, exc, match", [
    (dict(replicas=0), ValueError, "replicas=0"),
    (dict(replicas=2, tp=2), ValueError, "tp=2 needs")])
def test_router_rejects_bad_replicas(bridged, kw, exc, match):
    with pytest.raises(exc, match=match):
        TRouter(bridged[1], TCFG, **kw)
    if exc is ValueError:
        with pytest.raises(exc, match=match):
            JRouter(bridged[0], JCFG, **kw)


def test_stats_served_from_a_router(bridged):
    """GET /v1/stats from a Router behind the port's server: the
    aggregate invariant over the real payload, and the JAX router's keys;
    /healthz carries the per-replica states."""
    router = TRouter(bridged[1], TCFG, replicas=2, **FLEET)
    srv = make_server(router, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = "http://{}:{}".format(*srv.server_address[:2])
    try:
        req = urllib.request.Request(
            base + "/v1/completions", method="POST",
            data=json.dumps({"prompt": [5, 11, 7, 3],
                             "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["token_ids"]) == 4
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            p = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            h = json.loads(r.read())
    finally:
        srv.shutdown()
        router.stop_pump()
    j = JRouter(bridged[0], JCFG, replicas=2, **FLEET)
    j.generate([np.asarray([5, 11, 7, 3], np.int32)], JSP(max_new_tokens=4))
    want = j.stats_payload()
    assert set(p) == set(want)
    assert set(want["engine"]) <= set(p["engine"])
    assert p["engine"]["emitted_tokens"] == 4 == sum(
        r["engine"]["emitted_tokens"] for r in p["replicas"])
    assert [r["routed"] for r in p["replicas"]] == [1, 0]
    assert h["ok"] is True and len(h["replicas"]) == 2
