"""The device-resident multi-step decode (``host_stride=K``) of the port
against the JAX package's, on the CPU at the smoke size of qwen3-0.6b
(f32), weights bridged from JAX (``weights.from_numpy_params``).  The
counterpart of ``tests/test_serve_multistep.py``, case for case:

  - IDENTITY: the port's tokens and finish reasons equal the JAX
    engine's on the ragged mixed-sampler trace (greedy, top-k bus and
    Gumbel-max rows side by side) at strides 1, 2, 4 and 8, and are the
    same at every stride; greedy equals ``host_stride=None`` and the
    softmax baseline;
  - BOUNDED-LAG STOP: a stop sequence inside a K-token block trims the
    overrun before emission and rewinds the slot's blocks, at every
    (stride, stop position);
  - eos halts a row inside the loop;
  - CANCEL mid-stride trims the row's block, frees its blocks and admits
    a deferred request;
  - a tight pool (preemption) serves the ample pool's tokens;
  - chunked prefill composes (chunk iterations run the single step,
    keyed);
  - the submit and constructor gates; an incapable config (the cohort
    scheduler) warns and serves one token at a time;
  - ``host_syncs``, ``emitted_tokens`` and ``tokens_per_dispatch`` equal
    the JAX engine's;

plus the reference's compositions with ``host_stride``: prefix sharing
(``tests/test_prefix_cache.py``), approximate attention
(``tests/test_attn_approx.py``) and a cancel mid-drain through
``LLM.stream`` (``tests/test_serve_api.py``), and the CUDA graph of one
loop iteration: its bucket key and its launch-counter arithmetic on the
CPU, and, on the card only (marker ``cuda``), a graphed dispatch
bitwise against the eager loop and the keyed draw against its CPU run.

Each JAX run is made once per module (``_jax_run`` caches it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import prng, weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve import sampler as tsampler  # noqa: E402
from repro_torch.serve import step_graph  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
# the mixed trace's samplers by name: (class, kwargs) in both packages
MIXED = (("Greedy", {}), ("TopK", {"k": 4, "temperature": 0.8}),
         ("Temperature", {"temperature": 0.7}))
STATS = ("host_syncs", "emitted_tokens", "tokens_per_dispatch",
         "decode_steps", "prefills", "iterations", "preemptions",
         "completed", "prefill_chunks", "prefix_hits")


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _prompts(n, seed=5, stagger=True):
    rng = np.random.default_rng(seed)
    lens = [3 + (7 * i) % 23 for i in range(n)] if stagger else [8] * n
    return [rng.integers(0, TCFG.vocab_size, L).astype(np.int32)
            for L in lens]


def _samplers(jax_side, names):
    mod = jsampler if jax_side else tsampler
    return None if names is None else [getattr(mod, n)(**kw)
                                       for n, kw in names]


def _serve(jax_side, bridged, prompts, *, host_stride, max_new=10,
           n_slots=3, max_len=64, eos_id=-1, samplers=None, stops=None,
           **kw):
    """One engine pass as the reference test's ``_serve``; returns
    (reqs, engine)."""
    eng_cls, req_cls, sp_cls = ((JEngine, JRequest, JSP) if jax_side
                                else (TEngine, TRequest, TSP))
    params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
    eng = eng_cls(params, cfg, n_slots=n_slots, max_len=max_len,
                  eos_id=eos_id, kv_layout="paged", host_stride=host_stride,
                  **kw)
    objs = _samplers(jax_side, samplers)
    reqs = [req_cls(i, p.copy(), params=sp_cls(
        max_new_tokens=max_new, seed=100 + i,
        stop=() if stops is None else stops[i]),
        sampler=None if objs is None else objs[i % len(objs)])
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=10000)
    return reqs, eng


def _result(reqs, eng):
    snap = eng.snapshot()
    return ([list(r.generated) for r in reqs],
            [r.finish_reason for r in reqs], {k: snap[k] for k in STATS})


_JAX_RUNS: dict = {}


def _jax_run(bridged, prompts_key, **kw):
    """The JAX engine's (tokens, finish reasons, stats) for ``_serve`` on
    ``_prompts(*prompts_key)``, made once per module."""
    key = (prompts_key, tuple(sorted((k, repr(v)) for k, v in kw.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _result(*_serve(True, bridged,
                                         _prompts(*prompts_key), **kw))
    return _JAX_RUNS[key]


def _port_run(bridged, prompts_key, **kw):
    reqs, eng = _serve(False, bridged, _prompts(*prompts_key), **kw)
    return _result(reqs, eng), eng


def _assert_pool_drained(eng):
    free = eng.store.usage()
    assert free["blocks_free"] == free["num_blocks"]


# ---------------------------------------------------------------------------
# Identity: the JAX engine's tokens, across strides, vs legacy and softmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_stride_identity_mixed_samplers(bridged, stride):
    """Greedy, top-k bus and Gumbel-max rows side by side: the port's
    tokens, finish reasons and dispatch stats equal the JAX engine's at
    the same stride, and its tokens equal its own at stride 1."""
    want = _jax_run(bridged, (6,), host_stride=stride, samplers=MIXED)
    got, eng = _port_run(bridged, (6,), host_stride=stride, samplers=MIXED)
    assert got[0] == want[0], f"host_stride={stride}: tokens differ"
    assert got[1] == want[1]
    assert got[2] == want[2]
    ref, _ = _port_run(bridged, (6,), host_stride=1, samplers=MIXED)
    assert got[0] == ref[0] and got[1] == ref[1]
    _assert_pool_drained(eng)


def test_greedy_matches_legacy_and_softmax_baseline(bridged):
    """Greedy draws nothing, so the loop reproduces the per-token engine
    exactly, and the softmax baseline sampled in the loop agrees with the
    comparator (Theorem 1 inside the loop) -- the JAX engine's tokens."""
    greedy = (("Greedy", {}),)
    legacy = _jax_run(bridged, (4,), host_stride=None, samplers=greedy)
    got, _ = _port_run(bridged, (4,), host_stride=None, samplers=greedy)
    assert got[0] == legacy[0]
    for stride in (1, 4):
        multi, _ = _port_run(bridged, (4,), host_stride=stride,
                             samplers=greedy)
        assert multi[0] == legacy[0]
    soft, _ = _port_run(bridged, (4,), host_stride=4,
                        samplers=(("SoftmaxBaseline", {}),))
    assert soft[0] == legacy[0]


# ---------------------------------------------------------------------------
# Bounded-lag stop sequences: trim + rewind at every (stride, position)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("stop_at", [0, 3, 6])
def test_stop_trimmed_at_stride_granularity(bridged, stride, stop_at):
    """A stop match inside a K-token block: everything after it is
    trimmed before emission and the slot's blocks rewound -- the tokens
    of per-token stop checking (the JAX engine's at stride 1) at any
    stride and any match position."""
    probe = _jax_run(bridged, (3,), host_stride=1, max_new=12,
                     samplers=MIXED)
    g0 = probe[0][0]
    stop = (g0[stop_at],) if stop_at == 0 else tuple(g0[stop_at:stop_at + 2])
    end = next(j + 1 for j in range(len(stop) - 1, len(g0))
               if tuple(g0[j - len(stop) + 1:j + 1]) == stop)
    stops = ((stop,), (), ())
    ref = _jax_run(bridged, (3,), host_stride=1, max_new=12,
                   samplers=MIXED, stops=stops)
    assert ref[0][0] == g0[:end] and ref[1][0] == "stop"
    got, eng = _port_run(bridged, (3,), host_stride=stride, max_new=12,
                         samplers=MIXED, stops=stops)
    assert got[0][0] == g0[:end], \
        f"stride={stride} stop_at={stop_at}: overrun not trimmed"
    assert got[1][0] == "stop"
    # the other rows ride the same blocks, untouched by the trim
    assert got[0][1:] == ref[0][1:]
    _assert_pool_drained(eng)                   # rewind + release


def test_eos_halts_inside_device_loop(bridged):
    """eos met in the loop: the row emits it, halts for the rest of the
    block and finishes 'eos' where the JAX engine's does."""
    probe = _jax_run(bridged, (3,), host_stride=1, max_new=12)
    g1 = probe[0][1]
    eos_tok = next(t for t in g1[4:] if t not in g1[:4]
                   and t not in probe[0][0] and t not in probe[0][2])
    ref = _jax_run(bridged, (3,), host_stride=1, max_new=12, eos_id=eos_tok)
    assert ref[1][1] == "eos" and len(ref[0][1]) < 12
    for stride in (4, 8):
        got, _ = _port_run(bridged, (3,), host_stride=stride, max_new=12,
                           eos_id=eos_tok)
        assert got[0] == ref[0] and got[1] == ref[1]


# ---------------------------------------------------------------------------
# Cancel mid-stride: trim, free, admit
# ---------------------------------------------------------------------------
def _cancel_case(jax_side, bridged):
    eng_cls, req_cls, sp_cls = ((JEngine, JRequest, JSP) if jax_side
                                else (TEngine, TRequest, TSP))
    params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
    rng = np.random.default_rng(3)
    hog = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    waiter = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    eng = eng_cls(params, cfg, n_slots=2, max_len=64, eos_id=-1,
                  kv_layout="paged", host_stride=8, block_size=8,
                  num_blocks=3)
    reqs = [req_cls(0, hog.copy(), params=sp_cls(max_new_tokens=40,
                                                  seed=100)),
            req_cls(1, waiter.copy(), params=sp_cls(max_new_tokens=4,
                                                     seed=101))]
    cancelled = {}

    def consumer(c):
        # cancel the hog on its third token, mid-drain of a stride-8 block
        if c.rid == 0 and c.index == 2 and not cancelled:
            cancelled["at"] = c.token
            assert eng.cancel(reqs[0])

    eng.add_consumer(consumer)
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=10000)
    assert cancelled, "cancel consumer never fired"
    return reqs, eng


def test_cancel_mid_stride_trims_frees_and_admits(bridged):
    want, _ = _cancel_case(True, bridged)
    reqs, eng = _cancel_case(False, bridged)
    assert reqs[0].finish_reason == "cancelled"
    assert len(reqs[0].generated) == 3          # trimmed at the cancel
    assert reqs[1].done and len(reqs[1].generated) == 4
    assert [r.generated for r in reqs] == [r.generated for r in want]
    _assert_pool_drained(eng)
    assert eng.stats["cancelled"] == 1


# ---------------------------------------------------------------------------
# Preemption / deferral and chunked prefill compose
# ---------------------------------------------------------------------------
def test_preemption_identity_under_tight_pool(bridged):
    """The keyed streams survive preempt-to-queue and re-prefill: a tight
    pool (which must preempt) serves the ample pool's tokens, and both
    the JAX engine's."""
    topk = (("TopK", {"k": 4, "temperature": 0.8}),)
    kw = dict(host_stride=4, max_new=12, n_slots=2, samplers=topk,
              block_size=8)
    ample, _ = _port_run(bridged, (3, 5, False), **kw)
    tight, eng = _port_run(bridged, (3, 5, False), num_blocks=4, **kw)
    assert eng.stats["preemptions"] >= 1        # scheduling did differ
    assert tight[0] == ample[0]
    want = _jax_run(bridged, (3, 5, False), num_blocks=4, **kw)
    assert tight[0] == want[0] and tight[2] == want[2]


def test_chunked_prefill_composes_with_host_stride(bridged):
    """Iterations with a mid-prefill slot run the single fused step, still
    keyed; pure-decode iterations ride the loop -- the tokens of stride-1
    one-shot serving, and the JAX engine's stats."""
    mixers = (("Greedy", {}), ("Temperature", {"temperature": 0.7}))
    ref, _ = _port_run(bridged, (4,), host_stride=1, samplers=mixers)
    got, eng = _port_run(bridged, (4,), host_stride=8, samplers=mixers,
                         chunk_size=4)
    assert eng.stats["prefill_chunks"] > 0      # chunking did engage
    assert eng.stats["decode_steps"] > 0
    assert got[0] == ref[0]
    want = _jax_run(bridged, (4,), host_stride=8, samplers=mixers,
                    chunk_size=4)
    assert got == want


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------
def test_submit_gates_reject_incompatible_requests(bridged):
    eng = TEngine(bridged[1], TCFG, n_slots=2, max_len=64, eos_id=-1,
                  host_stride=4)
    p = _prompts(1)[0]
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.submit(TRequest(0, p.copy(), params=TSP(spec_k=2)))
    with pytest.raises(ValueError, match="n_candidates"):
        eng.submit(TRequest(1, p.copy(), params=TSP(n_candidates=4)))

    class HostOnly(tsampler.Greedy):
        # a sampler that never grew a device sampling form
        sample_device = tsampler.Sampler.sample_device

    with pytest.raises(ValueError, match="no device sampling form"):
        eng.submit(TRequest(2, p.copy(), sampler=HostOnly()))
    assert not eng.queue
    with pytest.raises(ValueError):
        TEngine(bridged[1], TCFG, n_slots=2, max_len=64, host_stride=0)


def test_submit_derives_keys_as_jax(bridged):
    """A request's key: key(params.seed), else fold_in(key(engine seed),
    rid) -- the JAX engine's ``prng_key``."""
    p = _prompts(1)[0]
    for seed, rid in ((None, 7), (None, 0), (42, 3)):
        js, ts = [cls(bridged[i], cfg, n_slots=2, max_len=64, host_stride=2,
                      seed=11)
                  for i, (cls, cfg) in enumerate(((JEngine, JCFG),
                                                  (TEngine, TCFG)))]
        jr = JRequest(rid, p.copy(), params=JSP(seed=seed))
        tr = TRequest(rid, p.copy(), params=TSP(seed=seed))
        js.submit(jr)
        ts.submit(tr)
        np.testing.assert_array_equal(tr.prng_key.numpy(),
                                      np.asarray(jr.prng_key, np.int64))


def test_incapable_config_is_refused(bridged):
    """``host_stride`` where the loop cannot run (the cohort scheduler has
    no grouped multi-sampler step body) warns and serves one token at a
    time, as the reference's ``test_incapable_config_warns_and_falls_back``
    does: the JAX engine's tokens."""
    p = np.random.default_rng(3).integers(
        0, TCFG.vocab_size, 9).astype(np.int32)
    gens = []
    for make, req, sp in ((TEngine, TRequest, TSP), (JEngine, JRequest, JSP)):
        params = bridged[1] if make is TEngine else bridged[0]
        cfg = TCFG if make is TEngine else JCFG
        with pytest.warns(UserWarning, match="host_stride=4 ignored"):
            eng = make(params, cfg, n_slots=2, max_len=64, eos_id=-1,
                       host_stride=4, scheduler="cohort")
        assert eng.host_stride is None
        r = req(0, p.copy(), params=sp(max_new_tokens=4))
        eng.submit(r)
        eng.run()
        gens.append(list(r.generated))
    assert len(gens[0]) == 4 and gens[0] == gens[1]


# ---------------------------------------------------------------------------
# Stats contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [None, 1, 8])
def test_host_syncs_and_tokens_per_dispatch(bridged, stride):
    """``host_syncs`` counts every dispatch (one-shot prefills + decode
    calls of either shape), ``emitted_tokens`` every token; both, and
    their ratio, equal the JAX engine's."""
    got, eng = _port_run(bridged, (4,), host_stride=stride, max_new=12,
                         n_slots=2)
    want = _jax_run(bridged, (4,), host_stride=stride, max_new=12,
                    n_slots=2)
    assert got == want
    s = got[2]
    assert s["emitted_tokens"] == sum(len(g) for g in got[0])
    assert s["host_syncs"] == s["prefills"] + s["decode_steps"]
    assert s["tokens_per_dispatch"] == pytest.approx(
        s["emitted_tokens"] / s["host_syncs"])


def test_stride_amortizes_dispatches(bridged):
    """Stride 8 needs ~8x fewer decode dispatches for the same tokens."""
    s1 = _port_run(bridged, (4,), host_stride=1, max_new=12, n_slots=2)[0][2]
    s8 = _port_run(bridged, (4,), host_stride=8, max_new=12, n_slots=2)[0][2]
    assert s1["emitted_tokens"] == s8["emitted_tokens"]
    assert s8["decode_steps"] * 4 <= s1["decode_steps"]
    assert s8["tokens_per_dispatch"] > 2 * s1["tokens_per_dispatch"]


# ---------------------------------------------------------------------------
# The reference's compositions with host_stride
# ---------------------------------------------------------------------------
def _shared_prompts(n=4, shared_len=16, suffix_len=4, seed=17):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, TCFG.vocab_size, shared_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, TCFG.vocab_size, suffix_len).astype(np.int32)]) for _ in range(n)]


def test_prefix_sharing_composes_with_host_stride(bridged):
    """``tests/test_prefix_cache.py``'s host_stride line: prefix sharing
    on (chunked, hits) at stride 4 serves the tokens of sharing off, and
    the JAX engine's."""
    prompts = _shared_prompts()

    def run(jax_side, **kw):
        eng_cls, req_cls, sp_cls = ((JEngine, JRequest, JSP) if jax_side
                                    else (TEngine, TRequest, TSP))
        params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
        eng = eng_cls(params, cfg, n_slots=1, max_len=64, eos_id=1,
                      block_size=4, chunk_size=8, **kw)
        reqs = [req_cls(i, p.copy(), params=sp_cls(max_new_tokens=8))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.generated) for r in reqs], eng.snapshot()

    base, _ = run(False, prefix_cache=False)
    multi, s_multi = run(False, prefix_cache=True, host_stride=4)
    assert multi == base, "prefix + host_stride diverged"
    assert s_multi["prefix_hits"] > 0
    want, s_want = run(True, prefix_cache=True, host_stride=4)
    assert multi == want
    assert s_multi["prefix_hits"] == s_want["prefix_hits"]
    assert s_multi["host_syncs"] == s_want["host_syncs"]


@pytest.mark.parametrize("mode", ["exact", "pseudo"])
def test_approximate_attention_under_host_stride(bridged, mode):
    """``tests/test_attn_approx.py``'s host_stride line: the loop runs the
    engine's score function in every iteration -- exact equals the
    default engine, and each mode the JAX engine's tokens."""
    kw = dict(max_new=8, n_slots=2, samplers=(("Greedy", {}),),
              attn_approx=mode, eos_id=1)
    got, eng = _port_run(bridged, (4, 0), host_stride=4, **kw)
    want = _jax_run(bridged, (4, 0), host_stride=4, **kw)
    assert got[0] == want[0]
    assert eng.snapshot()["tokens_per_dispatch"] > 1.0
    if mode == "exact":
        base, _ = _port_run(bridged, (4, 0), host_stride=None,
                            **{k: v for k, v in kw.items()
                               if k != "attn_approx"})
        assert got[0] == base[0]


@pytest.mark.parametrize("host_stride", [None, 4])
def test_cancel_mid_stream_frees_blocks_and_admits_queued(bridged,
                                                          host_stride):
    """``tests/test_serve_api.py``'s cancel through ``LLM.stream``: the hog
    is cancelled mid-drain (at stride 4 mid-block), its blocks free at
    once and the deferred waiter admits and finishes with the JAX
    engine's tokens."""
    def run(jax_side):
        llm_cls, sp_cls = (JLLM, JSP) if jax_side else (TLLM, TSP)
        params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
        llm = llm_cls(params, cfg, n_slots=2, max_len=64, eos_id=-1,
                      block_size=8, num_blocks=3, host_stride=host_stride)
        hog = np.arange(2, 18, dtype=np.int32) % cfg.vocab_size
        waiter_prompt = np.arange(3, 11, dtype=np.int32) % cfg.vocab_size
        it = llm.stream(hog, sp_cls(max_new_tokens=40))
        first = next(it)
        assert first.finish_reason is None
        assert llm.kv_usage()["blocks_free"] == 0
        waiter = llm.submit(waiter_prompt, sp_cls(max_new_tokens=4))
        with llm._lock:
            for _ in range(3 if host_stride is None else 1):
                llm.engine.step()
        assert not waiter.generated and llm.stats["deferred"] >= 1
        it.close()                                 # client disconnects
        assert llm.stats["cancelled"] == 1
        kv = llm.kv_usage()
        assert kv["blocks_free"] == kv["num_blocks"]
        llm._drive_until(lambda: waiter.done)
        kv = llm.kv_usage()
        assert kv["blocks_free"] == kv["num_blocks"]
        return first.token, list(waiter.generated)

    got = run(False)
    assert len(got[1]) == 4
    assert got == run(True)


def test_stream_on_a_host_stride_engine(bridged):
    """``LLM.stream`` on a stride-4 engine yields the generate tokens one
    chunk at a time, the last with its finish reason."""
    llm = TLLM(bridged[1], TCFG, n_slots=2, max_len=64, host_stride=4)
    p = _prompts(1)[0]
    sp = TSP(max_new_tokens=9, head_mode="temperature", temperature=0.7,
             seed=3)
    chunks = list(llm.stream(p, sp))
    assert [c.index for c in chunks] == list(range(9))
    assert chunks[-1].finish_reason == "length"
    out = llm.generate([p], sp)[0]
    assert [c.token for c in chunks] == list(out.token_ids)


# ---------------------------------------------------------------------------
# The loop's graph: bucket key, counters, and (on the card) its bits
# ---------------------------------------------------------------------------
def test_loop_bucket_key_follows_the_full_samplers(bridged):
    """A loop bucket's key: B, nb, the stride, the FULL samplers (two
    temperatures are two groups, where the single step's device forms
    share one) and the group sizes, apart from every step key."""
    a = tsampler.Temperature(0.7)
    b = tsampler.Temperature(0.9)
    k1 = step_graph.loop_key([a, b], 4, 2, 8, [4, 4])
    k2 = step_graph.loop_key([a], 4, 2, 8, [4])
    assert k1 != k2 and k1[0] == "loop"
    assert k1 != step_graph.bucket_key([a, b], (4, 1), (4, 2), [4, 4], 0)
    assert a.device_form() == b.device_form()


def test_loop_launch_counters_add_each_replay():
    """``replay(times=n)`` adds the capture's counter delta n times, so a
    counter reads the launches n replays ran (the loop's K replays)."""
    wrappers = step_graph.kernel_wrappers()
    pa = wrappers["paged_attention"]
    before = step_graph.read_counts(wrappers)
    delta = {("paged_attention", "launches", None): 28}
    step_graph.add_counts(wrappers, delta, 5)
    after = step_graph.read_counts(wrappers)
    assert step_graph.count_delta(before, after) == {
        ("paged_attention", "launches", None): 140}
    step_graph.add_counts(wrappers, delta, -5)
    assert pa.launches == before[("paged_attention", "launches", None)]


def test_eager_loop_carry_rules(bridged):
    """``serve_decode_multi`` on the CPU: caps bound each row, eos halts
    after emitting it, a padding row (cap 0) never emits, ``out`` is -1
    past each row's count, keys advance once per emitted token of a
    sampler that draws (and not at all for greedy) and the loop leaves
    once no row is active."""
    eng = TEngine(bridged[1], TCFG, n_slots=4, max_len=64, eos_id=-1,
                  host_stride=8)
    reqs = [TRequest(i, p.copy(), params=TSP(max_new_tokens=1, seed=i))
            for i, p in enumerate(_prompts(3))]
    for r in reqs:
        eng.submit(r)
    eng.step()                        # prefill: each emits its first token
    rows = [0, 1, 2]
    pos = torch.tensor([int(eng.slot_pos[i]) for i in rows] + [0],
                       dtype=torch.int32)
    pos[3] = pos[0]
    tok = torch.tensor([r.generated[-1] for r in reqs] + [0])
    tok[3] = tok[0]
    for i in rows:
        eng.store.ensure_capacity(i, int(pos[i]) + 7)
    btab = torch.as_tensor(eng.store.block_table(
        rows + [0], (pos + 7).numpy()))
    keys = torch.stack([r.prng_key for r in reqs] + [reqs[0].prng_key])
    caps = torch.tensor([5, 2, 8, 0], dtype=torch.int32)
    s = tsampler.TopK(4, temperature=0.8)
    out, emitted, new_keys, ran = tapi.serve_decode_multi(
        eng.params, eng.cfg, tok, eng.store.cache(), pos, keys, caps,
        [torch.arange(4)], steps=8, eos_id=-1, samplers=[s],
        block_tables=btab)
    assert emitted.tolist() == [5, 2, 8, 0] and ran == 8
    assert (out[3] == -1).all() and (out[1, 2:] == -1).all()
    assert (out[0, :5] >= 0).all() and (out[0, 5:] == -1).all()
    k = keys[1]
    for _ in range(2):
        k = prng.split(k)[0]
    assert torch.equal(new_keys[1], k) and torch.equal(new_keys[3], keys[3])
    _, _, greedy_keys, _ = tapi.serve_decode_multi(
        eng.params, eng.cfg, tok, eng.store.cache(), pos, keys, caps,
        [torch.arange(4)], steps=8, eos_id=-1, samplers=[tsampler.Greedy()],
        block_tables=btab)
    assert torch.equal(greedy_keys, keys)       # greedy draws nothing
    eos = int(out[2, 3])
    out2, emitted2, _, ran2 = tapi.serve_decode_multi(
        eng.params, eng.cfg, tok, eng.store.cache(), pos, keys, caps,
        [torch.arange(4)], steps=8, eos_id=eos, samplers=[s],
        block_tables=btab)
    want = []
    for r in range(4):
        row = out[r, :int(caps[r])].tolist()
        want.append(row.index(eos) + 1 if eos in row else len(row))
    assert emitted2.tolist() == want and ran2 == max(want)
    assert int(out2[2, want[2] - 1]) == eos and (out2[2, want[2]:] == -1).all()


@pytest.mark.cuda
def test_graphed_dispatch_equals_eager_loop_on_the_card():
    """On the card: the replayed loop iteration's (out, emitted, keys)
    equal the eager loop's bit for bit on the same operands, mixed
    samplers at stride 8, and the launch counters read 28 x (layers)
    paged launches per replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    llm = TLLM.from_arch("qwen3-0.6b", smoke=True, device="cuda",
                         n_slots=4, max_len=64, host_stride=8)
    eng = llm.engine
    prompts = _prompts(4)
    sps = [TSP(max_new_tokens=24, seed=i, **kw) for i, kw in enumerate(
        ({}, {"top_k": 4, "temperature": 0.8},
         {"head_mode": "temperature", "temperature": 0.7}, {}))]
    with step_graph.eager_steps():
        eager = llm.generate(prompts, sps)
    for _ in range(2):                  # first dispatches, then captures
        graphed = llm.generate(prompts, sps)
        assert [o.token_ids for o in graphed] == [o.token_ids
                                                  for o in eager]
    assert eng.graphs.captures > 0 and eng.graphs.replays > 0


@pytest.mark.cuda
def test_keyed_draw_on_the_card_equals_cpu():
    """The keyed draw's integer half (keys, bits, uniforms) on the card
    equals the CPU's bit for bit; the Gumbel noise within two ulps at its
    scale; a full-vocabulary categorical the same index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    keys = prng.split(prng.key(7), 8)
    dev = keys.cuda()
    assert torch.equal(prng.split(dev).cpu(), prng.split(keys))
    assert torch.equal(prng.random_bits(dev, (151936,)).cpu(),
                       prng.random_bits(keys, (151936,)))
    assert torch.equal(prng.uniform(dev, (151936,)).cpu(),
                       prng.uniform(keys, (151936,)))
    g, gc = prng.gumbel(dev, (151936,)).cpu(), prng.gumbel(keys, (151936,))
    scale = torch.clamp_min(gc.abs(), 1.0)
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    # each device's log is within an ulp of the exact value, so the two
    # may lie two apart (the CPU's is pinned to XLA's within one)
    assert ((g.double() - gc.double()).abs() <= 2 * ulp.double()).all()
    logits = 4 * torch.randn(8, 151936, generator=torch.Generator()
                             .manual_seed(0))
    assert torch.equal(prng.categorical(dev, logits.cuda()).cpu(),
                       prng.categorical(keys, logits))
