"""Prefix sharing in the port's paged KV store and engine, against the
JAX package on the CPU at the smoke size of qwen3-0.6b (f32), with
weights bridged from JAX.  The counterpart of
``tests/test_prefix_cache.py``.

  - the refcounted allocator, the trie (publish, match with its suffix
    cap, adopt, dedup on re-publish) and LRU eviction of trie-only runs,
    step for step against the JAX store's block ids and counters;
  - copy-on-write on the torch pools: a rewind into a shared block and an
    ``ensure_capacity`` write window over one copy it first, the copy
    bitwise the source in every layer, K and V, the source untouched;
  - engine identity against the JAX engine: tokens and the stats
    ``prefix_hits``, ``prefix_hit_tokens``, ``prefill_tokens``,
    ``cow_copies``, ``peak_in_use``, ``preemptions``, ``deferred``, with
    sharing on and off, under preemption of a sharer, per-request
    opt-out, with ``spec_k``, and ``prefix_cache`` inert without
    ``chunk_size``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.paged_kv import PagedKVStore as JStore  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.paged_kv import BlockAllocator, PagedKVStore  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
STATS = ("prefix_hits", "prefix_hit_tokens", "prefill_tokens",
         "prefill_chunks", "prefills", "cow_copies", "peak_in_use",
         "preemptions", "deferred", "decode_steps", "iterations",
         "completed")


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _stores(bridged, **kw):
    """A JAX store and a port store of the same shape."""
    kw = {"n_slots": 4, "max_len": 32, "block_size": 4, **kw}
    return (JStore(bridged[0], JCFG, **kw),
            PagedKVStore(TCFG, device="cpu", **kw))


def _shared_prompts(n=6, shared_len=24, suffix_len=5, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, TCFG.vocab_size, shared_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, TCFG.vocab_size,
                                                 suffix_len).astype(np.int32)])
            for _ in range(n)]


def _serve(jax_side, bridged, prompts, *, sp=None, n_slots=2, max_len=64,
           chunk_size=8, **kw):
    eng_cls, req_cls, sp_cls = ((JEngine, JRequest, JSP) if jax_side
                                else (TEngine, TRequest, TSP))
    params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
    eng = eng_cls(params, cfg, n_slots=n_slots, max_len=max_len, eos_id=-1,
                  block_size=4, chunk_size=chunk_size, **kw)
    sps = sp if isinstance(sp, list) else \
        [sp or dict(max_new_tokens=6)] * len(prompts)
    reqs = [req_cls(i, p.copy(), params=sp_cls(**s))
            for i, (p, s) in enumerate(zip(prompts, sps))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng.snapshot(), eng


def _both(bridged, prompts, **kw):
    """Serve through both engines; assert the same tokens and stats;
    returns the port's (tokens, snapshot, engine)."""
    jt, js, jeng = _serve(True, bridged, prompts, **kw)
    tt, ts, teng = _serve(False, bridged, prompts, **kw)
    assert tt == jt
    for k in STATS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert teng.store.usage()["prefix_evictions"] \
        == jeng.store.usage()["prefix_evictions"]
    assert teng.store.prefix_trie.nodes == jeng.store.prefix_trie.nodes
    return tt, ts, teng


# ---------------------------------------------------------------------------
# allocator, trie, eviction: the port's store step for step with JAX's
# ---------------------------------------------------------------------------
def test_allocator_refcounts_and_peak():
    a = BlockAllocator(4)
    x = a.alloc(2)
    assert a.peak_in_use == 2
    a.incref([x[0]])
    assert a.refcount(x[0]) == 2 and a.n_shared == 1
    a.free([x[0]])
    assert a.refcount(x[0]) == 1 and a.n_free == 2 and a.n_shared == 0
    a.free(x)
    assert a.n_free == 4
    with pytest.raises(ValueError):
        a.free([x[0]])
    with pytest.raises(ValueError):
        a.incref([x[0]])
    y = a.alloc(3)
    assert a.peak_in_use == 3
    a.free(y)
    assert a.peak_in_use == 3


def test_trie_publish_match_and_suffix_cap(bridged):
    results = []
    for st in _stores(bridged):
        toks = np.arange(12, dtype=np.int32)
        st.slot_blocks[0] = st.allocator.alloc(3)
        blocks = list(st.slot_blocks[0])
        st.release(0, publish_tokens=toks)
        assert st.allocator.n_free == st.allocator.num_blocks - 3
        assert st.prefix_trie.nodes == 3
        div = np.concatenate([toks, [99]])
        div[5] = 77
        got = [st.match_prefix(np.concatenate([toks, [99]])),
               st.match_prefix(toks), st.match_prefix(div)]
        assert got == [(blocks, 12), (blocks[:2], 8), (blocks[:1], 4)]
        results.append(got)
    assert results[0] == results[1]


def test_adopt_increfs_and_republish_dedups(bridged):
    results = []
    for st in _stores(bridged):
        toks = np.arange(8, dtype=np.int32)
        st.slot_blocks[0] = st.allocator.alloc(2)
        blocks = list(st.slot_blocks[0])
        st.release(0, publish_tokens=toks)
        hit = st.adopt_prefix(1, np.concatenate([toks, [50, 51, 52]]))
        assert hit == 8 and st.slot_blocks[1] == blocks
        assert all(st.allocator.refcount(b) == 2 for b in blocks)
        st.release(1, publish_tokens=np.asarray(list(toks) + [50, 51, 52],
                                                np.int32))
        assert st.prefix_trie.nodes == 2
        assert all(st.allocator.refcount(b) == 1 for b in blocks)
        results.append((blocks, st.usage()))
    assert results[0] == results[1]


def _paint(st, block, value):
    for pool in st.pools.values():
        pool[:, block] = value


def test_rewind_into_shared_block_copies_bitwise(bridged):
    """A rewind back into a shared block copies it first: the copy holds
    the source's K and V bits in every layer, the source (the trie's)
    keeps its own, and the JAX store takes the same block ids."""
    jst, st = _stores(bridged)
    ids = []
    for s in (jst, st):
        s.slot_blocks[0] = s.allocator.alloc(2)
        ids.append(list(s.slot_blocks[0]))
    pub = ids[1]
    gen = torch.Generator().manual_seed(5)
    for pool in st.pools.values():
        pool[:, pub] = torch.randn(pool[:, pub].shape, generator=gen)
    before = {k: p.clone() for k, p in st.pools.items()}
    toks = np.arange(8, dtype=np.int32)
    for s in (jst, st):
        s.release(0, publish_tokens=toks)
        assert s.adopt_prefix(1, np.concatenate([toks, [5, 6, 7]])) == 8
        s.rewind(1, 6)
    new = st.slot_blocks[1][1]
    assert new != pub[1] and st.cow_copies == 1
    assert st.slot_blocks == jst.slot_blocks and jst.cow_copies == 1
    assert st.allocator.refcount(pub[1]) == 1
    for k, pool in st.pools.items():
        assert torch.equal(pool[:, new], before[k][:, pub[1]]), k
        assert torch.equal(pool[:, pub[1]], before[k][:, pub[1]]), k
        # nothing else moved
        rest = [b for b in range(pool.shape[1]) if b != new]
        assert torch.equal(pool[:, rest], before[k][:, rest]), k


def test_ensure_capacity_copies_shared_write_range(bridged):
    results = []
    for st in _stores(bridged):
        toks = np.arange(8, dtype=np.int32)
        st.slot_blocks[0] = st.allocator.alloc(2)
        pub = list(st.slot_blocks[0])
        if isinstance(st, PagedKVStore):
            _paint(st, pub[1], 3.0)
        st.release(0, publish_tokens=toks)
        st.adopt_prefix(1, np.concatenate([toks, [5, 6, 7]]))
        assert st.ensure_capacity(1, 9, write_start=6)
        assert len(st.slot_blocks[1]) == 3
        assert st.slot_blocks[1][1] != pub[1] and st.cow_copies == 1
        assert st.ensure_capacity(1, 11, write_start=8)   # no shared cover
        assert st.cow_copies == 1
        if isinstance(st, PagedKVStore):
            for pool in st.pools.values():
                assert bool((pool[:, pub[1]] == 3.0).all())
                assert bool((pool[:, st.slot_blocks[1][1]] == 3.0).all())
        results.append((list(st.slot_blocks[1]), st.usage()))
    assert results[0] == results[1]


def test_eviction_lru_and_never_shared(bridged):
    results = []
    for st in _stores(bridged, num_blocks=4, max_len=16):
        tok_a = np.arange(8, dtype=np.int32)
        tok_b = np.arange(100, 108, dtype=np.int32)
        st.slot_blocks[0] = st.allocator.alloc(2)
        a_blocks = list(st.slot_blocks[0])
        st.release(0, publish_tokens=tok_a)
        st.slot_blocks[0] = st.allocator.alloc(2)
        b_blocks = list(st.slot_blocks[0])
        st.release(0, publish_tokens=tok_b)
        assert st.allocator.n_free == 0 and st.reclaimable_blocks == 4
        assert st.adopt_prefix(1, np.concatenate([tok_b, [9]])) == 8
        assert st.reclaimable_blocks == 2
        assert st.can_admit(8, chunk_size=4)       # reclaimable is free
        got = st._alloc(2)
        assert set(got) == set(a_blocks)
        assert all(st.allocator.refcount(b) == 2 for b in b_blocks)
        assert st.match_prefix(np.concatenate([tok_a, [9]]))[1] == 0
        assert st.match_prefix(np.concatenate([tok_b, [9]]))[1] == 8
        assert st.prefix_evictions == 2
        st.slot_blocks[2] = got
        with pytest.raises(MemoryError):
            st._alloc(1)
        results.append((got, st.usage()))
    assert results[0] == results[1]


def test_eviction_is_lru_ordered(bridged):
    for st in _stores(bridged, num_blocks=6, max_len=16):
        tok_a = np.arange(8, dtype=np.int32)
        tok_b = np.arange(100, 108, dtype=np.int32)
        for toks in (tok_a, tok_b):
            st.slot_blocks[0] = st.allocator.alloc(2)
            st.release(0, publish_tokens=toks)
        st.match_prefix(np.concatenate([tok_a, [9]]))   # B is now LRU
        st._alloc(4)
        assert st.match_prefix(np.concatenate([tok_a, [9]]))[1] == 8
        assert st.match_prefix(np.concatenate([tok_b, [9]]))[1] == 0


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------
def test_engine_prefix_identity_and_stats(bridged):
    prompts = _shared_prompts() + [np.arange(40, 49, dtype=np.int32)]
    off, s_off, _ = _both(bridged, prompts, prefix_cache=False)
    on, s_on, eng = _both(bridged, prompts, prefix_cache=True)
    assert on == off
    assert s_on["prefix_hits"] >= 4 and s_on["prefix_hit_tokens"] >= 4 * 24
    assert s_on["prefill_tokens"] < s_off["prefill_tokens"]
    assert s_off["prefix_hits"] == 0
    u = eng.store.usage()
    for k in ("peak_in_use", "shared_blocks", "cow_copies",
              "blocks_reclaimable", "prefix_blocks", "prefix_evictions"):
        assert k in u, k
    assert u["peak_in_use"] > 0 and u["prefix_blocks"] > 0
    for k in ("prefix_hits", "prefix_hit_tokens", "shared_blocks",
              "cow_copies", "peak_in_use"):
        assert k in s_on, k


def test_preemption_of_a_sharer_keeps_its_sibling_intact(bridged):
    """An overcommitted pool while requests share a prefix: the same
    preemptions, evictions and tokens as JAX, which are the uncontended
    unshared run's; the slots drain and only the trie holds blocks."""
    prompts = _shared_prompts(n=4, shared_len=16, suffix_len=4, seed=11)
    base, _, _ = _serve(False, bridged, prompts, prefix_cache=False,
                        max_len=48)
    got, stats, eng = _both(bridged, prompts, prefix_cache=True,
                            max_len=48, num_blocks=10)
    assert got == base
    assert stats["preemptions"] > 0 and stats["completed"] == len(prompts)
    assert all(b == [] for b in eng.store.slot_blocks)
    assert (eng.store.allocator.n_free + eng.store.prefix_trie.nodes
            == eng.store.allocator.num_blocks)


def test_per_request_opt_out(bridged):
    """``SamplingParams(prefix_cache=False)`` neither adopts nor
    publishes: request 0 (out) leaves the trie empty, request 1 fills
    it, request 2 (out) does not adopt."""
    prompts = _shared_prompts(n=3, seed=13)
    sp = [dict(max_new_tokens=4, prefix_cache=False),
          dict(max_new_tokens=4), dict(max_new_tokens=4, prefix_cache=False)]
    got, stats, eng = _both(bridged, prompts, sp=sp, n_slots=1)
    assert stats["prefix_hits"] == 0 and eng.store.prefix_trie.nodes > 0
    cold, _, _ = _serve(False, bridged, prompts, prefix_cache=False,
                        n_slots=1, sp=dict(max_new_tokens=4))
    assert got == cold


def test_prefix_with_spec_matches_jax(bridged):
    prompts = _shared_prompts(n=4, shared_len=16, suffix_len=4, seed=17)
    base, _, _ = _serve(False, bridged, prompts, prefix_cache=False,
                        sp=dict(max_new_tokens=8))
    got, stats, _ = _both(bridged, prompts, prefix_cache=True,
                          sp=dict(max_new_tokens=8, spec_k=3))
    assert got == base and stats["prefix_hits"] > 0


def test_prefix_cache_without_chunk_size_serves_cold(bridged):
    prompts = _shared_prompts(n=3, seed=19)
    got, stats, eng = _both(bridged, prompts, prefix_cache=True,
                            chunk_size=None)
    assert not eng.prefix_cache and eng.chunk_size is None
    assert stats["prefix_hits"] == 0 and eng.store.prefix_trie.nodes == 0
    assert eng.store.allocator.n_free == eng.store.allocator.num_blocks
    base, _, _ = _serve(False, bridged, prompts, prefix_cache=False)
    assert got == base
