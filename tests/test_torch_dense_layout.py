"""The dense KV layout in the port against the JAX package, on bridged
weights at the smoke size of qwen3-0.6b (f32).

- the linear dense-cache branch of ``layers.attention`` with a scalar,
  (B,) and (B, T) ``cache_pos``, with and without the window mask,
  against ``repro.models.layers.attention`` at ``F32_TOL`` (output and
  the written cache); a cache exactly ``window`` long (the reference's
  ring buffer) refuses more than one query a row, as the reference's
  does (the ring at T = 1 is held to JAX in ``test_torch_hybrid.py``);
- ``lm.decode_step`` on a dense cache (no block tables) against the
  reference's, and through ``cache_rows`` into a larger store;
- the store's dense layout: no blocks, no trie, ``admit`` copies a
  prefill row, ``usage()["layout"]``;
- the engine mirrors of ``tests/test_serve_paged.py`` (dense == paged
  generations, overcommit and preemption, a preemption inside a cohort
  at a block boundary, lowest-index tie breaking on both layouts, the
  staggered fused step, a paged re-prefill): the port's dense tokens
  equal the JAX dense engine's and the port's paged engine's;
- ``spec_k`` and ``host_stride`` 4 on the dense layout against the JAX
  engine; ``chunk_size`` on a dense store warns and admits one-shot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.paged_kv import PagedKVStore  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, np_tree, weights.from_numpy_params(np_tree, TCFG, "cpu")


# ---------------------------------------------------------------------------
# The dense branch of attention, lm.decode_step
# ---------------------------------------------------------------------------
def _layer0(np_tree):
    attn = np_tree["decoder"][0]["slot0"]["attn"]
    return {k: v[0] for k, v in attn.items()}


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("form", ["scalar", "rows", "matrix"])
def test_dense_attention_matches_jax(bridged, form, window):
    """One layer's dense branch: a scalar cache_pos (T = 3 consecutive
    queries, every row at one position), (B,) at T = 1 and (B, T) at T =
    4 (ragged, the last query repeating its row's last position)."""
    _, np_tree, _ = bridged
    p = _layer0(np_tree)
    rng = np.random.default_rng({"scalar": 1, "rows": 2, "matrix": 3}[form])
    b, s = 3, 24
    hkv, hd = TCFG.n_kv_heads, TCFG.head_dim
    if form == "scalar":
        t, cp = 3, np.int32(9)
        positions = cp + np.arange(t, dtype=np.int32)
    elif form == "rows":
        t, cp = 1, np.array([0, 7, 20], np.int32)
        positions = cp[:, None]
    else:
        t = 4
        cp = np.array([[3, 4, 5, 5], [10, 11, 12, 13], [0, 0, 0, 0]],
                      np.int32)
        positions = cp
    x = rng.standard_normal((b, t, TCFG.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    jout, jnew = jlayers.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), JCFG,
        positions=jnp.asarray(positions), window=window,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_pos=jnp.asarray(cp))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    consts = tlayers.step_constants(
        TCFG, torch.from_numpy(np.asarray(positions)),
        cache_pos=torch.from_numpy(np.asarray(cp)), cache_len=s,
        window=window)
    out, new = tlayers.attention(tp, torch.from_numpy(x), TCFG,
                                 consts=consts, window=window, cache=cache)
    assert new is cache
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=F32_TOL,
                               atol=F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jnew[name]), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_ring_buffer_cache_is_refused(bridged):
    """A ring buffer takes one query a row: a window of T = 2 queries
    into a cache exactly ``window`` long is refused."""
    _, np_tree, _ = bridged
    tp = {k: torch.from_numpy(np.array(v)) for k, v in _layer0(np_tree).items()}
    pos = torch.tensor([3], dtype=torch.int32)
    consts = tlayers.step_constants(TCFG, pos[:, None] + torch.arange(2),
                                    cache_pos=pos, cache_len=8, window=8)
    assert consts.ring
    cache = {n: torch.zeros(1, 8, TCFG.n_kv_heads, TCFG.head_dim)
             for n in ("k", "v")}
    with pytest.raises(NotImplementedError, match="ring-buffer"):
        tlayers.attention(tp, torch.zeros(1, 2, TCFG.d_model), TCFG,
                          consts=consts, window=8, cache=cache)


def _dense_cache(rng, n, s):
    shape = (TCFG.n_layers, n, s, TCFG.n_kv_heads, TCFG.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("form", ["scalar", "rows", "matrix"])
def test_decode_step_on_a_dense_cache_matches_jax(bridged, form):
    jparams, _, tparams = bridged
    rng = np.random.default_rng(11)
    b, s = 3, 20
    kc, vc = _dense_cache(rng, b, s)
    if form == "scalar":
        t, pos = 1, np.int32(6)
    elif form == "rows":
        t, pos = 1, np.array([2, 9, 17], np.int32)
    else:
        t, pos = 3, np.array([[4, 5, 6], [0, 1, 1], [12, 13, 14]], np.int32)
    toks = rng.integers(0, TCFG.vocab_size, size=(b, t)).astype(np.int32)
    jh, jnew = jlm.decode_step(
        jparams, JCFG, jnp.asarray(toks),
        [{"slot0": {"attn": {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}}}],
        jnp.asarray(pos))
    leaves = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    th, _ = tlm.decode_step(tparams, TCFG, torch.from_numpy(toks).long(),
                            [{"slot0": {"attn": leaves}}],
                            torch.from_numpy(np.asarray(pos)))
    assert tuple(th.shape) == np.asarray(jh).shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL,
                               atol=F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            leaves[name].numpy(), np.asarray(jnew[0]["slot0"]["attn"][name]),
            rtol=F32_TOL, atol=F32_TOL)


def test_decode_step_through_cache_rows(bridged):
    """Rows 0..2 of the batch in cache rows 4, 1, 4 of a 5-row store (the
    third a padding copy of the first): the same hidden states as on the
    gathered rows, rows 4 and 1 written, the others untouched."""
    _, _, tparams = bridged
    rng = np.random.default_rng(12)
    kc, vc = _dense_cache(rng, 5, 16)
    rows = torch.tensor([4, 1, 4])
    toks = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (3, 1))).long()
    toks[2] = toks[0]
    pos = torch.tensor([7, 3, 7], dtype=torch.int32)
    store = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, _ = tlm.decode_step(tparams, TCFG, toks, [{"slot0": {"attn": store}}],
                             pos, cache_rows=rows)
    sub = {n: torch.from_numpy(a[:, [4, 1, 4]].copy())
           for n, a in (("k", kc), ("v", vc))}
    want, _ = tlm.decode_step(tparams, TCFG, toks, [{"slot0": {"attn": sub}}],
                              pos)
    assert torch.equal(got, want)
    for n, a in (("k", kc), ("v", vc)):
        assert torch.equal(store[n][:, [4, 1]], sub[n][:, :2])
        assert np.array_equal(store[n][:, [0, 2, 3]].numpy(), a[:, [0, 2, 3]])


def test_dense_store_allocates_nothing(bridged):
    _, _, tparams = bridged
    st = PagedKVStore(TCFG, n_slots=3, max_len=32, device="cpu",
                      block_size=8, layout="dense")
    assert not st.any_paged and st.pools is None
    dense = st.denses[0]["slot0"]["attn"]        # the model's cache tree
    assert st.cache() is st.denses
    assert dense["k"].shape == (TCFG.n_layers, 3, 32, TCFG.n_kv_heads,
                                TCFG.head_dim)
    assert st.usage()["layout"] == "dense"
    assert (st.usage()["paged_leaves"], st.usage()["dense_leaves"]) == (0, 2)
    assert st.can_admit(31) and st.can_ever_admit(10 ** 6)
    assert st.ensure_capacity(0, 31) and st.can_grow(0, 31)
    assert st.prefill_len(5) == 32 and st.blocks_for(100) == 0
    assert st.block_table([0, 1], [3, 9]) is None
    assert st.match_prefix(np.arange(20)) == ([], 0)
    cache = tlm.init_cache(TCFG, 1, 32, "cpu")
    for leaf in cache[0]["slot0"]["attn"].values():
        leaf.normal_()
    st.admit(1, cache)
    for n in ("k", "v"):
        assert torch.equal(dense[n][:, 1], cache[0]["slot0"]["attn"][n][:, 0])
        assert not dense[n][:, [0, 2]].any()
    st.release(1, publish_tokens=np.arange(16, dtype=np.int32))
    assert st.allocator.n_free == st.allocator.num_blocks
    assert st.prefix_trie.nodes == 0
    with pytest.raises(ValueError, match="layout"):
        PagedKVStore(TCFG, n_slots=1, max_len=8, device="cpu", layout="ring")


# ---------------------------------------------------------------------------
# Engine mirrors of tests/test_serve_paged.py
# ---------------------------------------------------------------------------
def _run(side, params, prompts, max_new, **kw):
    eng_cls, req_cls = (JEngine, JRequest) if side == "jax" \
        else (TEngine, TRequest)
    eng = eng_cls(params, JCFG if side == "jax" else TCFG, eos_id=1, **kw)
    reqs = [req_cls(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng


def _lengths(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _random_lengths(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size,
                         size=int(rng.integers(3, 25))).astype(np.int32)
            for _ in range(n)]


# (reference test, prompts, max_new, shared engine kwargs, paged kwargs)
MIRRORS = {
    "paged_equals_dense_generations": (
        lambda: _random_lengths(3, 7), 6, dict(n_slots=3, max_len=48),
        dict(block_size=8)),
    "paged_overcommit_preempts": (
        lambda: _lengths(5, (8,) * 3), 12, dict(n_slots=2, max_len=64),
        dict(block_size=8, num_blocks=4)),
    "preempt_within_cohort_at_block_boundary": (
        lambda: _lengths(13, (8,) * 2), 12, dict(n_slots=2, max_len=64),
        dict(block_size=8, num_blocks=3)),
    "fused_ragged_paged_equals_dense_staggered": (
        lambda: _lengths(37, (3, 8, 9, 17, 26)), 6,
        dict(n_slots=5, max_len=48), dict(block_size=8)),
    "preempt_reprefill_paged_native": (
        lambda: _lengths(59, (9,) * 3), 13, dict(n_slots=2, max_len=64),
        dict(block_size=8, num_blocks=5)),
}


@pytest.mark.parametrize("case", sorted(MIRRORS))
def test_dense_engine_mirrors(bridged, case):
    jparams, _, tparams = bridged
    make, max_new, kw, paged_kw = MIRRORS[case]
    prompts = make()
    jdense, je = _run("jax", jparams, prompts, max_new, kv_layout="dense",
                      **kw)
    tdense, te = _run("torch", tparams, prompts, max_new, kv_layout="dense",
                      **kw)
    tpaged, tpe = _run("torch", tparams, prompts, max_new,
                       kv_layout="paged", **kw, **paged_kw)
    assert tdense == jdense
    assert tpaged == tdense
    for k in ("prefills", "decode_steps", "iterations", "fused_rows",
              "preemptions"):
        assert te.stats[k] == je.stats[k], k
    assert te.stats["preemptions"] == 0
    assert te.stats["decode_steps"] == te.stats["iterations"]
    alloc = tpe.store.allocator
    assert alloc.n_free == alloc.num_blocks
    if "num_blocks" in paged_kw:
        assert tpe.stats["preemptions"] >= 1


def _tied(np_tree, dup_pairs):
    """The tree with head columns duplicated so those ids tie exactly."""
    emb = np_tree["embed"].copy()               # tied: the head is embed.T
    for lo, hi in dup_pairs:
        emb[hi] = emb[lo]
    return {**np_tree, "embed": emb}


@pytest.mark.parametrize("head_mode", ["reduced", "fused", "softmax"])
def test_tie_breaking_lowest_index_both_layouts(bridged, head_mode):
    """Exactly tied logits (duplicated head rows) resolve to the lowest
    id on both layouts, with the JAX engine's tokens."""
    _, np_tree, _ = bridged
    assert TCFG.tie_embeddings
    tied = _tied(np_tree, [(10, 200), (10, 77)])
    jparams = jax.tree.map(jnp.asarray, tied)
    tparams = weights.from_numpy_params(tied, TCFG, "cpu")
    prompts = _lengths(2, (6, 6))
    gens = []
    for layout in ("paged", "dense"):
        kw = dict(n_slots=2, max_len=32, head_mode=head_mode,
                  kv_layout=layout)
        want, _ = _run("jax", jparams, prompts, 4, **kw)
        got, _ = _run("torch", tparams, prompts, 4, **kw)
        assert got == want
        for g in got:
            assert 200 not in g and 77 not in g, (head_mode, layout, g)
        gens.append(got)
    assert gens[0] == gens[1]


# ---------------------------------------------------------------------------
# spec_k, host_stride and chunk_size on the dense layout
# ---------------------------------------------------------------------------
def _serve_params(side, params, prompts, sp, **kw):
    eng_cls, req_cls, sp_cls = ((JEngine, JRequest, JSP) if side == "jax"
                                else (TEngine, TRequest, TSP))
    eng = eng_cls(params, JCFG if side == "jax" else TCFG, eos_id=-1,
                  n_slots=3, max_len=64, kv_layout="dense", **kw)
    reqs = [req_cls(i, p.copy(), params=sp_cls(**s))
            for i, (p, s) in enumerate(zip(prompts, sp))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng


def _repetitive(seed):
    rng = np.random.default_rng(seed)
    rep = np.tile(rng.integers(0, TCFG.vocab_size, 6), 4).astype(np.int32)
    return [rep, rep[:13].copy(), _lengths(seed, (10,))[0]]


@pytest.mark.parametrize("mode", ["spec_k", "host_stride"])
def test_dense_spec_and_stride_match_jax(bridged, mode):
    """``spec_k=4`` through the (B, T) branch, and ``host_stride=4``
    through the device loop over the dense rows (greedy, top-k and
    temperature, seeded): the JAX dense engine's tokens and dispatch
    counts."""
    jparams, _, tparams = bridged
    prompts = _repetitive(17)
    if mode == "spec_k":
        sp, kw = [dict(max_new_tokens=10, spec_k=4)] * 3, {}
    else:
        sp = [dict(max_new_tokens=10), dict(max_new_tokens=10, top_k=4,
                                            temperature=0.8, seed=1),
              dict(max_new_tokens=10, temperature=0.7, seed=2)]
        kw = dict(host_stride=4)
    want, je = _serve_params("jax", jparams, prompts, sp, **kw)
    got, te = _serve_params("torch", tparams, prompts, sp, **kw)
    assert got == want
    for k in ("decode_steps", "iterations", "host_syncs", "emitted_tokens",
              "drafted", "accepted"):
        assert te.stats[k] == je.stats[k], k
    if mode == "spec_k":
        assert te.stats["accepted"] > 0
    else:
        assert te.stats["decode_iterations"] > te.stats["decode_steps"]


def test_chunk_size_on_a_dense_store_warns_and_admits_one_shot(bridged):
    jparams, _, tparams = bridged
    prompts = _lengths(23, (20, 7, 33))
    sp = [dict(max_new_tokens=6)] * 3
    with pytest.warns(UserWarning, match="chunk_size=8 ignored"):
        got, te = _serve_params("torch", tparams, prompts, sp, chunk_size=8)
    assert te.chunk_size is None and not te.prefix_cache
    assert te.stats["prefill_chunks"] == 0 and te.stats["prefills"] == 3
    want, _ = _serve_params("jax", jparams, prompts, sp)
    assert got == want
