"""The decode step as one program (``repro_torch.serve.step_graph``) and
the hoisted step constants, on the CPU at the smoke size of qwen3-0.6b
(2 layers, d = 64, V = 256, f32), with weights bridged from the JAX
package:

  - ``lm.decode_step``, its RoPE table and paged indices computed once a
    step (``layers.step_constants``), against the JAX ``decode_step`` at
    T 1 and 4 (1e-4, as ``test_torch_model.py``), and bitwise against a
    per-layer reconstruction here that calls the public ``apply_rope``;
  - the graph cache's bucket key: equal across steps of one shape and
    across splits of one batch between the Greedy and verify groups
    (each padded to B), different across B, nb, T, the sampler tuple, a
    group's padded size and the verify group; a bucket captures on its
    second step;
  - the launch-counter arithmetic of a capture and its replays, on a
    fake counter set;
  - a CPU engine captures nothing, ``eager_steps()`` nests and
    restores, and a capture runs with the garbage collector off;
  - the Temperature and softmax-baseline heads on the CPU keep the bits
    of ``h.float() @ W.float()``, within the port's Temperature
    tolerance (rtol 1e-5, plus 1e-5 of the row's largest |logit| for
    entries that cancel to near 0) of the JAX package's
    ``jnp.dot(h, W, preferred_element_type=jnp.float32)``.

A captured step's bits against the eager step's are checked on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 4f).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.serve import step_graph  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as SP  # noqa: E402
from repro_torch.serve.sampler import (Greedy, SoftmaxBaseline,  # noqa: E402
                                       Temperature, TopK, f32_logits)

torch.set_num_threads(2)

TOL = 1e-4
RTOL = 1e-5
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _decode_case(t, seed):
    """Ragged rows over random pools: tokens (3, t), positions (3,) at
    t = 1 or (3, t), a (3, 4) block table and (L, 20, 4, Hkv, hd)
    pools."""
    rng = np.random.default_rng(seed)
    L, hkv, hd, bs = TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim, 4
    last, nb, nblocks = np.array([1, 6, 13]), 4, 20
    perm = rng.permutation(nblocks)
    table = np.stack([np.concatenate([perm[5 * r:5 * r + p // bs + 1],
                                      [perm[5 * r]] * (nb - p // bs - 1)])
                      for r, p in enumerate(last)]).astype(np.int32)
    kp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    toks = rng.integers(0, TCFG.vocab_size, size=(3, t)).astype(np.int32)
    pos = (last if t == 1 else np.maximum(
        last[:, None] - np.arange(t - 1, -1, -1), 0)).astype(np.int32)
    return toks, pos, table, kp, vp


def _per_layer(tparams, toks, pos, table, pools):
    """The decode step as the port ran it before its constants were
    hoisted: every layer rebuilds the RoPE table through the public
    ``apply_rope`` and the paged indices from the block table."""
    cfg = TCFG
    b, t = toks.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = pos if pos.dim() == 2 else pos[:, None] + torch.arange(t)
    seg = tparams["decoder"][0]["slot0"]
    x = tparams["embed"][toks]
    for l in range(cfg.n_layers):
        a = {k: v[l] for k, v in seg["attn"].items()}
        m = {k: v[l] for k, v in seg["mlp"].items()}
        h = layers.rms_norm(x, seg["ln1"][l], cfg.norm_eps)
        q = (h @ a["wq"]).reshape(b, t, hq, hd)
        k = (h @ a["wk"]).reshape(b, t, hkv, hd)
        v = (h @ a["wv"]).reshape(b, t, hkv, hd)
        q = layers.rms_norm(q, a["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, a["k_norm"], cfg.norm_eps)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        kp, vp = pools["k"][l], pools["v"][l]
        cpm = positions.long()
        blk = torch.gather(table.long(), 1, cpm // kp.shape[1])
        kp.index_put_((blk, cpm % kp.shape[1]), k)
        vp.index_put_((blk, cpm % kp.shape[1]), v)
        o = ops.paged_attention(q[:, 0] if t == 1 else q, kp, vp, table,
                                (cpm[:, 0] if t == 1 else cpm).int())
        x = x + o.reshape(b, t, hq * hd) @ a["wo"]
        x = x + layers.mlp(m, layers.rms_norm(x, seg["ln2"][l],
                                              cfg.norm_eps), cfg.activation)
    h = lm.final_hidden(tparams, cfg, x)
    return h[:, 0] if t == 1 else h


@pytest.mark.parametrize("t", [1, 4])
def test_hoisted_decode_step_matches_jax_and_per_layer(bridged, t):
    jparams, tparams = bridged
    toks, pos, table, kp, vp = _decode_case(t, 40 + t)
    jcache = [{"slot0": {"attn": {"k": jnp.asarray(kp),
                                  "v": jnp.asarray(vp)}}}]
    jh, jnew = jlm.decode_step(jparams, JCFG, jnp.asarray(toks), jcache,
                               jnp.asarray(pos),
                               block_tables=jnp.asarray(table))
    pools = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    th, _ = lm.decode_step(tparams, TCFG, torch.from_numpy(toks).long(),
                           [{"slot0": {"attn": pools}}],
                           torch.from_numpy(pos),
                           block_tables=torch.from_numpy(table),
                           layers=lm.layer_params(tparams, TCFG))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            pools[name].numpy(), np.asarray(jnew[0]["slot0"]["attn"][name]),
            atol=TOL, rtol=TOL)
    again = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    want = _per_layer(tparams, torch.from_numpy(toks).long(),
                      torch.from_numpy(pos), torch.from_numpy(table), again)
    assert torch.equal(th, want)
    assert all(torch.equal(pools[n], again[n]) for n in ("k", "v"))


def test_step_constants_hold_one_rope_table_and_the_cells():
    """The constants a step shares: the (B, T, 1, hd/2) table of
    ``apply_rope`` and each query's pool cell; a (B,) base position
    covers a consecutive window, as a (B, T) matrix does."""
    table = torch.tensor([[3, 1, 3, 3], [0, 2, 0, 0]], dtype=torch.int32)
    base = torch.tensor([5, 2], dtype=torch.int32)
    positions = base[:, None] + torch.arange(3)
    c = layers.step_constants(TCFG, positions, cache_pos=base,
                              block_tables=table, block_size=4)
    m = layers.step_constants(TCFG, positions, cache_pos=positions.int(),
                              block_tables=table, block_size=4)
    cos, sin = layers.rope_table(positions, TCFG.head_dim, TCFG.rope_theta)
    assert c.cos.shape == (2, 3, 1, TCFG.head_dim // 2)
    assert torch.equal(c.cos, cos) and torch.equal(c.sin, sin)
    assert c.blk.tolist() == [[1, 1, 1], [0, 0, 2]]
    assert c.off.tolist() == [[1, 2, 3], [2, 3, 0]]
    assert c.positions.dtype == torch.int32 and c.tables is table
    for f in ("blk", "off", "positions", "cpm"):
        assert torch.equal(getattr(c, f), getattr(m, f)), f
    one = layers.step_constants(TCFG, base[:, None], cache_pos=base,
                                block_tables=table, block_size=4)
    assert one.positions.tolist() == [5, 2]
    prefill = layers.step_constants(TCFG, torch.arange(6))
    assert prefill.cos.shape == (1, 6, 1, TCFG.head_dim // 2)
    assert prefill.tables is None


def test_layer_params_are_views_of_the_stack(bridged):
    _, tparams = bridged
    views = lm.layer_params(tparams, TCFG)
    assert len(views) == 1 and len(views[0]) == TCFG.n_layers
    seg = tparams["decoder"][0]["slot0"]
    for l, (p,) in enumerate(views[0]):
        assert p["attn"]["wq"].data_ptr() == seg["attn"]["wq"][l].data_ptr()
        assert torch.equal(p["mlp"]["w_out"], seg["mlp"]["w_out"][l])


BASE = dict(order=(Greedy(),), toks_shape=(8, 1), table_shape=(8, 4),
            group_sizes=(8,), spec_size=0)


def _key(**kw):
    return step_graph.bucket_key(**{**BASE, **kw})


@pytest.mark.parametrize("change", [
    dict(toks_shape=(4, 1), table_shape=(4, 4), group_sizes=(4,)),
    dict(table_shape=(8, 8)),
    dict(toks_shape=(8, 2)),
    dict(order=(Greedy(), TopK(4)), group_sizes=(4, 4)),
    dict(order=(Temperature(),)),
    dict(group_sizes=(4,)),
    dict(group_sizes=(4,), spec_size=4, toks_shape=(8, 8)),
    dict(spec_size=8),
])
def test_bucket_key_differs_across_shapes_and_samplers(change):
    assert _key(**change) != _key()
    assert hash(_key(**change)) is not None


def test_bucket_key_of_two_engine_steps_of_one_shape():
    """Two consecutive steps of one engine differ in their tokens and
    positions (and may in their block ids), never in their key; a mixed
    batch and a speculative one get keys of their own."""
    llm = LLM.from_arch("qwen3-0.6b", device="cpu", n_slots=4, max_len=64)
    eng = llm.engine
    rng = np.random.default_rng(3)
    for n in (20, 21, 25):
        llm.submit(rng.integers(0, 256, size=n), SP(max_new_tokens=8))
    eng.step()
    active = [i for i, s in enumerate(eng.slots) if s is not None]
    a = eng._plan_step(active)
    eng.step()
    b = eng._plan_step(active)
    assert a.key == b.key == (4, 2, 1, (Greedy(),), (4,), 0)
    assert not np.array_equal(a.arrays[1], b.arrays[1])     # positions
    assert not np.array_equal(a.arrays[0], b.arrays[0])     # tokens
    eng.slots[active[1]].sampler = Temperature(0.5)
    mixed = eng._plan_step(active)
    # padded rows (a0, a1, a2, a0): each group's rows padded to B = 4
    assert mixed.key == (4, 2, 1, (Greedy(), Temperature()), (4, 4), 0)
    assert [r.tolist() for r in mixed.arrays[3:]] == [[0, 2, 3, 0],
                                                      [1, 1, 1, 1]]


class _DraftFor:
    """Drafts two copies of the last token for the requests whose first
    prompt token is in ``who``, nothing for the others."""

    def __init__(self, who):
        self.who = who

    def propose(self, history, k):
        return [history[-1]] * 2 if history[0] in self.who else []


def test_bucket_key_of_a_speculative_step_follows_b_not_the_split():
    """One or two of four rows drafting give the same key: the Greedy
    and the verify group both padded to B."""
    llm = LLM.from_arch("qwen3-0.6b", device="cpu", n_slots=4, max_len=64)
    eng = llm.engine
    for first in (1, 2, 3, 4):
        llm.submit(np.full(20, first), SP(max_new_tokens=8, spec_k=2))
    eng.step()
    active = [i for i, s in enumerate(eng.slots) if s is not None]
    keys = []
    for who in ({1}, {1, 2}):
        eng.drafter = _DraftFor(who)
        plan = eng._plan_step(active)
        assert plan.spec == 4 and plan.arrays[-1].shape == (4, 3)   # T 4
        assert [len(r) for r in plan.arrays[3:-1]] == [4, 4]
        keys.append(plan.key)
    assert keys[0] == keys[1] == (4, 2, 4, (Greedy(),), (4,), 4)


class _Counted:
    """A fake kernel wrapper: a plain count and a count by mode."""

    def __init__(self):
        self.launches = 0
        self.launches_by_mode = {"exact": 0, "base2": 0}


def test_launch_counter_arithmetic_of_a_capture_and_its_replays():
    w = {"paged": _Counted(), "head": types.SimpleNamespace(launches=5)}
    before = step_graph.read_counts(w)
    # what a capture's Python counts: 28 exact paged calls, one head
    w["paged"].launches += 28
    w["paged"].launches_by_mode["exact"] += 28
    w["head"].launches += 1
    delta = step_graph.count_delta(before, step_graph.read_counts(w))
    assert delta == {("paged", "launches", None): 28,
                     ("paged", "launches_by_mode", "exact"): 28,
                     ("head", "launches", None): 1}
    step_graph.add_counts(w, delta, -1)            # the capture ran nothing
    assert step_graph.read_counts(w) == before
    for _ in range(3):                             # three replays
        step_graph.add_counts(w, delta)
    assert (w["paged"].launches, w["paged"].launches_by_mode,
            w["head"].launches) == (84, {"exact": 84, "base2": 0}, 8)
    # a caller resets its counters, dict included: replays count afresh
    w["paged"].launches, w["paged"].launches_by_mode = 0, {"exact": 0,
                                                           "base2": 0}
    step_graph.add_counts(w, delta, 2)
    assert w["paged"].launches_by_mode == {"exact": 56, "base2": 0}
    assert step_graph.count_delta(before, before) == {}


def test_a_bucket_captures_on_its_second_step(monkeypatch):
    """A bucket's first step runs the body eagerly; its second captures
    and replays; later ones replay.  A bucket that comes once is never
    captured."""
    g = step_graph.StepGraphs()
    calls = []

    def capture(key, body, arrays, device):
        calls.append(("capture", key))
        g.graphs[key] = None

    def replay(key, arrays):
        calls.append(("replay", key))
        return "replayed"

    monkeypatch.setattr(g, "capture", capture)
    monkeypatch.setattr(g, "replay", replay)

    def body(x):
        calls.append(("eager", int(x[0])))
        return "eager"

    outs = [g.run(key, body, (np.array([i]),), "cpu")
            for i, key in enumerate("abaab")]
    assert outs == ["eager", "eager", "replayed", "replayed", "replayed"]
    assert calls == [("eager", 0), ("eager", 1), ("capture", "a"),
                     ("replay", "a"), ("replay", "a"), ("capture", "b"),
                     ("replay", "b")]
    assert g.seen == {"a", "b"} and set(g.graphs) == {"a", "b"}
    assert g.run("c", body, (np.array([5]),), "cpu") == "eager"
    assert "c" not in g.graphs


def test_a_capture_runs_with_the_collector_off(monkeypatch):
    """No garbage collection inside a capture: a dead engine's graphs,
    freed there, would invalidate it.  The collector is off in the body
    and back on after, also when the body raises (CUDA stubbed out)."""
    import contextlib
    import gc

    @contextlib.contextmanager
    def fake_capture(graph, pool=None, capture_error_mode=None):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Event", lambda: None)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    g, seen = step_graph.StepGraphs(), []
    assert gc.isenabled()
    g.capture("k", lambda x: seen.append(gc.isenabled()),
              (np.zeros(2),), "cpu")
    assert seen == [False] and gc.isenabled() and g.captures == 1

    def boom(x):
        raise RuntimeError("inside")

    with pytest.raises(RuntimeError, match="inside"):
        g.capture("j", boom, (np.zeros(2),), "cpu")
    assert gc.isenabled()
    gc.disable()
    try:
        g.capture("i", lambda x: None, (np.zeros(2),), "cpu")
        assert not gc.isenabled()      # left as the caller had it
    finally:
        gc.enable()


def test_the_counted_wrappers_are_the_kernels():
    names = set(step_graph.kernel_wrappers())
    assert names == {"paged_attention", "fused_argmax_head",
                     "fused_verify_head", "fused_topk_head",
                     "flash_attention", "softmax_stats", "online_softmax",
                     "fused_xent"}
    counts = step_graph.read_counts(step_graph.kernel_wrappers())
    assert ("paged_attention", "launches_by_mode", "exact") in counts
    assert ("online_softmax", "launches_by_route", "one-pass") in counts


def test_cpu_engine_builds_no_graph():
    llm = LLM.from_arch("qwen3-0.6b", device="cpu", n_slots=4, max_len=96)
    rng = np.random.default_rng(5)
    phrase = rng.integers(0, 256, size=8)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 17, 9)] + [
        np.tile(phrase, 4)]
    outs = llm.generate(prompts, [
        SP(max_new_tokens=6), SP(max_new_tokens=6, top_k=4, seed=1),
        SP(max_new_tokens=6, head_mode="temperature", seed=2),
        SP(max_new_tokens=6, spec_k=3)])
    assert all(len(o.token_ids) >= 1 for o in outs)
    g = llm.engine.graphs
    assert len(g) == 0 and g.graphs == {} and g.pool is None
    assert g.seen == set()
    assert (g.captures, g.replays, g.capture_ms) == (0, 0, 0.0)
    assert llm.stats["decode_steps"] > 0
    assert set(llm.stats["head_calls"]) >= {"Greedy", "TopK", "Temperature"}


def test_eager_steps_nests_and_restores():
    cuda = torch.device("cuda")
    assert not step_graph.graphed("cpu")
    assert step_graph.graphed(cuda)
    with step_graph.eager_steps():
        assert not step_graph.graphed(cuda)
        with step_graph.eager_steps():
            assert not step_graph.graphed(cuda)
        assert not step_graph.graphed(cuda)
    assert step_graph.graphed(cuda)
    with pytest.raises(RuntimeError):
        with step_graph.eager_steps():
            raise RuntimeError("inside")
    assert step_graph.graphed(cuda)
    layers._ATTN_TAP = []
    try:
        assert not step_graph.graphed(cuda)      # the probe's tap is set
    finally:
        layers._ATTN_TAP = None
    assert step_graph.graphed(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logit_heads_keep_their_cpu_bits_and_match_jax(bridged, dtype):
    _, tparams = bridged
    params = {"embed": tparams["embed"].to(dtype)}
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.normal(size=(5, TCFG.d_model)).astype(
        np.float32)).to(dtype)
    w = lm.lm_head_weight(params, TCFG)
    want = torch.matmul(h.float(), w.float())
    got = Temperature(0.7).head(params, TCFG, h)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(f32_logits(params, TCFG, h), want)
    ids = SoftmaxBaseline().head(params, TCFG, h)
    assert torch.equal(ids, torch.argmax(torch.softmax(want, -1), -1).int())
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = jnp.asarray(w.float().numpy()).astype(jdt)
    jh = jnp.asarray(h.float().numpy()).astype(jdt)
    jl = np.asarray(jnp.dot(jh, jw, preferred_element_type=jnp.float32))
    scale = np.abs(jl).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got.numpy() - jl) <= RTOL * np.abs(jl)
                  + RTOL * scale)
