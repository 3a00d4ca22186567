"""The MoE family (phi3.5-moe, llama4-maverick) in the port against the JAX
package, on weights bridged from ``repro.models.lm.init_params`` at the
smoke size (2 layers, d 64, 4 heads over 2 kv heads of 16, 4 experts of
width 64, vocab 256, f32): phi3.5-moe's every layer routes (top-2),
llama4-maverick's block program is ``(attn, moe)`` with a top-1 router and
a shared expert.

- ``layers.moe_route`` with two equal router columns: the same experts as
  the reference's ``_route``, the lower index first;
- ``layers.moe_scatter`` at capacity factors 0.25, 1.25 and 16, and
  ``layers.moe_gshard`` at ``group_size`` 8 over T 16 (two groups a row)
  at 1.25 and 0.25: every choice's (expert, slot) and whether it is kept
  are the reference's (its cumsum ranks, recomputed from its ``_route``),
  the outputs and the aux loss within tolerance;
- ``layers.moe_dense_oracle`` and the aux loss; two expert ranges, the
  shared expert counted once, add up to the whole layer
  (``tests/test_distributed.py:183``'s rule);
- ``lm.forward`` (logits and the summed aux loss), ``lm.prefill`` and
  ``lm.decode_step`` for both topologies;
- the engine's greedy, TopK and Temperature tokens against the JAX
  ``ServeEngine``'s on its dense layout: 3 live rows padded to 4 (the
  padding row takes part in routing), a capacity factor of 0.5 whose
  tokens differ from 16's in the JAX engine (drops on the path), the
  dense layout and the cohort scheduler each against JAX's own;
  reduced == softmax;
- a padding row's K/V never overwrite a live row's (paged and dense):
  the reference's dense layout, which its paged engine departs from;
- the gates: ``spec_k`` refused naming MoE, ``chunk_size`` /
  ``host_stride`` warning and falling back with the same tokens;
- the bridge both ways, a misshapen expert leaf raising, the CLI.

Tolerance: layer outputs, hidden states and logits within ``F32_TOL``
(2e-5, the port's f32 tolerance elsewhere), aux losses within 1e-6;
expert choices, slots and tokens equal.
"""
import dataclasses
import warnings

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
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
AUX_TOL = 1e-6
PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
ARCHS = (PHI, LLAMA4)
MOE_SLOT = {PHI: "slot0", LLAMA4: "slot1"}


def _cfgs(arch, cf=None):
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


_BRIDGED = {}


def _bridged(arch):
    """(JAX params, port params) of the arch's smoke config, seed 0."""
    if arch not in _BRIDGED:
        jcfg, tcfg = _cfgs(arch)
        jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        _BRIDGED[arch] = (jparams, weights.from_numpy_params(
            jax.tree.map(np.asarray, jparams), tcfg, "cpu"))
    return _BRIDGED[arch]


def _moe_params(arch, layer=0):
    """One layer's ``moe`` leaves, JAX and port."""
    jparams, tparams = _bridged(arch)
    slot = MOE_SLOT[arch]
    jp = jax.tree.map(lambda a: a[layer],
                      jparams["decoder"][0][slot]["moe"])
    tp = tlm._layer(tparams["decoder"][0][slot]["moe"], layer)
    return jp, tp


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _prompts(seed, lengths=(3, 9, 17)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lengths]


def _x(seed, B, T, d=64):
    return np.random.default_rng(seed).standard_normal(
        (B, T, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# The block program and the tree
# ---------------------------------------------------------------------------
def test_block_program_and_tree_follow_the_reference():
    """phi3.5-moe: one segment of one ``moe`` slot, its full-width expert
    stacks (16 of (4,096, 6,400)) and untied head; llama4-maverick: one
    segment of ``(attn, moe)`` units, the shared expert under ``moe``."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        assert tlm.segments(tcfg) == jlm.segments(jcfg)
        assert tlm.layer_types(get_config(arch)) == jlm.layer_types(
            J_ARCHS[arch])
    assert tlm.segments(_cfgs(PHI)[1]) == [(("moe",), 2)]
    assert tlm.segments(_cfgs(LLAMA4)[1]) == [(("attn", "moe"), 1)]
    phi = weights.param_shapes(get_config(PHI))["decoder"][0]["slot0"]
    assert phi["moe"]["w_gate"][0] == (32, 16, 4096, 6400)
    assert phi["moe"]["w_out"] == ((32, 16, 6400, 4096), 6400)
    assert phi["moe"]["router"] == ((32, 4096, 16), 4096)
    assert "shared" not in phi["moe"] and "mlp" not in phi
    l4 = weights.param_shapes(get_config(LLAMA4))["decoder"][0]
    assert l4["slot0"]["mlp"]["w_gate"][0] == (24, 5120, 8192)
    assert l4["slot1"]["moe"]["w_up"][0] == (24, 128, 5120, 8192)
    assert l4["slot1"]["moe"]["shared"]["w_out"][0] == (24, 8192, 5120)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bridge_round_trip(arch):
    """JAX tree -> ``from_numpy_params`` -> numpy is the JAX tree bit for
    bit, leaf for leaf; a misshapen expert leaf raises; the seeded tree
    has the bridged tree's structure and shapes."""
    jparams, tparams = _bridged(arch)
    flat_j = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    flat_t = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), tparams,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    seeded = weights.seeded_params(_cfgs(arch)[1], 0, "cpu")
    assert jax.tree.structure(jax.tree.map(
        lambda t: tuple(t.shape), seeded,
        is_leaf=lambda t: isinstance(t, torch.Tensor))) == \
        jax.tree.structure(jax.tree.map(lambda a: a.shape, jparams))
    bad = jax.tree.map(np.asarray, jparams)
    moe = bad["decoder"][0][MOE_SLOT[arch]]["moe"]
    moe["w_gate"] = moe["w_gate"][:, :3]                  # 3 experts of 4
    with pytest.raises(ValueError, match="shape"):
        weights.from_numpy_params(bad, _cfgs(arch)[1], "cpu")


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_to_the_lower_expert(arch):
    """Router columns 1 and 3 equal and the largest for every token: the
    reference's ``jax.lax.top_k`` gives expert 1 first, and so does the
    port (a stable descending sort); at top-2 the pair is (1, 3)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    router = 0.01 * rng.standard_normal((64, 4)).astype(np.float32)
    v = x.mean(0) / np.linalg.norm(x.mean(0))
    router[:, 1] = router[:, 3] = 5.0 * v
    x += 3.0 * v                                    # every token leans on v
    jprobs, jvals, jidx = jlayers._route(jnp.asarray(x), jnp.asarray(router),
                                         jcfg.moe)
    probs, vals, idx = tlayers.moe_route(torch.from_numpy(x),
                                         torch.from_numpy(router), tcfg.moe)
    k = tcfg.moe.top_k
    assert bool((probs[:, 1] == probs[:, 3]).all())
    want = [[1, 3]] * 12 if k == 2 else [[1]] * 12
    np.testing.assert_array_equal(np.asarray(jidx), want)
    np.testing.assert_array_equal(idx.numpy(), want)
    _close(vals, jvals)
    _close(probs, jprobs)


def _jax_slots(jidx, e_num, cap, group):
    """The reference's slot of every choice (``moe_gshard`` /
    ``moe_scatter``: cumsum ranks over each group's (token, choice)
    order) and whether it is kept."""
    n_tok, k = jidx.shape
    onehot = jax.nn.one_hot(jidx, e_num, dtype=jnp.float32)
    flat = onehot.reshape(n_tok // group, group * k, e_num)
    ranks = jnp.cumsum(flat, axis=1) - flat
    ranks = jnp.sum(ranks * flat, axis=-1).reshape(n_tok, k).astype(
        jnp.int32)
    return np.asarray(ranks), np.asarray(ranks < cap)


def _check_slots(jp, tp, x, jcfg, tcfg, group):
    xf = x.reshape(-1, x.shape[-1])
    _, _, jidx = jlayers._route(jnp.asarray(xf), jp["router"], jcfg.moe)
    _, _, idx = tlayers.moe_route(torch.from_numpy(xf), tp["router"],
                                  tcfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    rank, keep, cap = tlayers.moe_slots(idx, tcfg.moe, group)
    jrank, jkeep = _jax_slots(jidx, jcfg.moe.num_experts, cap, group)
    np.testing.assert_array_equal(rank.numpy(), jrank)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    return keep.numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
def test_scatter_keeps_the_reference_slots(arch, cf):
    """``moe_scatter`` over B 3 x T 5 tokens (one group of 15): every
    choice's expert, rank and kept flag are the reference's; factor 0.25
    drops choices, 16 none; the outputs and aux loss match."""
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _moe_params(arch)
    x = _x(11, 3, 5)
    keep = _check_slots(jp, tp, x, jcfg, tcfg, 15)
    if cf != 1.25:
        assert keep.all() == (cf == 16.0)
    jy, jaux = jlayers.moe_scatter(jp, jnp.asarray(x), jcfg)
    y, aux = tlayers.moe_scatter(tp, torch.from_numpy(x), tcfg)
    _close(y, jy)
    _close(aux, jaux, AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_gshard_keeps_the_reference_slots(arch, cf):
    """``moe_gshard`` at group_size 8 over B 2 x T 16 (two groups a row,
    each with its own capacity): the reference's kept slots, outputs and
    aux loss; a T the group does not divide raises."""
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _moe_params(arch, layer=0)
    x = _x(12, 2, 16)
    keep = _check_slots(jp, tp, x, jcfg, tcfg, 8)
    assert not keep.all()
    jy, jaux = jlayers.moe_gshard(jp, jnp.asarray(x), jcfg, group_size=8)
    y, aux = tlayers.moe_gshard(tp, torch.from_numpy(x), tcfg, 8)
    _close(y, jy)
    _close(aux, jaux, AUX_TOL)
    with pytest.raises(ValueError, match="not a multiple"):
        tlayers.moe_gshard(tp, torch.from_numpy(_x(1, 1, 12)), tcfg, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_kept_reads_each_calls_kept_choices(arch):
    """``layers.count_kept``: inside it, each MoE call appends the choices
    it keeps over all four experts -- the reference's kept flags summed,
    at a factor that drops (0.25) -- an expert range's call the same
    count; outside it nothing is counted."""
    jcfg, tcfg = _cfgs(arch, 0.25)
    jp, tp = _moe_params(arch, layer=0)
    x = _x(12, 2, 16)
    keep = _check_slots(jp, tp, x, jcfg, tcfg, 8)
    part = {k: (v[:2] if k in ("w_gate", "w_up", "w_out") else v)
            for k, v in tp.items()}
    with tlayers.count_kept() as kept:
        tlayers.moe_gshard(tp, torch.from_numpy(x), tcfg, 8)
        tlayers.moe_gshard(part, torch.from_numpy(x), tcfg, 8,
                           experts=(0, 2))
    assert [int(k) for k in kept] == [int(keep.sum())] * 2
    assert 0 < keep.sum() < keep.size
    tlayers.moe_gshard(tp, torch.from_numpy(x), tcfg, 8)
    assert len(kept) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracle_and_aux_match_and_equal_an_undropped_layer(arch):
    """The oracle (every expert over every token, no capacity) against the
    reference's; with no choice dropped (factor 16) the scatter and gshard
    executors compute the same function."""
    jcfg, tcfg = _cfgs(arch, 16.0)
    jp, tp = _moe_params(arch, layer=1 if arch == PHI else 0)
    x = _x(13, 2, 8)
    jy, jaux = jlayers.moe_dense_oracle(jp, jnp.asarray(x), jcfg)
    y, aux = tlayers.moe_dense_oracle(tp, torch.from_numpy(x), tcfg)
    _close(y, jy)
    _close(aux, jaux, AUX_TOL)
    for impl in ("scatter", "gshard"):
        yi, auxi = tlayers.moe_layer(tp, torch.from_numpy(x), tcfg,
                                     impl=impl, group_size=8)
        _close(yi, y)
        assert float(auxi) == pytest.approx(float(aux), abs=AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["scatter", "gshard"])
def test_expert_ranges_add_up_to_the_layer(arch, impl):
    """The layer over experts [0, 2) (with the shared expert, where there
    is one) plus the layer over [2, 4) without it is the whole layer, at
    a factor that drops (0.5): each range routes every token over all
    four experts at the global capacity and keeps its own experts'
    slots."""
    _, tcfg = _cfgs(arch, 0.5)
    _, tp = _moe_params(arch)
    x = torch.from_numpy(_x(14, 2, 8))
    whole, aux = tlayers.moe_layer(tp, x, tcfg, impl=impl, group_size=4)
    parts = []
    for lo, hi in ((0, 2), (2, 4)):
        p = {k: (v[lo:hi] if k in ("w_gate", "w_up", "w_out") else v)
             for k, v in tp.items() if k != "shared" or lo == 0}
        y, a = tlayers.moe_layer(p, x, tcfg, impl=impl, group_size=4,
                                 experts=(lo, hi))
        assert float(a) == float(aux)
        parts.append(y)
    _close(parts[0] + parts[1], whole)
    with pytest.raises(ValueError, match="holds 4 experts"):
        tlayers.moe_layer(tp, x, tcfg, impl=impl, experts=(0, 2))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    """``lm.forward``'s logits and summed aux loss against JAX's; per
    prompt (3, 9, 17 tokens) ``lm.prefill`` then 6 greedy
    ``lm.decode_step`` -- hidden states within F32_TOL of JAX's, the same
    tokens, and the K/V of every attention-bearing slot JAX's."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _bridged(arch)
    prompts = _prompts(1)
    toks = np.stack([np.resize(p, 16) for p in prompts])
    jl, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    tl, aux = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert aux.dtype == torch.float32 and float(jaux) > 0
    _close(aux, jaux, AUX_TOL)
    w = tlm.lm_head_weight(tparams, tcfg)
    max_len = 32
    jprefill = jax.jit(lambda p, t: jlm.prefill(p, jcfg, {"tokens": t},
                                                max_len))
    jdecode = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, jcfg, t, c,
                                                           pos))
    for prompt in prompts:
        jh, jc = jprefill(jparams, jnp.asarray(prompt)[None])
        th, tc = tlm.prefill(tparams, tcfg,
                             torch.from_numpy(prompt)[None].long(), max_len)
        _close(th, jh)
        for i in range(6):
            tok = int(torch.argmax(th @ w, -1)[0])
            assert tok == int(jnp.argmax(
                jh @ jlm.lm_head_weight(jparams, jcfg), -1)[0])
            pos = len(prompt) + i
            jh, jc = jdecode(jparams, jnp.asarray([[tok]], jnp.int32), jc,
                             jnp.int32(pos))
            th, tc = tlm.decode_step(tparams, tcfg, torch.tensor([[tok]]),
                                     tc, torch.tensor(pos, dtype=torch.int32))
            _close(th, jh)
        for slot, leaf in tc[0].items():
            for name in ("k", "v"):
                _close(leaf["attn"][name], jc[0][slot]["attn"][name])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _serve(E, R, SP, params, cfg, prompts, plist, **kw):
    eng = E(params, cfg, eos_id=-1, **kw)
    reqs = [R(i, p.copy(), params=SP(**k))
            for i, (p, k) in enumerate(zip(prompts, plist))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [[int(t) for t in r.generated] for r in reqs], eng


def _both(arch, prompts, plist, cf=None, jax_layout="dense", **kw):
    """The JAX engine's tokens (on its ``jax_layout``, by default the
    dense layout: the reference's byte-identity oracle, see
    ``test_padding_row_never_overwrites_a_live_row``) and the port's
    (on ``kw``'s layout), with their engines, on the arch's bridged
    weights."""
    jcfg, tcfg = _cfgs(arch, cf)
    jparams, tparams = _bridged(arch)
    jkw = dict(kw, kv_layout=jax_layout)
    want, jeng = _serve(JEngine, JRequest, JSP, jparams, jcfg, prompts,
                        plist, **jkw)
    got, teng = _serve(TEngine, TRequest, TSP, tparams, tcfg, prompts,
                       plist, **kw)
    return want, got, jeng, teng


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_pads_three_rows_to_four_as_the_reference(arch):
    """Three prompts on 4 slots: every step runs 3 live rows padded to 4
    (the padding row repeats row 0 and takes part in routing, raising the
    capacity), so the tokens are the JAX engine's only if the port plans
    the same padded rows.  The store pages every attention-bearing
    slot's K/V, as the reference's paged store does (2 leaves a slot)."""
    plist = [dict(max_new_tokens=10)] * 3
    want, got, jeng, teng = _both(arch, _prompts(41), plist, n_slots=4,
                                  max_len=32)
    assert got == want
    assert teng.store.any_paged
    jpaged = JEngine(_bridged(arch)[0], _cfgs(arch)[0], n_slots=1,
                     max_len=32)
    assert teng.store.usage()["paged_leaves"] \
        == jpaged.store.usage()["paged_leaves"] \
        == 2 * len(tlm.segments(_cfgs(arch)[1])[0][0])
    assert teng.stats["fused_rows"] == jeng.stats["fused_rows"]
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert teng.stats["fused_rows"] == 3 * teng.stats["decode_steps"]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_padding_row_never_overwrites_a_live_row(layout):
    """One decode step of live rows 0-2 padded with a copy of row 0, at a
    capacity factor (0.5) where the padding row, last in rank order,
    loses a choice row 0 keeps: its layer-1 K/V then differ from row 0's.
    Against the same step with the padding row on a cache of its own
    (slot 3, a copy of slot 0 -- the reference's dense layout, which
    attends over a gathered copy and writes back the live rows only),
    the live rows' hidden states and slot 0's cells are bit for bit the
    same: the padding row's write never lands on the live row's cell.

    The reference's paged engine scatters the padding row's K/V into the
    live row's cell too, and on the CPU the last write wins, so there a
    live row can read the padding row's K/V; its tokens then part from its
    own dense layout's (seed 43 below).  The port's engine follows the
    dense layout on both layouts."""
    _, tcfg = _cfgs(PHI, 0.5)
    tparams = weights.cast_params(_bridged(PHI)[1], tcfg)
    rng = np.random.default_rng(8)
    toks = torch.tensor([[5], [9], [17], [5]])
    pos = torch.tensor([6, 4, 5, 6], dtype=torch.int32)
    kvs = [torch.from_numpy(rng.standard_normal(
        (2, 4, 8, 2, 16)).astype(np.float32)) for _ in range(2)]
    for kv in kvs:
        kv[:, 3] = kv[:, 0]                        # slot 3: a copy of slot 0
    if layout == "dense":
        def step(rows):
            cache = [{"slot0": {"attn": {"k": kvs[0].clone(),
                                         "v": kvs[1].clone()}}}]
            h, _ = tlm.decode_step(tparams, tcfg, toks, cache, pos,
                                   cache_rows=torch.tensor(rows))
            return h, cache[0]["slot0"]["attn"]["k"][:, :, :8]
    else:
        def step(rows):
            # slot s owns pool blocks 2s, 2s + 1 (block size 4)
            pools = {n: kv.reshape(2, 8, 4, 2, 16).clone()
                     for n, kv in zip("kv", kvs)}
            tables = torch.tensor([[2 * r, 2 * r + 1] for r in rows],
                                  dtype=torch.int32)
            h, _ = tlm.decode_step(tparams, tcfg, toks,
                                   [{"slot0": {"attn": pools}}], pos,
                                   block_tables=tables)
            return h, pools["k"].reshape(2, 4, 8, 2, 16)

    own, own_k = step([0, 1, 2, 3])
    shared, shared_k = step([0, 1, 2, 0])
    assert not torch.equal(own_k[1, 3, 6], own_k[1, 0, 6])  # K/V differ
    assert torch.equal(shared[:3], own[:3])
    assert torch.equal(shared_k[:, :3], own_k[:, :3])
    if layout == "paged":
        prompts = _prompts(43, (3, 9, 17, 6))
        plist = [dict(max_new_tokens=8)] * 4
        dense, got, _, _ = _both(PHI, prompts, plist, n_slots=3, max_len=32)
        jpaged, _, _, _ = _both(PHI, prompts, plist, jax_layout="paged",
                                n_slots=3, max_len=32)
        assert got == dense != jpaged


def test_engine_drops_as_the_reference_at_capacity_factor_half():
    """phi3.5-moe at capacity factor 0.5 on 5 prompts and 4 slots: the JAX
    engine's tokens there differ from its tokens at 16 (no drop), so
    dropped choices decide tokens on the path; the port's equal JAX's at
    both factors."""
    prompts = _prompts(41, (3, 9, 17, 6, 12))
    plist = [dict(max_new_tokens=10)] * 5
    runs = {cf: _both(PHI, prompts, plist, cf=cf, n_slots=4, max_len=32)
            for cf in (0.5, 16.0)}
    for cf, (want, got, _, _) in runs.items():
        assert got == want, cf
    assert runs[0.5][0] != runs[16.0][0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [dict(kv_layout="dense"),
                                dict(scheduler="cohort")],
                         ids=["dense", "cohort"])
def test_dense_layout_and_cohort_match_jax(arch, kw):
    """The port's dense layout, and its cohort scheduler (on the paged
    layout), against the JAX engine's own mode, at a capacity factor that
    drops (0.5) on 4 prompts over 3 slots."""
    prompts = _prompts(43, (3, 9, 17, 6))
    plist = [dict(max_new_tokens=8)] * 4
    want, got, _, teng = _both(arch, prompts, plist, cf=0.5, n_slots=3,
                               max_len=32, **kw)
    assert got == want
    assert teng.store.any_paged == ("kv_layout" not in kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_samplers_match_jax(arch):
    """Greedy, TopK and Temperature rows in one fused step: the JAX
    engine's tokens (the host pick draws from each request's seeded
    stream)."""
    plist = [dict(max_new_tokens=6), dict(max_new_tokens=6, top_k=4, seed=3),
             dict(max_new_tokens=6, temperature=0.7, seed=4)]
    want, got, _, _ = _both(arch, _prompts(9), plist, n_slots=3, max_len=32)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equals_softmax_tokens(arch):
    _, tparams = _bridged(arch)
    tcfg = _cfgs(arch)[1]
    outs = {}
    for mode in ("reduced", "softmax"):
        llm = LLM(tparams, tcfg, n_slots=3, max_len=32, head_mode=mode)
        outs[mode] = [list(o.token_ids) for o in llm.generate(
            _prompts(7), TSP(max_new_tokens=8))]
    assert outs["reduced"] == outs["softmax"]


def test_spec_refused_chunk_and_stride_fall_back():
    """As the reference (``repro/serve/engine.py:425-496, 656-664``):
    capacity-dropping routing makes a token's logits depend on its
    batch-mates, so ``spec_k`` is refused naming MoE; chunking and the
    device loop warn and fall back (prefix sharing off with them), and the
    tokens stay the one-shot, per-token engine's."""
    _, tparams = _bridged(PHI)
    tcfg = _cfgs(PHI)[1]
    prompt = _prompts(2)[1]
    eng = TEngine(tparams, tcfg, n_slots=1, max_len=32)
    assert not eng.spec_capable and not eng.chunk_capable
    assert not eng.multistep_capable
    with pytest.raises(ValueError, match="MoE routing.*'moe' config does "
                                         "not qualify"):
        eng.submit(TRequest(0, prompt.copy(), params=TSP(spec_k=2)))
    with pytest.warns(UserWarning, match="chunk_size=8 ignored"):
        ceng = TEngine(tparams, tcfg, n_slots=2, max_len=32, chunk_size=8)
    with pytest.warns(UserWarning, match="host_stride=4 ignored"):
        seng = TEngine(tparams, tcfg, n_slots=2, max_len=32, host_stride=4)
    assert ceng.chunk_size is None and not ceng.prefix_cache
    assert seng.host_stride is None
    prompts = _prompts(4)
    plist = [dict(max_new_tokens=6)] * 3
    base, _ = _serve(TEngine, TRequest, TSP, tparams, tcfg, prompts, plist,
                     n_slots=2, max_len=32)
    for kw in (dict(chunk_size=8), dict(host_stride=4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, eng = _serve(TEngine, TRequest, TSP, tparams, tcfg, prompts,
                              plist, n_slots=2, max_len=32, **kw)
        assert got == base
        assert eng.stats["prefill_chunks"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_moe_smoke_configs(arch, capsys):
    snap = cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "4", "--slots", "2", "--max-len", "48"])
    assert snap["completed"] == 4
    assert "kv=paged" in capsys.readouterr().out
    with pytest.raises(ValueError, match="MoE"):
        cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "1", "--spec-k", "2"])


def test_router_from_arch_serves_the_moe_family():
    """``Router.from_arch`` over two replicas of llama4-maverick's smoke
    config: both replicas serve, every request its tokens."""
    from repro_torch.serve.router import Router

    router = Router.from_arch(LLAMA4, device="cpu", replicas=2, n_slots=2,
                              max_len=48, eos_id=-1)
    outs = router.generate([p.copy() for p in _prompts(5, (3, 9, 17, 6))],
                           TSP(max_new_tokens=5))
    assert [len(o.token_ids) for o in outs] == [5] * 4
    assert all(r.served > 0 for r in router.replicas)
