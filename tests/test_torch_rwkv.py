"""The RWKV6 family (rwkv6-7b) in the port against the JAX package, on
weights bridged from ``repro.models.lm.init_params`` at the smoke size (2
layers, d 64, wkv head size 16 -- 4 heads --, d_ff 128, vocab 256, f32).

- ``models.rwkv6.rwkv_time_mix`` / ``rwkv_channel_mix`` / ``rwkv_block``
  against the reference's at T = 1 and T = 7 from a nonzero state;
- ``lm.forward``, and ``lm.prefill`` + ``lm.decode_step`` against JAX's
  and against the port's own ``lm.forward`` at every position;
- the engine's greedy tokens against the JAX ``ServeEngine``'s and a
  scalar replay, with a bucket that pads 3 rows to 4 (a padding row
  repeats a live slot: nothing advances twice), mixed TopK /
  Temperature rows against the JAX engine's, reduced == softmax;
- ``spec_k`` refused, ``chunk_size`` / ``host_stride`` falling back;
- the weight bridge both ways and the seeded tree's constant leaves;
- the CLI at ``--smoke --device cpu``.

Tolerance: hidden states, logits and the written state within
``F32_TOL`` (2e-5, the port's f32 tolerance elsewhere); tokens equal.
In bf16 (the served dtype): ``lm.prefill`` + ``lm.decode_step`` along
JAX's greedy tokens, no farther from JAX's bf16 hidden state (RMS) than
``BF16_GAP`` times JAX's own bf16 is from its f32, the shifts kept in
bf16 and ``wkv`` in f32 as the reference's store keeps them.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_GAP = 2.0                # port bf16 vs JAX bf16, in JAX bf16-vs-f32 RMS
ARCH = "rwkv6-7b"
JCFG = j_smoke(J_ARCHS[ARCH])
TCFG = smoke_config(get_config(ARCH))
LENGTHS = (3, 9, 17)


def _bridge(jcfg, tcfg, seed=0):
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def bridged():
    return _bridge(JCFG, TCFG)


def _prompts(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# The tree and the bridge
# ---------------------------------------------------------------------------
def test_block_program_and_tree_follow_the_reference(bridged):
    """One segment of one ``rwkv`` slot; rwkv6-7b's leaves at full width
    (an untied (4,096, 65,536) head); the seeded tree's constant leaves
    are the reference's (mu 0.5, w0 -6, ln_x 1) and u is drawn at 0.1."""
    assert tlm.segments(TCFG) == jlm.segments(JCFG) == [(("rwkv",), 2)]
    full = get_config(ARCH)
    assert tlm.layer_types(full) == jlm.layer_types(J_ARCHS[ARCH])
    shapes = weights.param_shapes(full)
    slot = shapes["decoder"][0]["slot0"]
    assert slot["w_k_cm"][0] == (32, 4096, 14336)
    assert slot["wA"][0] == (32, 4096, 64) and slot["wB"][0] == (32, 64, 4096)
    assert shapes["lm_head"][0] == (4096, 65536)
    tree = weights.seeded_params(TCFG, 0, "cpu")["decoder"][0]["slot0"]
    assert bool((tree["mu_r"] == 0.5).all()) and bool((tree["w0"] == -6).all())
    assert bool((tree["ln_x"] == 1).all()) and bool((tree["ln1"] == 0).all())
    assert 0.05 < float(tree["u"].std()) < 0.2


def test_weight_bridge_round_trip(bridged):
    """JAX tree -> ``from_numpy_params`` -> numpy is the JAX tree bit for
    bit, leaf for leaf; a misshapen leaf raises."""
    jparams, tparams = bridged
    flat_j = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    flat_t = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), tparams,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(flat_j) == len(flat_t) == len(jax.tree.leaves(
        weights.param_shapes(TCFG), is_leaf=lambda x: isinstance(x, tuple)
        and len(x) == 2 and isinstance(x[0], tuple)))
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(np.asarray, jparams)
    bad["decoder"][0]["slot0"]["u"] = np.zeros((2, 63), np.float32)
    with pytest.raises(ValueError, match="shape"):
        weights.from_numpy_params(bad, TCFG, "cpu")


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
def _state(rng, B):
    d, hd = TCFG.d_model, TCFG.rwkv_head_size
    return {"shift1": rng.standard_normal((B, d)).astype(np.float32),
            "shift2": rng.standard_normal((B, d)).astype(np.float32),
            "wkv": rng.standard_normal((B, d // hd, hd, hd)).astype(
                np.float32)}


@pytest.mark.parametrize("T", [1, 7])
def test_time_mix_channel_mix_and_block_match_jax(bridged, T):
    """From a nonzero state (shifts and wkv drawn), on x and on the normed
    input: each half's output and its state within F32_TOL, every state
    leaf returned in f32."""
    jparams, tparams = bridged
    jp = jax.tree.map(lambda a: a[1], jparams["decoder"][0]["slot0"])
    tp = {k: v[1] for k, v in tparams["decoder"][0]["slot0"].items()}
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, TCFG.d_model)).astype(np.float32)
    st = _state(rng, 2)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ja, js1 = jrw.rwkv_time_mix(jp, xj, JCFG, jst)
    ta, ts1 = trw.rwkv_time_mix(tp, xt, TCFG, tst)
    _close(ta, ja)
    _close(ts1["wkv"], js1["wkv"])
    _close(ts1["shift1"], js1["shift1"])
    jb, js2 = jrw.rwkv_channel_mix(jp, xj, JCFG, jst)
    tb, ts2 = trw.rwkv_channel_mix(tp, xt, TCFG, tst)
    _close(tb, jb)
    _close(ts2["shift2"], js2["shift2"])
    jy, jnew = jrw.rwkv_block(jp, xj, JCFG, jst)
    ty, tnew = trw.rwkv_block(tp, xt, TCFG, tst)
    _close(ty, jy)
    assert set(tnew) == set(jnew) == {"shift1", "shift2", "wkv"}
    for k in tnew:
        _close(tnew[k], jnew[k])
        assert tnew[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def test_forward_prefill_and_decode_match_jax(bridged):
    """``lm.forward``'s logits against JAX's; per prompt (3, 9, 17
    tokens) ``lm.prefill`` then 8 greedy ``lm.decode_step`` -- hidden
    states within F32_TOL of JAX's, the same tokens, and each step's
    logits those of the port's ``lm.forward`` over the whole sequence at
    that position."""
    jparams, tparams = bridged
    prompts = _prompts(1)
    toks = np.stack([np.resize(p, 20) for p in prompts])
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, JCFG, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    tl, aux = tlm.forward(tparams, TCFG, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert aux == 0.0
    w = tlm.lm_head_weight(tparams, TCFG)
    jw = jlm.lm_head_weight(jparams, JCFG)
    max_len = 32
    jprefill = jax.jit(lambda p, t: jlm.prefill(p, JCFG, {"tokens": t},
                                                max_len))
    jdecode = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, JCFG, t, c,
                                                           pos))
    for prompt in prompts:
        jh, jc = jprefill(jparams, jnp.asarray(prompt)[None])
        th, tc = tlm.prefill(tparams, TCFG,
                             torch.from_numpy(prompt)[None].long(), max_len)
        _close(th, jh)
        seq = list(prompt)
        for i in range(8):
            tok = int(torch.argmax(th @ w, -1)[0])
            assert tok == int(jnp.argmax(jh @ jw, -1)[0])
            fl, _ = tlm.forward(tparams, TCFG, torch.tensor([seq]))
            _close(tlm.logits_fn(tparams, TCFG, th), fl[:, -1])
            seq.append(tok)
            pos = len(prompt) + i
            jh, jc = jdecode(jparams, jnp.asarray([[tok]], jnp.int32), jc,
                             jnp.int32(pos))
            th, tc = tlm.decode_step(tparams, TCFG, torch.tensor([[tok]]),
                                     tc, torch.tensor(pos, dtype=torch.int32))
            _close(th, jh)
        for k in ("shift1", "shift2", "wkv"):
            _close(tc[0]["slot0"][k], jc[0]["slot0"][k])


def test_prefill_and_decode_track_jax_in_bf16():
    """bf16: prefill each prompt, then 10 greedy steps along JAX's tokens.
    At every step the port's bf16 hidden state is no farther (RMS) from
    JAX's bf16 one than ``BF16_GAP`` times JAX's bf16 is from JAX's f32 on
    the same tokens (a wrong cast, a stale shift or a state advanced twice
    would sit at the hidden state's own size).  The port's prefill cache
    keeps the shifts in bf16 and ``wkv`` in f32, as the reference's
    ``init_rwkv_state`` / store do."""
    jparams, tparams = _bridge(JCFG, TCFG, seed=5)
    j16 = dataclasses.replace(JCFG, dtype="bfloat16")
    t16 = dataclasses.replace(TCFG, dtype="bfloat16")
    tparams = weights.cast_params(tparams, t16)
    jw = jlm.lm_head_weight(jlm.cast_params(jparams, j16), j16).astype(
        jnp.float32)
    max_len = 32
    pre = {c: jax.jit(lambda p, t, c=c: jlm.prefill(p, c, {"tokens": t},
                                                    max_len))
           for c in (j16, JCFG)}
    dec = {c: jax.jit(lambda p, t, k, pos, c=c: jlm.decode_step(
        p, c, t, k, pos)) for c in (j16, JCFG)}

    def rms(a):
        a = np.asarray(a, np.float32)
        return float(np.sqrt((a * a).mean()))

    def held(th, jh, jh32, where):
        jh = np.asarray(jh, np.float32)
        port, own = rms(th.float().numpy() - jh), rms(jh - np.asarray(jh32))
        assert port <= BF16_GAP * own, (where, port, own)

    for prompt in _prompts(5):
        jt = jnp.asarray(prompt)[None]
        jh, jc = pre[j16](jparams, jt)
        jh32, jc32 = pre[JCFG](jparams, jt)
        th, tc = tlm.prefill(tparams, t16, torch.from_numpy(prompt)[None]
                             .long(), max_len)
        assert th.dtype == torch.bfloat16
        st = tc[0]["slot0"]
        assert st["shift1"].dtype == st["shift2"].dtype == torch.bfloat16
        assert st["wkv"].dtype == torch.float32
        held(th, jh, jh32, (len(prompt), "prefill"))
        for i in range(10):
            tok = int(jnp.argmax(jh.astype(jnp.float32) @ jw, -1)[0])
            pos = len(prompt) + i
            jtok = jnp.asarray([[tok]], jnp.int32)
            jh, jc = dec[j16](jparams, jtok, jc, jnp.int32(pos))
            jh32, jc32 = dec[JCFG](jparams, jtok, jc32, jnp.int32(pos))
            th, tc = tlm.decode_step(tparams, t16, torch.tensor([[tok]]),
                                     tc, torch.tensor(pos, dtype=torch.int32))
            held(th, jh, jh32, (len(prompt), pos))


@pytest.mark.parametrize("n_layers", [8, 32])
def test_forward_in_bf16_tracks_jax_at_depth(n_layers):
    """``lm.forward`` in bf16 at 8 and 32 layers (rwkv6-7b's depth; smoke
    width, a 3-token prompt): the port's last-position logits no farther
    (RMS) from JAX's bf16 ones than ``BF16_GAP`` times JAX's bf16 is from
    its f32 -- a gap that random RWKV6 layers widen with depth, so bf16
    streams at full depth part from f32 ones in both packages."""
    jcfg = dataclasses.replace(JCFG, n_layers=n_layers)
    tcfg = dataclasses.replace(TCFG, n_layers=n_layers)
    jparams, tparams = _bridge(jcfg, tcfg)
    j16 = dataclasses.replace(jcfg, dtype="bfloat16")
    t16 = dataclasses.replace(tcfg, dtype="bfloat16")
    toks = _prompts(0, (3,))[0][None]

    def last(p, c):
        return np.asarray(jax.jit(lambda p, t: jlm.forward(
            p, c, {"tokens": t})[0])(p, jnp.asarray(toks)), np.float32)[0, -1]

    l32, l16 = last(jparams, jcfg), last(jparams, j16)
    t = tlm.forward(weights.cast_params(tparams, t16), t16,
                    torch.from_numpy(toks).long())[0][0, -1].float().numpy()

    def rms(a):
        return float(np.sqrt((a * a).mean()))

    assert rms(t - l16) <= BF16_GAP * rms(l16 - l32), (rms(t - l16),
                                                       rms(l16 - l32))


def test_store_keeps_the_reference_state_dtypes_in_bf16(bridged):
    """After a bf16 engine's prefill and decode steps the per-slot state
    keeps the reference store's dtypes -- the shifts in bf16 (the
    reference casts the step's f32 shifts back on write), ``wkv`` in
    f32."""
    jparams, tparams = bridged
    j16 = dataclasses.replace(JCFG, dtype="bfloat16")
    t16 = dataclasses.replace(TCFG, dtype="bfloat16")
    prompts = _prompts(3, (5, 8))
    plist = [dict(max_new_tokens=4)] * 2
    _, jeng = _serve(JEngine, JRequest, JSP, jparams, j16, prompts, plist,
                     n_slots=2, max_len=32)
    _, teng = _serve(TEngine, TRequest, TSP, tparams, t16, prompts, plist,
                     n_slots=2, max_len=32)
    jleaves = jeng.store.denses
    tleaves = [teng.store.denses[0]["slot0"][k]
               for k in ("shift1", "shift2", "wkv")]
    assert [str(a.dtype) for a in jleaves] == ["bfloat16", "bfloat16",
                                               "float32"]
    assert [t.dtype for t in tleaves] == [torch.bfloat16, torch.bfloat16,
                                          torch.float32]
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]


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


def _scalar_replay(tparams, prompt, max_new, max_len):
    """One request alone: ``lm.prefill``, then greedy ``lm.decode_step``
    at scalar positions."""
    w = tlm.lm_head_weight(tparams, TCFG)
    h, cache = tlm.prefill(tparams, TCFG, torch.from_numpy(prompt)[None]
                           .long(), max_len)
    out = [int(torch.argmax(h @ w, -1)[0])]
    for i in range(max_new - 1):
        h, cache = tlm.decode_step(tparams, TCFG, torch.tensor([[out[-1]]]),
                                   cache, torch.tensor(len(prompt) + i,
                                                       dtype=torch.int32))
        out.append(int(torch.argmax(h @ w, -1)[0]))
    return out


def test_engine_matches_jax_engine_and_scalar_replay(bridged):
    """Five prompts on 4 slots, 10 tokens each, one fused step over the
    per-slot state.  Buckets of 4 rows with 3 live (a padding row
    repeating a live slot's row, token and state) occur as requests
    finish: the port's tokens are the JAX engine's and each request's
    scalar replay (a state written twice or advanced twice would part
    them), and each live slot's state after the run equals its replay's."""
    jparams, tparams = bridged
    prompts = _prompts(41, LENGTHS + (6, 12))
    plist = [dict(max_new_tokens=10)] * 5
    want, jeng = _serve(JEngine, JRequest, JSP, jparams, JCFG, prompts,
                        plist, n_slots=4, max_len=32)
    got, teng = _serve(TEngine, TRequest, TSP, tparams, TCFG, prompts, plist,
                       n_slots=4, max_len=32)
    assert got == want
    assert not teng.store.any_paged and teng.store.usage()["layout"] \
        == "dense"
    assert teng.stats["decode_steps"] == teng.stats["iterations"] \
        == jeng.stats["decode_steps"]
    assert teng.stats["fused_rows"] == jeng.stats["fused_rows"]
    assert teng.stats["fused_rows"] % 4 != 0        # a padded bucket ran
    for prompt, gen in zip(prompts, got):
        assert gen == _scalar_replay(tparams, prompt, 10, 32)


def test_padding_row_writes_its_slot_once(bridged):
    """One step of 3 live rows padded to 4 (the padding row repeats slot
    1): every slot's state after the step is its own single step from
    the state before, and the untouched slot 3 keeps its bits."""
    _, tparams = bridged
    tparams = weights.cast_params(tparams, TCFG)
    rng = np.random.default_rng(8)
    cache = tlm.init_cache(TCFG, 4, 32, "cpu")
    for leaf in cache[0]["slot0"].values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    before = {k: v.clone() for k, v in cache[0]["slot0"].items()}
    toks = torch.tensor([[5], [9], [17], [9]])
    rows = torch.tensor([0, 1, 2, 1])
    pos = torch.tensor([3, 4, 5, 4], dtype=torch.int32)
    h, _ = tlm.decode_step(tparams, TCFG, toks, cache, pos, cache_rows=rows)
    for slot, tok in ((0, 5), (1, 9), (2, 17)):
        one = [{"slot0": {k: v[:, slot:slot + 1].clone()
                          for k, v in before.items()}}]
        h1, one = tlm.decode_step(tparams, TCFG, torch.tensor([[tok]]), one,
                                  torch.tensor([int(pos[slot])],
                                               dtype=torch.int32))
        for k in before:
            torch.testing.assert_close(cache[0]["slot0"][k][:, slot],
                                       one[0]["slot0"][k][:, 0],
                                       rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(h[slot], h1[0], rtol=F32_TOL,
                                   atol=F32_TOL)
    torch.testing.assert_close(h[3], h[1], rtol=0, atol=0)
    for k in before:
        assert torch.equal(cache[0]["slot0"][k][:, 3], before[k][:, 3])


def test_mixed_samplers_match_jax(bridged):
    """Greedy, TopK and Temperature rows in one fused step: the JAX
    engine's tokens (the host pick draws from each request's seeded
    stream)."""
    jparams, tparams = bridged
    prompts = _prompts(9)
    plist = [dict(max_new_tokens=6), dict(max_new_tokens=6, top_k=4, seed=3),
             dict(max_new_tokens=6, temperature=0.7, seed=4)]
    want, _ = _serve(JEngine, JRequest, JSP, jparams, JCFG, prompts, plist,
                     n_slots=3, max_len=32)
    got, _ = _serve(TEngine, TRequest, TSP, tparams, TCFG, prompts, plist,
                    n_slots=3, max_len=32)
    assert got == want


def test_reduced_equals_softmax_tokens(bridged):
    _, tparams = bridged
    prompts = _prompts(7)
    outs = {}
    for mode in ("reduced", "softmax"):
        llm = LLM(tparams, TCFG, n_slots=3, max_len=32, head_mode=mode)
        outs[mode] = [list(o.token_ids) for o in llm.generate(
            prompts, TSP(max_new_tokens=8))]
    assert outs["reduced"] == outs["softmax"]


def test_spec_refused_chunk_and_stride_fall_back(bridged):
    """As the reference (``repro/serve/engine.py:432-433, 468-475,
    656-664``): recurrent state cannot rewind a rejected draft, so
    ``spec_k`` is refused with the reference's message; chunking and the
    device loop warn and fall back (prefix sharing off with them), and the
    tokens stay the one-shot, per-token engine's."""
    _, tparams = bridged
    prompt = _prompts(2)[1]
    eng = TEngine(tparams, TCFG, n_slots=1, max_len=32)
    assert not eng.spec_capable and not eng.chunk_capable
    assert not eng.multistep_capable
    with pytest.raises(ValueError, match="rejected drafts cannot be rewound"
                                         ".*'ssm' config does not qualify"):
        eng.submit(TRequest(0, prompt.copy(), params=TSP(spec_k=2)))
    with pytest.warns(UserWarning, match="chunk_size=8 ignored"):
        ceng = TEngine(tparams, TCFG, n_slots=2, max_len=32, chunk_size=8)
    with pytest.warns(UserWarning, match="host_stride=4 ignored"):
        seng = TEngine(tparams, TCFG, n_slots=2, max_len=32, host_stride=4)
    assert ceng.chunk_size is None and not ceng.prefix_cache
    assert seng.host_stride is None
    prompts = _prompts(4)
    plist = [dict(max_new_tokens=6)] * 3
    base, _ = _serve(TEngine, TRequest, TSP, tparams, TCFG, prompts, plist,
                     n_slots=2, max_len=32)
    for kw in (dict(chunk_size=8), dict(host_stride=4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, eng = _serve(TEngine, TRequest, TSP, tparams, TCFG, prompts,
                              plist, n_slots=2, max_len=32, **kw)
        assert got == base
        assert eng.stats["prefill_chunks"] == 0


def test_cli_serves_rwkv6_smoke(capsys):
    snap = cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "4", "--slots", "2", "--max-len", "48"])
    assert snap["completed"] == 4
    assert "kv=dense" in capsys.readouterr().out
    with pytest.raises(ValueError, match="rewound"):
        cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--requests", "1", "--spec-k", "2"])
