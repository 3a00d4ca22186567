"""The hybrid RG-LRU family (recurrentgemma-2b) in the port against the
JAX package, on weights bridged from ``repro.models.lm.init_params`` at
the smoke size (3 layers (rec, rec, attn), d 64, window 16, lru 64, f32).

- ``models.rglru.rglru_block`` against ``repro.models.rglru.rglru_block``
  at T = 1 and T = S, from a zero state and from a carried one;
- the ring buffer branch of ``layers.attention`` at T = 1 against the
  reference's (a cache exactly ``window`` long, ragged positions past the
  window);
- ``lm.forward`` and ``lm.prefill`` + ``lm.decode_step`` on prompts of 4,
  11 and 19 tokens (straddling the window of 16), and the block program's
  remainder unit at 5 layers (1 x (rec, rec, attn) + 1 x (rec, rec));
- the engine's ragged greedy tokens against the JAX ``ServeEngine``'s and
  the port's own scalar replay (``tests/test_serve_paged.py:288``), with
  a bucket that pads 3 rows to 4, and reduced == softmax tokens
  (``tests/test_system.py:73``);
- the window masks far tokens (``tests/test_models.py:141``);
- ``spec_k`` refused and ``chunk_size`` / ``host_stride`` falling back
  (``tests/test_spec_decode.py:450-460``), the CLI at ``--smoke --device
  cpu``.

Tolerance: hidden states, logits and written state within ``F32_TOL``
(2e-5, the port's f32 tolerance elsewhere); tokens equal.

In bf16 (the served dtype): ``rglru_block``'s output within two bf16
steps (``BF16_TOL``, atol = rtol), its f32 ``h`` within ``F32_TOL`` and
its bf16 conv state bitwise; ``lm.prefill`` + ``lm.decode_step`` along
JAX's greedy tokens, past the window, no farther from JAX's bf16 hidden
state (RMS) than ``BF16_GAP`` times JAX's own bf16 is from its f32.
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
from repro.models import rglru as jrg  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7          # two bf16 steps
BF16_GAP = 2.0                # port bf16 vs JAX bf16, in JAX bf16-vs-f32 RMS
ARCH = "recurrentgemma-2b"
JCFG = j_smoke(J_ARCHS[ARCH])
TCFG = smoke_config(get_config(ARCH))
LENGTHS = (4, 11, 19)                  # straddle the smoke window of 16


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
# The block, the ring, the model
# ---------------------------------------------------------------------------
def test_block_program_and_tree_follow_the_reference(bridged):
    assert tlm.segments(TCFG) == jlm.segments(JCFG)
    full = get_config(ARCH)
    assert tlm.segments(full) == [(("rec", "rec", "attn"), 8),
                                  (("rec", "rec"), 1)]
    assert tlm.layer_types(full) == jlm.layer_types(J_ARCHS[ARCH])
    shapes = weights.param_shapes(full)
    assert [len(seg) for seg in shapes["decoder"]] == [3, 2]
    assert shapes["decoder"][0]["slot0"]["rec"]["w_a"][0] == (8, 10, 256,
                                                              256)
    assert shapes["decoder"][1]["slot1"]["rec"]["lam"][0] == (1, 2560)
    assert "lm_head" not in shapes                       # tied
    lam = weights.seeded_params(TCFG, 0, "cpu")["decoder"][0]["slot0"][
        "rec"]["lam"]
    a = torch.sigmoid(lam) ** trg.C                     # in [0.9, 0.999]
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", [1, 19])
def test_rglru_block_matches_jax(bridged, T, carried):
    jparams, tparams = bridged
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"][0]["slot0"]["rec"])
    tp = {k: v[0] for k, v in tparams["decoder"][0]["slot0"]["rec"].items()}
    rng = np.random.default_rng(T + 10 * carried)
    x = rng.standard_normal((2, T, TCFG.d_model)).astype(np.float32)
    lw = TCFG.lru_width
    if carried:
        conv = rng.standard_normal((2, TCFG.conv1d_width - 1, lw))
        h = rng.standard_normal((2, lw))
    else:
        conv = np.zeros((2, TCFG.conv1d_width - 1, lw))
        h = np.zeros((2, lw))
    conv, h = conv.astype(np.float32), h.astype(np.float32)
    jy, jst = jrg.rglru_block(jp, jnp.asarray(x), JCFG,
                              {"conv": jnp.asarray(conv),
                               "h": jnp.asarray(h)})
    ty, tst = trg.rglru_block(tp, torch.from_numpy(x), TCFG,
                              {"conv": torch.from_numpy(conv),
                               "h": torch.from_numpy(h)})
    _close(ty, jy)
    _close(tst["conv"], jst["conv"])
    _close(tst["h"], jst["h"])
    assert tst["h"].dtype == torch.float32


@pytest.mark.parametrize("T", [1, 19])
def test_rglru_block_matches_jax_in_bf16(bridged, T):
    """The block in bf16 from a carried state: the reference casts x and
    the conv state to bf16 and keeps the gates, the scan and h in f32;
    the port must round where it rounds."""
    jparams, tparams = bridged
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, dtype="bfloat16")
    jp = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16),
                      jparams["decoder"][0]["slot0"]["rec"])
    tp = {k: v[0] for k, v in weights.cast_params(
        tparams, tcfg)["decoder"][0]["slot0"]["rec"].items()}
    rng = np.random.default_rng(30 + T)
    lw = TCFG.lru_width
    x = rng.standard_normal((2, T, TCFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, TCFG.conv1d_width - 1, lw)).astype(
        np.float32)
    h = rng.standard_normal((2, lw)).astype(np.float32)
    jy, jst = jrg.rglru_block(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                              {"conv": jnp.asarray(conv, jnp.bfloat16),
                               "h": jnp.asarray(h)})
    ty, tst = trg.rglru_block(tp, torch.from_numpy(x).bfloat16(), tcfg,
                              {"conv": torch.from_numpy(conv).bfloat16(),
                               "h": torch.from_numpy(h)})
    assert ty.dtype == tst["conv"].dtype == torch.bfloat16
    assert tst["h"].dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_array_equal(tst["conv"].float().numpy(),
                                  np.asarray(jst["conv"], np.float32))
    _close(tst["h"], jst["h"])


def test_prefill_and_decode_track_jax_in_bf16():
    """5 layers (the remainder unit too) in bf16: prefill each prompt (4,
    11, 19 tokens), then 12 greedy steps along JAX's tokens (past
    positions 16 and 32: the ring wraps).  At every step the port's bf16
    hidden state is no farther (RMS) from JAX's bf16 one than
    ``BF16_GAP`` times JAX's bf16 is from JAX's f32 on the same tokens:
    a wrong cast, a garbled ring or conv state, or a state advanced
    twice would sit at the hidden state's own size instead."""
    jcfg = dataclasses.replace(JCFG, n_layers=5)
    tcfg = dataclasses.replace(TCFG, n_layers=5)
    jparams, tparams = _bridge(jcfg, tcfg, seed=5)
    j16 = dataclasses.replace(jcfg, dtype="bfloat16")
    t16 = dataclasses.replace(tcfg, dtype="bfloat16")
    tparams = weights.cast_params(tparams, t16)
    jw = jlm.lm_head_weight(jlm.cast_params(jparams, j16), j16).astype(
        jnp.float32)
    max_len = 40
    pre = {c: jax.jit(lambda p, t, c=c: jlm.prefill(p, c, {"tokens": t},
                                                    max_len))
           for c in (j16, jcfg)}
    dec = {c: jax.jit(lambda p, t, k, pos, c=c: jlm.decode_step(
        p, c, t, k, pos)) for c in (j16, jcfg)}

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
        jh32, jc32 = pre[jcfg](jparams, jt)
        th, tc = tlm.prefill(tparams, t16, torch.from_numpy(prompt)[None]
                             .long(), max_len)
        assert th.dtype == torch.bfloat16
        held(th, jh, jh32, (len(prompt), "prefill"))
        for i in range(12):
            tok = int(jnp.argmax(jh.astype(jnp.float32) @ jw, -1)[0])
            pos = len(prompt) + i
            jtok = jnp.asarray([[tok]], jnp.int32)
            jh, jc = dec[j16](jparams, jtok, jc, jnp.int32(pos))
            jh32, jc32 = dec[jcfg](jparams, jtok, jc32, jnp.int32(pos))
            th, tc = tlm.decode_step(tparams, t16, torch.tensor([[tok]]),
                                     tc, torch.tensor(pos,
                                                      dtype=torch.int32))
            held(th, jh, jh32, (len(prompt), pos))


def test_ring_attention_matches_jax(bridged):
    """The ring branch at T = 1, ragged rows at positions before, at and
    past the window: the K/V written at pos % window, masked to the
    positions the ring still holds."""
    jparams, tparams = bridged
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"][0]["slot2"]["attn"])
    tp = {k: v[0] for k, v in tparams["decoder"][0]["slot2"]["attn"].items()}
    w = TCFG.attention_window
    rng = np.random.default_rng(5)
    cp = np.array([3, 15, 16, 37], np.int32)
    x = rng.standard_normal((4, 1, TCFG.d_model)).astype(np.float32)
    shape = (4, w, TCFG.n_kv_heads, TCFG.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    jout, jnew = jlayers.attention(
        jp, jnp.asarray(x), JCFG, positions=jnp.asarray(cp[:, None]),
        window=w, cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_pos=jnp.asarray(cp))
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    consts = tlayers.step_constants(
        TCFG, torch.from_numpy(cp[:, None]), cache_pos=torch.from_numpy(cp),
        cache_len=w, window=w)
    assert consts.ring
    out, _ = tlayers.attention(tp, torch.from_numpy(x), TCFG, consts=consts,
                               window=w, cache=cache)
    _close(out, jout)
    for n in ("k", "v"):
        _close(cache[n], jnew[n])


@pytest.mark.parametrize("n_layers", [3, 5])
def test_forward_prefill_and_decode_match_jax(n_layers):
    """``lm.forward``'s logits; then, per prompt (4, 11, 19 tokens),
    ``lm.prefill`` and greedy ``lm.decode_step`` -- hidden states within
    F32_TOL and the same tokens.  At 5 layers the block program has a
    remainder unit (rec, rec)."""
    jcfg = dataclasses.replace(JCFG, n_layers=n_layers)
    tcfg = dataclasses.replace(TCFG, n_layers=n_layers)
    jparams, tparams = _bridge(jcfg, tcfg, seed=n_layers)
    assert len(tlm.segments(tcfg)) == (1 if n_layers == 3 else 2)
    prompts = _prompts(n_layers)
    toks = np.stack([np.resize(p, 24) for p in prompts])
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    tl, aux = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert aux == 0.0
    w = tlm.lm_head_weight(tparams, tcfg)
    jw = jlm.lm_head_weight(jparams, jcfg)
    max_len = 40                                  # a ring of 16 rows
    jprefill = jax.jit(lambda p, t: jlm.prefill(p, jcfg, {"tokens": t},
                                                max_len))
    jdecode = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, jcfg, t, c,
                                                           pos))
    for prompt in prompts:
        jh, jc = jprefill(jparams, jnp.asarray(prompt)[None])
        th, tc = tlm.prefill(tparams, tcfg,
                             torch.from_numpy(prompt)[None].long(), max_len)
        _close(th, jh)
        for i in range(10):              # decode past position 16 and 32
            tok = int(torch.argmax(th @ w, -1)[0])
            assert tok == int(jnp.argmax(jh @ jw, -1)[0])
            pos = len(prompt) + i
            jh, jc = jdecode(jparams, jnp.asarray([[tok]], jnp.int32), jc,
                             jnp.int32(pos))
            th, tc = tlm.decode_step(tparams, tcfg,
                                     torch.tensor([[tok]]), tc,
                                     torch.tensor(pos, dtype=torch.int32))
            _close(th, jh)


def test_sliding_window_masks_far_tokens(bridged):
    """As ``tests/test_models.py:141``: changing token 0 moves position
    1's logits more than position 39's (only the recurrent layers carry
    it past the window), on the port and the reference alike."""
    jparams, tparams = bridged
    t1 = np.random.default_rng(3).integers(0, TCFG.vocab_size, (1, 40))
    t2 = t1.copy()
    t2[:, 0] = (t1[:, 0] + 1) % TCFG.vocab_size
    l1, _ = tlm.forward(tparams, TCFG, torch.from_numpy(t1))
    l2, _ = tlm.forward(tparams, TCFG, torch.from_numpy(t2))
    near = float((l1[:, 1] - l2[:, 1]).abs().max())
    far = float((l1[:, -1] - l2[:, -1]).abs().max())
    assert near > far * 0.5 or near > 1e-6
    j1, _ = jax.jit(lambda p, t: jlm.forward(p, JCFG, {"tokens": t}))(
        jparams, jnp.asarray(t1))
    _close(l1, j1)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _serve(E, R, params, cfg, prompts, max_new, **kw):
    eng = E(params, cfg, eos_id=-1, **kw)
    reqs = [R(i, p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
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
    """Five prompts on 4 slots, 12 tokens each: the fused ragged step
    through the ring buffers and the recurrent state.  Buckets of 4 rows
    with 3 live (one padding row repeating a live slot) occur as requests
    finish; the port's tokens are the JAX engine's and each request's
    scalar replay."""
    jparams, tparams = bridged
    prompts = _prompts(41, LENGTHS + (7, 15))
    want, jeng = _serve(JEngine, JRequest, jparams, JCFG, prompts, 12,
                        n_slots=4, max_len=40)
    got, teng = _serve(TEngine, TRequest, tparams, TCFG, prompts, 12,
                       n_slots=4, max_len=40)
    assert got == want
    assert not teng.store.any_paged and teng.store.usage()["layout"] \
        == "dense"
    assert teng.stats["decode_steps"] == teng.stats["iterations"] \
        == jeng.stats["decode_steps"]
    assert teng.stats["fused_rows"] == jeng.stats["fused_rows"]
    assert teng.stats["fused_rows"] % 4 != 0        # a padded bucket ran
    for prompt, gen in zip(prompts, got):
        assert gen == _scalar_replay(tparams, prompt, 12, 40)


def test_reduced_equals_softmax_tokens(bridged):
    _, tparams = bridged
    prompts = _prompts(7)
    outs = {}
    for mode in ("reduced", "softmax"):
        llm = LLM(tparams, TCFG, n_slots=3, max_len=40, head_mode=mode)
        outs[mode] = [list(o.token_ids) for o in llm.generate(
            prompts, TSP(max_new_tokens=8))]
    assert outs["reduced"] == outs["softmax"]


def test_mixed_samplers_match_jax(bridged):
    """TopK and Temperature rows beside greedy ones, one fused step."""
    from repro.serve.params import SamplingParams as JSP

    jparams, tparams = bridged
    prompts = _prompts(9)
    plist = [dict(max_new_tokens=6), dict(max_new_tokens=6, top_k=4,
                                          seed=3),
             dict(max_new_tokens=6, temperature=0.7, seed=4)]
    want, _ = _serve_params(JEngine, JRequest, JSP, jparams, JCFG, prompts,
                            plist)
    got, _ = _serve_params(TEngine, TRequest, TSP, tparams, TCFG, prompts,
                           plist)
    assert got == want


def _serve_params(E, R, SP, params, cfg, prompts, plist):
    eng = E(params, cfg, eos_id=-1, n_slots=3, max_len=40)
    reqs = [R(i, p, params=SP(**kw))
            for i, (p, kw) in enumerate(zip(prompts, plist))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [[int(t) for t in r.generated] for r in reqs], eng


def test_spec_refused_chunk_and_stride_fall_back(bridged):
    """As ``tests/test_spec_decode.py:450-460``: a ring or a recurrence
    cannot rewind a rejected draft, so ``spec_k`` is refused; chunking
    and the device loop warn and fall back, and the tokens stay the
    one-shot, per-token engine's."""
    _, tparams = bridged
    prompt = _prompts(2)[1]
    eng = TEngine(tparams, TCFG, n_slots=1, max_len=32)
    assert not eng.spec_capable and not eng.chunk_capable
    assert not eng.multistep_capable
    with pytest.raises(ValueError, match="rewound"):
        eng.submit(TRequest(0, prompt.copy(), params=TSP(spec_k=2)))
    eng.submit(TRequest(1, prompt.copy(), params=TSP(max_new_tokens=2)))
    eng.run()
    with pytest.warns(UserWarning, match="chunk_size=8 ignored"):
        ceng = TEngine(tparams, TCFG, n_slots=2, max_len=40, chunk_size=8)
    with pytest.warns(UserWarning, match="host_stride=4 ignored"):
        seng = TEngine(tparams, TCFG, n_slots=2, max_len=40, host_stride=4)
    assert ceng.chunk_size is None and not ceng.prefix_cache
    assert seng.host_stride is None
    prompts = _prompts(4)
    base, _ = _serve(TEngine, TRequest, tparams, TCFG, prompts, 6,
                     n_slots=2, max_len=40)
    for kw in (dict(chunk_size=8), dict(host_stride=4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, eng = _serve(TEngine, TRequest, tparams, TCFG, prompts, 6,
                              n_slots=2, max_len=40, **kw)
        assert got == base
        assert eng.stats["prefill_chunks"] == 0
    with pytest.raises(ValueError, match="paged decode path"):
        TEngine(tparams, TCFG, n_slots=1, max_len=32, attn_approx="pseudo")


def test_cli_serves_recurrentgemma_smoke(capsys):
    snap = cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "4", "--slots", "2", "--max-len", "48"])
    assert snap["completed"] == 4
    assert "kv=dense" in capsys.readouterr().out
    with pytest.raises(ValueError, match="rewound"):
        cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--requests", "1", "--spec-k", "2"])

