"""The encdec family (seamless-m4t-large-v2's smoke config: an encoder of
bidirectional ``enc`` layers over the stub audio frontend's frame
embeddings, a decoder of ``xattn`` layers -- causal self-attention,
cross-attention over the encoder's output, MLP) in the port against the
JAX package, on bridged weights at smoke size (f32).

- the bridge carries the encoder, ``encoder_norm``, ``lnx`` and the
  cross-attention (no qk-norm scales) leaf for leaf;
- ``lm.encode`` and ``lm.forward`` within ``F32_TOL`` of the reference's
  (its train-mode attention is masked softmax, the port's the cache-less
  flash branch, non-causal in the encoder and over S_src != T keys in
  the cross-attention);
- ``lm.prefill`` + 4 ``decode_step``s equal ``forward`` at every
  position, the port's and the reference's (``test_decode_matches_forward``);
  the prefill's cache -- self K/V and the read-only ``xk`` / ``xv`` --
  is the reference's leaf for leaf within ``F32_TOL``, and a decode step
  never writes ``xk`` / ``xv``;
- the encoder rotates at the source positions and the cross-attention
  rotates nothing: a source embedding's position matters to the encoder
  alone;
- ``attention``'s read-only branch against the reference's;
- ``ServeEngine`` refuses the config with a ``ValueError`` (the
  reference's engine takes token prompts only);
- ``seeded_params(dtype=bf16)`` is the cast of the f32 draw, the encoder
  included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def encdec():
    """(JAX cfg, port cfg, JAX params, numpy tree, port params)."""
    jcfg, tcfg = j_smoke(J_ARCHS[ARCH]), smoke_config(get_config(ARCH))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(6))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_tree, weights.from_numpy_params(
        np_tree, tcfg, "cpu")


def _inputs(cfg, b=2, s=21, s_src=13, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    src = rng.standard_normal((b, s_src, cfg.d_model)).astype(np.float32)
    return toks, src


def _walk(a, b, path=()):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a),
                                                          set(b))
        for k in a:
            yield from _walk(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, path + (i,))
    else:
        yield path, np.asarray(a), b


def test_bridge_carries_the_encoder_and_cross_attention(encdec):
    _, tcfg, _, np_tree, tparams = encdec
    assert tlm.segments(tcfg) == [(("xattn",), tcfg.n_layers)]
    assert tlm.encoder_segments(tcfg) == [(("enc",), 2)]
    assert tlm.kv_layers(tcfg) == tcfg.n_layers
    slot = tparams["decoder"][0]["slot0"]
    assert set(slot) == {"ln1", "attn", "ln2", "mlp", "lnx", "xattn"}
    assert set(slot["xattn"]) == {"wq", "wk", "wv", "wo"}
    assert set(tparams["encoder"][0]["slot0"]) == {"ln1", "attn", "ln2",
                                                   "mlp"}
    n = 0
    for path, want, got in _walk(np_tree, tparams):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
        n += 1
    assert n == len(tree_mod.leaves(weights.param_shapes(tcfg)))
    bad = dict(np_tree)
    bad.pop("encoder")
    with pytest.raises(ValueError, match="keys"):
        weights.from_numpy_params(bad, tcfg, "cpu")


def test_full_tree_is_the_reference_tree():
    """The full config's shapes are the reference's ``init_params`` tree
    (``jax.eval_shape``: no values drawn), 1,632,131,072 values -- 3.26
    GB in bf16; ``param_count()`` is the analytic count, 23,552 more."""
    cfg = get_config(ARCH)
    want = jax.eval_shape(lambda: jlm.init_params(
        J_ARCHS[ARCH], jax.random.PRNGKey(0)))
    shapes = weights.param_shapes(cfg)
    for path, w, (shape, _) in _walk(
            jax.tree.map(lambda a: np.empty(0), want), shapes):
        assert tuple(shape) == tuple(tree_mod.get(want, path).shape), path
    n = sum(int(np.prod(shape)) for shape, _ in tree_mod.leaves(shapes))
    assert n == 1_632_131_072
    assert cfg.param_count() - n == 23_552


def test_encode_and_forward_match_jax(encdec):
    jcfg, tcfg, jparams, _, tparams = encdec
    toks, src = _inputs(tcfg)
    jenc = jlm.encode(jparams, jcfg, jnp.asarray(src))
    tenc = tlm.encode(tparams, tcfg, torch.from_numpy(src))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=F32_TOL,
                               atol=F32_TOL)
    jl, jaux = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                           "src_embeds": jnp.asarray(src)})
    tl, taux = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           src_embeds=torch.from_numpy(src))
    assert tuple(tl.shape) == (2, 21, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    assert float(taux) == float(jaux) == 0.0
    with pytest.raises(ValueError, match="src_embeds"):
        tlm.forward(tparams, tcfg, torch.from_numpy(toks).long())


def test_decode_matches_forward_and_the_cache_tree(encdec):
    """Teacher-forced: ``prefill`` of 16 tokens over 13 source frames,
    then 4 ``decode_step``s, give ``forward``'s logits over all 21 at
    every position (the port's and the reference's); the prefill's cache
    is the reference's leaf for leaf (self K/V zero-padded to max_len,
    cross K/V (L, B, S_src, Hkv, hd)); the steps leave ``xk`` / ``xv``
    bitwise as the prefill wrote them."""
    jcfg, tcfg, jparams, _, tparams = encdec
    toks, src = _inputs(tcfg, seed=1)
    S, extra, max_len = 16, 5, 21
    want = np.asarray(jlm.forward(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)})[0])
    t, ts = torch.from_numpy(toks).long(), torch.from_numpy(src)
    full = tlm.forward(tparams, tcfg, t, src_embeds=ts)[0].numpy()
    _, jcache = jlm.prefill(jparams, jcfg, {
        "tokens": jnp.asarray(toks[:, :S]), "src_embeds": jnp.asarray(src)},
        max_len)
    h, cache = tlm.prefill(tparams, tcfg, t[:, :S], max_len, src_embeds=ts)
    leaf = cache[0]["slot0"]
    assert tuple(leaf["xk"].shape) == (tcfg.n_layers, 2, 13, tcfg.n_kv_heads,
                                       tcfg.head_dim)
    for path, w, g in _walk(jax.tree.map(np.asarray, jcache), cache):
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=str(path))
    xk, xv = leaf["xk"].clone(), leaf["xv"].clone()
    got = [tlm.logits_fn(tparams, tcfg, h).numpy()]
    for i in range(extra - 1):
        h, cache = tlm.decode_step(tparams, tcfg, t[:, S + i:S + i + 1],
                                   cache, torch.tensor(S + i))
        got.append(tlm.logits_fn(tparams, tcfg, h).numpy())
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, full[:, S - 1 + i], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(g, want[:, S - 1 + i], rtol=F32_TOL,
                                   atol=F32_TOL)
    assert torch.equal(leaf["xk"], xk) and torch.equal(leaf["xv"], xv)


def test_decode_needs_the_cross_kv(encdec):
    _, tcfg, _, _, tparams = encdec
    cache = tlm.init_cache(tcfg, 1, 8, "cpu")
    assert "xk" not in cache[0]["slot0"]
    with pytest.raises(ValueError, match="cross K/V"):
        tlm.decode_step(tparams, tcfg, torch.zeros((1, 1), dtype=torch.long),
                        cache, torch.tensor(0))
    sized = tlm.init_cache(tcfg, 1, 8, "cpu", src_len=5)[0]["slot0"]
    assert tuple(sized["xv"].shape) == (tcfg.n_layers, 1, 5,
                                        tcfg.n_kv_heads, tcfg.head_dim)


def test_rotation_follows_each_attention(encdec):
    """Rolling the source frames by one position changes the encoder's
    output (RoPE at the source positions) beyond a roll of it; with the
    encoder's output fixed, the cross-attention is blind to the order
    of its keys (no rotation, no mask)."""
    _, tcfg, _, _, tparams = encdec
    toks, src = _inputs(tcfg, b=1, seed=2)
    ts = torch.from_numpy(src)
    enc = tlm.encode(tparams, tcfg, ts)
    rolled = tlm.encode(tparams, tcfg, torch.roll(ts, 1, dims=1))
    assert float((torch.roll(enc, 1, dims=1) - rolled).abs().max()) > 1e-3
    p = tlm.layer_params(tparams, tcfg)[0][0][0]
    x = tparams["embed"][torch.from_numpy(toks).long()]
    a, _ = tlayers.attention(p["xattn"], x, tcfg, consts=None, kv_x=enc,
                             causal=False)
    b, _ = tlayers.attention(p["xattn"], x, tcfg, consts=None,
                             kv_x=torch.roll(enc, 3, dims=1), causal=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_read_only_attention_matches_jax(encdec):
    """The read-only branch (a decode step's cross-attention) against
    the reference's: T 3 queries over 7 cached rows, and the cache-less
    ``kv_x`` branch over the same K/V."""
    jcfg, tcfg, jparams, _, tparams = encdec
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0],
                      jparams["decoder"][0]["slot0"]["xattn"])
    tp = tlm.layer_params(tparams, tcfg)[0][0][0]["xattn"]
    k, v = jlm._cross_kv({"xattn": jp}, jnp.asarray(kv_x), jcfg)
    want, extra = jlayers.attention(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.arange(3), kv_x=None,
                                    causal=False, cache={"k": k, "v": v},
                                    cache_pos=None)
    assert extra is None
    got, textra = tlayers.attention(
        tp, torch.from_numpy(x), tcfg, consts=None,
        cache={"k": torch.from_numpy(np.array(k)),
               "v": torch.from_numpy(np.array(v))})
    assert textra is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    fresh, _ = tlayers.attention(tp, torch.from_numpy(x), tcfg, consts=None,
                                 kv_x=torch.from_numpy(kv_x), causal=False)
    np.testing.assert_allclose(fresh.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_the_engine_refuses_the_config(encdec):
    _, tcfg, _, _, tparams = encdec
    with pytest.raises(ValueError, match="token prompts only"):
        ServeEngine(tparams, tcfg)
    with pytest.raises(ValueError, match="token prompts only"):
        TLLM.from_arch(ARCH, smoke=True, device="cpu")


def test_seeded_params_in_the_compute_dtype_is_the_cast():
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                              dtype="bfloat16")
    want = weights.cast_params(weights.seeded_params(cfg, 1, "cpu"), cfg)
    got = weights.seeded_params(cfg, 1, "cpu", dtype=torch.bfloat16)
    assert set(got) == {"embed", "final_norm", "decoder", "lm_head",
                        "encoder", "encoder_norm"}
    for (path, a), (_, b) in zip(tree_mod.items(want), tree_mod.items(got)):
        assert torch.equal(a, b) and a.stride() == b.stride(), path


def _pipeline_pair(arch, seed, dtype):
    """(reference batch fn, port batch fn) of one config's pipelines, the
    reference's on a one-device host mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import ShapeSpec as JShape
    from repro.data import pipeline as jpipe
    from repro.launch.mesh import make_host_mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline as tpipe

    jcfg = dataclasses.replace(j_smoke(J_ARCHS[arch]), dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config(arch)), dtype=dtype)
    mesh = make_host_mesh()
    jp = jpipe.TokenPipeline(
        jpipe.DataConfig(seed=seed, vocab_size=256), jcfg,
        JShape("t", 12, 3, "train"), mesh,
        NamedSharding(mesh, P("data", None)))
    tp = tpipe.TokenPipeline(tpipe.DataConfig(seed=seed, vocab_size=256),
                             tcfg, ShapeSpec("t", 12, 3, "train"), "cpu")
    return jp.batch, tp.batch


def _as_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not \
        torch.is_tensor(x) else x.float().numpy()


@pytest.mark.parametrize("seed,step,dtype", [(0, 0, "float32"),
                                             (3, 5, "bfloat16"),
                                             (11, 1000, "float32")])
def test_stub_embeds_equal_the_reference(seed, step, dtype):
    """``TokenPipeline.batch``'s ``src_embeds`` (B, S, D), from
    ``pipeline._stub_embeds``, bit for bit the reference's, in the
    compute dtype; the tokens too."""
    jbatch, tbatch = _pipeline_pair(ARCH, seed, dtype)
    jb, tb = jbatch(step), tbatch(step)
    assert set(tb) == {"tokens", "labels", "src_embeds"}
    assert tb["src_embeds"].dtype == getattr(torch, dtype)
    assert tuple(tb["src_embeds"].shape) == (3, 12, 64)
    np.testing.assert_array_equal(_as_np(tb["src_embeds"]),
                                  _as_np(jb["src_embeds"]))
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
