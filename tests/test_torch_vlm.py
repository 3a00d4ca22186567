"""The vlm family (internvl2-26b's smoke config: the dense decoder with
the stub vision frontend's patch embeddings in the first
``num_image_tokens`` positions) in the port against the JAX package, on
bridged weights at smoke size (f32).

- ``lm.forward`` logits with the image embeddings within ``F32_TOL`` of
  ``repro.models.lm.forward`` (the reference's train-mode attention is
  masked softmax, the port's the cache-less flash branch: the same
  function), the router loss 0;
- ``lm.prefill`` with the embeddings, then 4 ``decode_step``s, equal the
  port's and the reference's ``forward`` at every position within
  ``F32_TOL`` (the reference's ``test_decode_matches_forward``), and the
  prefill's cache is the reference's within ``F32_TOL``;
- the prefix changes the output (the reference's
  ``test_vlm_prefix_changes_output``);
- the engine pages the family's K/V, is ``spec_capable`` and
  ``chunk_capable`` as the reference's is, and its greedy, chunked and
  ``spec_k`` tokens equal ``repro.serve.api.LLM``'s;
- ``weights.seeded_params(dtype=bfloat16)`` is bit for bit the cast of
  the f32 draw, the head's layout included, and ``cast_params`` copies
  nothing of a tree already cast; ``LLM.from_arch`` serves it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

ARCH = "internvl2-26b"
F32_TOL = 1e-4
ENGINE = dict(n_slots=3, max_len=64)


@pytest.fixture(scope="module")
def vlm():
    """(JAX cfg, port cfg, JAX params, port params)."""
    jcfg, tcfg = j_smoke(J_ARCHS[ARCH]), smoke_config(get_config(ARCH))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, weights.from_numpy_params(np_tree, tcfg,
                                                          "cpu")


def _inputs(cfg, b=2, s=21, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, img


def _logits(params, cfg, h):
    return tlm.logits_fn(params, cfg, h).numpy()


def test_config_is_the_dense_program_with_an_image_prefix(vlm):
    _, tcfg, _, tparams = vlm
    assert tcfg.family == "vlm" and tcfg.num_image_tokens == 8
    assert tlm.segments(tcfg) == [(("attn",), tcfg.n_layers)]
    assert tlm.kv_layers(tcfg) == tcfg.n_layers
    assert "lm_head" in tparams and "encoder" not in tparams


def test_forward_matches_jax(vlm):
    jcfg, tcfg, jparams, tparams = vlm
    toks, img = _inputs(tcfg)
    jl, jaux = jlm.forward(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})
    tl, taux = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           image_embeds=torch.from_numpy(img))
    assert tuple(tl.shape) == (2, 21, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    assert float(taux) == float(jaux) == 0.0


def test_embed_tokens_puts_the_image_first(vlm):
    """The first n positions are the embeddings, cast to the compute
    dtype; the rest the tokens' rows.  Without embeddings, or under a
    config without ``num_image_tokens``, the tokens alone."""
    _, tcfg, _, tparams = vlm
    toks, img = _inputs(tcfg, s=12)
    t = torch.from_numpy(toks).long()
    x = tlm.embed_tokens(tparams, tcfg, t, torch.from_numpy(img).double())
    n = tcfg.num_image_tokens
    assert x.dtype == torch.float32
    assert torch.equal(x[:, :n], torch.from_numpy(img))
    assert torch.equal(x[:, n:], tparams["embed"][t[:, n:]])
    assert torch.equal(tlm.embed_tokens(tparams, tcfg, t),
                       tparams["embed"][t])
    plain = dataclasses.replace(tcfg, num_image_tokens=0)
    assert torch.equal(tlm.embed_tokens(tparams, plain, t,
                                        torch.from_numpy(img)),
                       tparams["embed"][t])


def test_decode_matches_forward(vlm):
    """Teacher-forced: ``prefill`` of 16 tokens with the image prefix,
    then 4 ``decode_step``s, give the logits of ``forward`` over all 21 at
    every position -- the port's forward and the reference's; the
    prefill's dense cache is the reference's."""
    jcfg, tcfg, jparams, tparams = vlm
    toks, img = _inputs(tcfg, seed=1)
    S, extra, max_len = 16, 5, 21
    want = np.asarray(jlm.forward(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})[0])
    full = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                       image_embeds=torch.from_numpy(img))[0].numpy()
    t = torch.from_numpy(toks).long()
    h, cache = tlm.prefill(tparams, tcfg, t[:, :S], max_len,
                           image_embeds=torch.from_numpy(img))
    got = [_logits(tparams, tcfg, h)]
    for i in range(extra - 1):
        h, cache = tlm.decode_step(tparams, tcfg, t[:, S + i:S + i + 1],
                                   cache, torch.tensor(S + i))
        got.append(_logits(tparams, tcfg, h))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, full[:, S - 1 + i], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(g, want[:, S - 1 + i], rtol=F32_TOL,
                                   atol=F32_TOL)
    _, jcache = jlm.prefill(jparams, jcfg, {
        "tokens": jnp.asarray(toks[:, :S]),
        "image_embeds": jnp.asarray(img)}, max_len)
    _, tcache = tlm.prefill(tparams, tcfg, t[:, :S], max_len,
                            image_embeds=torch.from_numpy(img))
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[0]["slot0"]["attn"][name].numpy(),
            np.asarray(jcache[0]["slot0"]["attn"][name]), rtol=F32_TOL,
            atol=F32_TOL)


def test_vlm_prefix_changes_output(vlm):
    _, tcfg, _, tparams = vlm
    toks, img = _inputs(tcfg)
    t = torch.from_numpy(toks).long()
    l1, _ = tlm.forward(tparams, tcfg, t, image_embeds=torch.from_numpy(img))
    l2, _ = tlm.forward(tparams, tcfg, t,
                        image_embeds=torch.from_numpy(img + 1.0))
    assert float((l1 - l2).abs().max()) > 1e-4


def test_engine_pages_and_matches_jax_capabilities(vlm):
    jcfg, tcfg, jparams, tparams = vlm
    j = JLLM(jparams, jcfg, **ENGINE).engine
    t = TLLM(tparams, tcfg, **ENGINE).engine
    assert t.store.any_paged and j.store.any_paged
    assert (t.spec_capable, t.chunk_capable) == \
        (j.spec_capable, j.chunk_capable) == (True, True)


@pytest.mark.parametrize("mode", ["greedy", "chunk", "spec_k"])
def test_llm_tokens_match_jax(vlm, mode):
    """Token prompts, as the reference's engine serves them (no image
    embeddings reach an engine): greedy, chunked prefill at 8 and
    ``spec_k=4``, the port's tokens equal the JAX package's."""
    jcfg, tcfg, jparams, tparams = vlm
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 19, 11, 25)]
    kw = dict(ENGINE, chunk_size=8) if mode == "chunk" else ENGINE
    sp = dict(max_new_tokens=10, spec_k=4 if mode == "spec_k" else 0)
    jouts = JLLM(jparams, jcfg, **kw).generate(prompts, JSP(**sp))
    tllm = TLLM(tparams, tcfg, **kw)
    touts = tllm.generate(prompts, TSP(**sp))
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    if mode == "spec_k":
        assert tllm.stats["drafted"] > 0


def test_seeded_params_in_the_compute_dtype_is_the_cast():
    """``seeded_params(dtype=bf16)`` == ``cast_params`` of the f32 draw,
    bit for bit, with the untied head stored (V, D) row-major; casting
    that tree again copies no leaf."""
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                              dtype="bfloat16")
    want = weights.cast_params(weights.seeded_params(cfg, 3, "cpu"), cfg)
    got = weights.seeded_params(cfg, 3, "cpu", dtype=torch.bfloat16)
    for (path, a), (_, b) in zip(tree_mod.items(want), tree_mod.items(got)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), path
        assert a.stride() == b.stride(), path
    assert got["lm_head"].t().is_contiguous()
    again = weights.cast_params(got, cfg)
    for (path, a), (_, b) in zip(tree_mod.items(got), tree_mod.items(again)):
        assert a.data_ptr() == b.data_ptr(), path


def test_from_arch_serves_the_seeded_tree():
    llm = TLLM.from_arch(ARCH, smoke=True, device="cpu", seed=5,
                         dtype="bfloat16", **ENGINE)
    cfg = llm.cfg
    want = weights.cast_params(weights.seeded_params(cfg, 5, "cpu"), cfg)
    for (path, a), (_, b) in zip(tree_mod.items(want),
                                 tree_mod.items(llm.engine.params)):
        assert torch.equal(a, b), path
    assert llm.engine.store.any_paged
    out = llm.generate([[3, 1, 4, 1, 5]], TSP(max_new_tokens=4))
    assert len(out[0].token_ids) == 4


@pytest.mark.parametrize("seed,step,dtype", [(0, 0, "float32"),
                                             (2, 9, "bfloat16"),
                                             (7, 123, "float32")])
def test_stub_image_embeds_equal_the_reference(seed, step, dtype):
    """``TokenPipeline.batch``'s ``image_embeds`` (B, num_image_tokens,
    D) bit for bit the reference's (a one-device host mesh), in the
    compute dtype, and ``train_loss`` takes the batch."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import ShapeSpec as JShape
    from repro.data import pipeline as jpipe
    from repro.launch.mesh import make_host_mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline as tpipe
    from repro_torch.models import api as tapi

    jcfg = dataclasses.replace(j_smoke(J_ARCHS[ARCH]), dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_config(ARCH)), dtype=dtype)
    mesh = make_host_mesh()
    jb = jpipe.TokenPipeline(
        jpipe.DataConfig(seed=seed, vocab_size=256), jcfg,
        JShape("t", 16, 2, "train"), mesh,
        NamedSharding(mesh, P("data", None))).batch(step)
    tb = tpipe.TokenPipeline(tpipe.DataConfig(seed=seed, vocab_size=256),
                             tcfg, ShapeSpec("t", 16, 2, "train"),
                             "cpu").batch(step)
    assert set(tb) == {"tokens", "labels", "image_embeds"}
    assert tb["image_embeds"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        tb["image_embeds"].float().numpy(),
        np.asarray(jb["image_embeds"].astype(jnp.float32)))
    loss = tapi.train_loss(weights.seeded_params(tcfg, 0, "cpu"), tcfg, tb)
    assert torch.isfinite(loss)
