"""The rest of the dense family in the port against the JAX package, on
bridged weights at smoke size (f32): the non-GLU MLP of starcoder2-7b
(``gelu``) and nemotron-4-340b (``squared_relu``), the eval forward
``lm.forward`` and the dense admission ``api.serve_prefill``.

- ``activate`` for every kind against ``repro.models.layers.activate``:
  the relu forms bit for bit; silu and the tanh-approximated gelu to
  ``ACT_TOL`` (``torch`` and XLA evaluate ``tanh`` / ``exp`` with other
  polynomials, a few f32 ulps apart); ``mlp`` at ``F32_TOL``;
- the bridge carries both smoke trees (``w_in`` / ``w_out``) leaf for
  leaf;
- greedy, top-k and ``spec_k=4`` tokens from ``LLM`` equal the JAX
  package's for both configs;
- ``lm.forward`` logits within ``PREFILL_TOL`` of
  ``repro.models.lm.forward`` (the reference's train-mode attention is
  masked softmax, the port's the cache-less flash branch: the same
  function);
- ``api.serve_prefill``'s head output equals the reference's and its
  dense cache is within ``PREFILL_TOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402
from repro_torch.serve.sampler import Greedy, SoftmaxBaseline  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
PREFILL_TOL = 1e-4
ACT_TOL = 1e-6          # silu / gelu: rtol = atol
ARCHS = ("starcoder2-7b", "nemotron-4-340b")
ENGINE = dict(n_slots=3, max_len=64)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX cfg, port cfg, JAX params, numpy tree, port params)."""
    arch = request.param
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree.map(np.asarray, jparams)
    return (arch, jcfg, tcfg, jparams, np_tree,
            weights.from_numpy_params(np_tree, tcfg, "cpu"))


@pytest.mark.parametrize("kind", ["silu_glu", "gelu_glu", "gelu", "relu",
                                  "squared_relu", "relu_sq"])
def test_activate_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    u = rng.standard_normal((64, 96)).astype(np.float32)
    want = np.asarray(jlayers.activate(jnp.asarray(x), jnp.asarray(u), kind))
    got = tlayers.activate(torch.from_numpy(x), torch.from_numpy(u),
                           kind).numpy()
    if "relu" in kind:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=ACT_TOL, atol=ACT_TOL)


def test_activate_refuses_unknown_kinds():
    with pytest.raises(ValueError, match="swish"):
        tlayers.activate(torch.zeros(2), None, "swish")


@pytest.mark.parametrize("kind", ["silu_glu", "gelu", "squared_relu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(1)
    p = jax.tree.map(np.asarray, jlayers.init_mlp(key, 32, 48, kind))
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    want = np.asarray(jlayers.mlp(p, jnp.asarray(x), kind))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = tlayers.mlp(tp, torch.from_numpy(x), kind).numpy()
    assert set(p) == ({"w_gate", "w_up", "w_out"} if kind.endswith("_glu")
                      else {"w_in", "w_out"})
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_bridge_carries_the_non_glu_tree(family):
    arch, jcfg, tcfg, _, np_tree, tparams = family
    assert tcfg.activation == jcfg.activation != "silu_glu"
    mlp = tparams["decoder"][0]["slot0"]["mlp"]
    assert set(mlp) == {"w_in", "w_out"}
    np_mlp = np_tree["decoder"][0]["slot0"]["mlp"]
    for name in ("w_in", "w_out"):
        np.testing.assert_array_equal(mlp[name].numpy(), np_mlp[name])
    np.testing.assert_array_equal(tparams["lm_head"].numpy(),
                                  np_tree["lm_head"])
    shapes = weights.param_shapes(tcfg)["decoder"][0]["slot0"]["mlp"]
    L, d, f = tcfg.n_layers, tcfg.d_model, tcfg.d_ff
    assert shapes == {"w_in": ((L, d, f), d), "w_out": ((L, f, d), f)}


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    rep = np.tile(rng.integers(0, vocab, size=5), 5).astype(np.int32)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in (6, 19, 11)] + [rep]


@pytest.mark.parametrize("mode", ["greedy", "top_k", "spec_k"])
def test_llm_tokens_match_jax(family, mode):
    _, jcfg, tcfg, jparams, _, tparams = family
    prompts = _prompts(tcfg.vocab_size, 4)
    kw = {"greedy": {}, "top_k": dict(top_k=4, temperature=0.8),
          "spec_k": dict(spec_k=4)}[mode]
    sp = [dict(max_new_tokens=10, seed=10 + i, **kw)
          for i in range(len(prompts))]
    jouts = JLLM(jparams, jcfg, **ENGINE).generate(
        prompts, [JSP(**p) for p in sp])
    tllm = TLLM(tparams, tcfg, **ENGINE)
    touts = tllm.generate(prompts, [TSP(**p) for p in sp])
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    if mode == "spec_k":
        assert tllm.stats["drafted"] > 0


def test_forward_matches_jax(family):
    _, jcfg, tcfg, jparams, _, tparams = family
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jlogits, jaux = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tlogits, taux = tlm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    assert tlogits.dtype == torch.float32
    assert tuple(tlogits.shape) == (2, 13, tcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    assert taux == float(jaux) == 0.0


@pytest.mark.parametrize("head_mode", ["reduced", "softmax"])
def test_serve_prefill_matches_jax(family, head_mode):
    _, jcfg, tcfg, jparams, _, tparams = family
    sampler = Greedy() if head_mode == "reduced" else SoftmaxBaseline()
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jout, jcache = japi.serve_prefill(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)}, 16,
                                      head_mode)
    tout, tcache = tapi.serve_prefill(tparams, tcfg,
                                      torch.from_numpy(toks).long(), 16,
                                      sampler)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for name in ("k", "v"):
        got = tcache[0]["slot0"]["attn"][name]
        assert tuple(got.shape) == (tcfg.n_layers, 2, 16, tcfg.n_kv_heads,
                                    tcfg.head_dim)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcache[0]["slot0"]["attn"][name]),
            rtol=PREFILL_TOL, atol=PREFILL_TOL)
