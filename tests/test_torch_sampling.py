"""Sampled serving in the port against the JAX package, on the CPU.

  - the plain top-k and verify versions (``repro_torch.kernels.ref``,
    reached through ``ops``) against ``repro.kernels.ref`` and the Pallas
    ``fused_topk_head`` / ``fused_verify_head`` in interpret mode, with
    planted ties across vocab tiles;
  - ``repro_torch.core.reduced_softmax`` against ``repro.core``;
  - ``TopK.pick`` / ``Temperature.pick`` on one shared head output: the
    same token as the JAX sampler, draw for draw;
  - ``LLM.generate`` with top-k, temperature and ``n_candidates``
    requests: the JAX engine's tokens and candidate ids, same seeds.

Tolerances: values at rtol 1e-5 (f32, the two frameworks sum in another
order); indices and accept lengths exact, on integer-valued inputs whose
sums are exact in any order where ties are planted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_topk_head import (  # noqa: E402
    fused_topk_head as pallas_topk,
    fused_verify_head as pallas_verify,
)
from repro.models import lm as jlm  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import fused_argmax_head as tfah  # noqa: E402
from repro_torch.kernels import fused_topk_head as tftk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serve import sampler as tsampler  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
ENGINE = dict(n_slots=4, max_len=96)


def _head_case(seed, b, d, v, ties):
    """h (B, D), w (D, V).  With ``ties``: small integers, so every logit
    is exact in any summation order and many are equal, and the winning
    columns are copied into other 512-wide vocab tiles (the Pallas
    kernel's tile width) so equal values straddle tile boundaries."""
    rng = np.random.default_rng(seed)
    if not ties:
        return (rng.normal(size=(b, d)).astype(np.float32),
                rng.normal(size=(d, v)).astype(np.float32))
    h = rng.integers(-1, 2, size=(b, d)).astype(np.float32)
    w = rng.integers(-2, 3, size=(d, v)).astype(np.float32)
    top = np.argsort(-(h @ w), axis=1, kind="stable")[:, :3]
    for j in np.unique(top):
        w[:, (j + 512) % v] = w[:, j]
        w[:, (j + 700) % v] = w[:, j]
    return h, w


@pytest.mark.parametrize("k", [1, 4, 64])
@pytest.mark.parametrize("b,d,v,ties", [(3, 16, 1100, True),
                                        (1, 16, 1100, True),
                                        (4, 32, 777, False)])
def test_topk_head_matches_pallas_and_ref(k, b, d, v, ties):
    h, w = _head_case(100 * k + b, b, d, v, ties)
    p_val, p_idx = pallas_topk(jnp.asarray(h), jnp.asarray(w), k,
                               interpret=True)
    r_val, r_idx = jref.fused_topk_head(jnp.asarray(h), jnp.asarray(w), k)
    val, idx = tops.fused_topk_head(torch.from_numpy(h),
                                    torch.from_numpy(w), k)
    assert val.dtype == torch.float32 and idx.dtype == torch.int32
    assert tuple(val.shape) == tuple(idx.shape) == (b, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(val.numpy(), np.asarray(p_val), rtol=RTOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(r_val), rtol=RTOL)
    if ties and k > 1:
        assert (val[:, 1:] == val[:, :-1]).any()     # ties were in play


def test_topk_select_orders_ties_by_index():
    """Heavy ties and a run of +inf.  (-inf entries are left out: once
    the finite ones are used up, the JAX passes, which mark a pick by
    setting it to -inf, take the first -inf id again and again; the port
    gives distinct ids.  A head's logits are finite, so the serving path
    never meets the case.)"""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(5, 300)).astype(np.float32)
    x[2, 150:] = np.inf
    for k in (1, 17, 300):
        r_val, r_idx = jref.topk_select(jnp.asarray(x), k)
        val, idx = tref.topk_select(torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(r_val))
        c_val, c_idx = tcore.reduced_topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(c_idx.numpy(), idx.numpy())


@pytest.mark.parametrize("t", [1, 2, 5, 9])
def test_verify_draft_matches_pallas_and_ref(t):
    """Drafts equal a random prefix of each row's greedy ids, some with a
    wrong token mid-run, others -1 padded: ids and accept exact."""
    b, d, v = 4, 16, 1100
    rng = np.random.default_rng(t)
    h = rng.integers(-1, 2, size=(b, t, d)).astype(np.float32)
    w = rng.integers(-2, 3, size=(d, v)).astype(np.float32)
    ids0 = np.asarray(jref.fused_argmax_head(
        jnp.asarray(h.reshape(b * t, d)), jnp.asarray(w))).reshape(b, t)
    cand = np.full((b, t - 1), -1, np.int32)
    for r in range(b):
        width = min(r + 1, t - 1)
        cand[r, :width] = ids0[r, :width]
        if r == 2 and width:
            cand[r, width // 2] = (cand[r, width // 2] + 1) % v
    j_args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(cand))
    p_ids, p_acc = pallas_verify(*j_args, interpret=True)
    r_ids, r_acc = jref.verify_draft(*j_args)
    ids, acc = tops.verify_draft(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(cand))
    assert ids.dtype == acc.dtype == torch.int32
    for want_ids, want_acc in ((p_ids, p_acc), (r_ids, r_acc)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    if t > 1:
        assert acc.numpy().max() >= 1


def test_core_reduced_softmax_matches_jax():
    h, w = _head_case(7, 3, 16, 1100, ties=True)
    x = h @ w
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tcore.reduced_softmax_predict(tx).numpy(),
        np.asarray(jcore.reduced_softmax_predict(jnp.asarray(x))))
    ti, tv = tcore.argmax_with_value(tx)
    ji, jv = jcore.argmax_with_value(jnp.asarray(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    np.testing.assert_array_equal(
        tcore.fused_reduced_head(th, tw).numpy(),
        np.asarray(jcore.fused_reduced_head(jnp.asarray(h), jnp.asarray(w))))
    tv, ti = tcore.fused_reduced_topk(th, tw, 8)
    jv, ji = jcore.fused_reduced_topk(jnp.asarray(h), jnp.asarray(w), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    for k in (2, 10, 1000):
        assert tcore.unit_op_counts(k) == jcore.unit_op_counts(k)


@pytest.mark.parametrize("kw", [dict(k=8, temperature=0.8),
                                dict(k=8, temperature=1.3, sample_k=3),
                                dict(k=4, temperature=0.0),
                                dict(k=6, temperature=0.5, sample_k=1)])
def test_topk_pick_matches_jax_draw_for_draw(kw):
    rng = np.random.default_rng(3)
    vals = -np.sort(-rng.normal(size=(5, kw["k"])).astype(np.float32),
                    axis=1)
    idxs = rng.integers(0, 1000, size=(5, kw["k"])).astype(np.int32)
    tsmp, jsmp = tsampler.TopK(**kw), jsampler.TopK(**kw)
    trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for step in range(40):
        row = step % 5
        assert tsmp.pick((vals, idxs), row, trng) == \
            jsmp.pick((vals, idxs), row, jrng)
    np.testing.assert_array_equal(tsmp.candidate_ids((vals, idxs), 2),
                                  jsmp.candidate_ids((vals, idxs), 2))
    assert tsmp.device_form() == tsampler.TopK(kw["k"])


@pytest.mark.parametrize("temperature", [0.7, 1.0, 0.0])
def test_temperature_pick_matches_jax_draw_for_draw(temperature):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 256)).astype(np.float32)
    tsmp = tsampler.Temperature(temperature)
    jsmp = jsampler.Temperature(temperature)
    trng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    picks = [tsmp.pick(logits, s % 3, trng) for s in range(30)]
    assert picks == [jsmp.pick(logits, s % 3, jrng) for s in range(30)]
    if temperature > 0:
        assert len(set(picks)) > 3                  # really sampling


def test_sampler_validation_matches_jax_and_refuses_sharded():
    with pytest.raises(ValueError, match="top_k=65"):
        tsampler.resolve(TSP(top_k=65), cfg=TCFG)
    with pytest.raises(ValueError, match="softmax"):
        tsampler.resolve("softmax", top_k=4, cfg=TCFG)
    with pytest.raises(ValueError, match="n_candidates"):
        tsampler.resolve(TSP(n_candidates=2, head_mode="temperature"),
                         cfg=TCFG)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tsampler.resolve(TSP(top_k=4, head_mode="sharded"), cfg=TCFG)
    s = tsampler.resolve(TSP(top_k=2, n_candidates=5), cfg=TCFG)
    assert s == tsampler.TopK(5, 1.0, "reduced", sample_k=2)


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _serve(llm, prompts, plist):
    """generate() plus every streamed chunk's candidate ids, by rid."""
    cands = {}
    llm.engine.add_consumer(
        lambda c: cands.setdefault(c.rid, []).append(c.candidate_ids))
    outs = llm.generate(prompts, plist)
    return outs, [cands[o.rid] for o in outs]


def test_generate_sampled_matches_jax(bridged):
    """Top-k at two temperatures, Gumbel-max temperature, candidate ids
    with greedy and with top-k sampling, and greedy rows, in one
    continuously batched run: the JAX engine's tokens, finish reasons
    and candidate ids, from the same seeds."""
    jparams, tparams = bridged
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 9, 30, 12, 3, 21)]
    sp = [dict(max_new_tokens=10, top_k=8, temperature=0.8, seed=1),
          dict(max_new_tokens=10, top_k=4, temperature=1.5),
          dict(max_new_tokens=10, head_mode="temperature",
               temperature=0.7, seed=3),
          dict(max_new_tokens=10, n_candidates=4),
          dict(max_new_tokens=10, top_k=3, n_candidates=6, seed=5),
          dict(max_new_tokens=10),
          dict(max_new_tokens=10, top_k=64, seed=7)]
    kw = dict(ENGINE, eos_id=-1)
    jouts, jc = _serve(JLLM(jparams, JCFG, **kw), prompts,
                       [JSP(**p) for p in sp])
    tllm = TLLM(tparams, TCFG, **kw)
    touts, tc = _serve(tllm, prompts, [TSP(**p) for p in sp])
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    assert tc == jc
    assert all(c is not None and len(c) == 4 for c in tc[3])
    assert all(c is not None and len(c) == 6 for c in tc[4])
    assert all(c is None for c in tc[0])
    # greedy with candidates: the token is the first candidate
    assert [c[0] for c in tc[3]] == list(touts[3].token_ids)
    calls = tllm.stats["head_calls"]
    assert calls["TopK"] > 0 and calls["Temperature"] > 0
    assert calls["Greedy"] > 0


def test_cpu_sampled_run_launches_no_kernel(bridged):
    """CPU tensors take the plain top-k and verify versions; the CUDA
    wrappers refuse CPU tensors."""
    _, tparams = bridged
    tftk.fused_topk_head.launches = 0
    tfah.fused_verify_head.launches = 0
    llm = TLLM(tparams, TCFG, **ENGINE)
    phrase = np.tile(np.arange(3, 8, dtype=np.int32), 4)
    outs = llm.generate([phrase, phrase[:7]],
                        [TSP(max_new_tokens=6, top_k=4, seed=0),
                         TSP(max_new_tokens=6, spec_k=3)])
    assert all(len(o.token_ids) >= 1 for o in outs)
    assert llm.stats["head_calls"].get("TopK", 0) > 0
    assert tftk.fused_topk_head.launches == 0
    assert tfah.fused_verify_head.launches == 0
    h = torch.zeros((2, 16))
    w = torch.zeros((300, 16)).t()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tftk.fused_topk_head(h, w, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfah.fused_verify_head(h[:, None], w,
                               torch.zeros((2, 0), dtype=torch.int32))
