"""The port's serving stack (``repro_torch.serve``) against the JAX
package's ``repro.serve.api.LLM`` on bridged weights, at the smoke size
of qwen3-0.6b (f32): the same token lists and finish reasons, plain,
under forced preemption, and with stop sequences and eos.  Plus the
port's own contracts: the softmax baseline equals the reduced head
(Theorem 1), ``stream`` equals ``generate``, entry points refuse a
missing card, CPU runs launch no kernel, unported engine modes raise and
out-of-range token ids are refused.  Sampled and speculative serving
are held against the JAX package in ``test_torch_sampling.py`` and
``test_torch_spec.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import fused_argmax_head as tfah  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

# one JAX config for every case, so its jitted steps are reused
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
ENGINE = dict(n_slots=4, max_len=96)


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _both(bridged, prompts, sp, **kw):
    """Generate with both packages; returns (jax outs, port outs, jax
    stats, port stats) after asserting equal tokens and finish reasons."""
    jparams, tparams = bridged
    jllm = JLLM(jparams, JCFG, **kw)
    tllm = TLLM(tparams, TCFG, **kw)
    jouts = jllm.generate(prompts, [JSP(**p) for p in sp])
    touts = tllm.generate(prompts, [TSP(**p) for p in sp])
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    assert [o.prompt_token_ids for o in touts] == \
        [o.prompt_token_ids for o in jouts]
    return jouts, touts, jllm.stats, tllm.stats


def test_generate_matches_jax(bridged):
    prompts = _prompts(0, (5, 17, 33, 8, 12))
    sp = [dict(max_new_tokens=10)] * len(prompts)
    _, touts, js, ts = _both(bridged, prompts, sp, **ENGINE)
    assert all(len(o.token_ids) >= 1 for o in touts)
    for k in ("prefills", "decode_steps", "iterations", "fused_rows",
              "completed"):
        assert ts[k] == js[k], k
    assert ts["decode_steps"] == ts["iterations"] > 0


def test_untied_head_matches_jax():
    """qwen3-32b's smoke config has an untied ``lm_head``: the engine
    stores it (V, D) row-major once at load, as the head kernel reads it,
    and serves the JAX package's tokens."""
    jcfg = j_smoke(J_ARCHS["qwen3-32b"])
    tcfg = smoke_config(get_config("qwen3-32b"))
    assert not tcfg.tie_embeddings
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jparams)
    tllm = TLLM(weights.from_numpy_params(np_tree, tcfg, "cpu"), tcfg,
                **ENGINE)
    w = tlm.lm_head_weight(tllm.engine.params, tcfg)
    assert w.t().is_contiguous()
    np.testing.assert_array_equal(w.numpy(), np_tree["lm_head"])
    prompts = _prompts(2, (7, 19, 4))
    jouts = JLLM(jparams, jcfg, **ENGINE).generate(
        prompts, JSP(max_new_tokens=8))
    touts = tllm.generate(prompts, TSP(max_new_tokens=8))
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]


def test_preemption_matches_jax(bridged):
    """A pool too small for every admitted slot preempts the youngest
    back to the queue in both packages -- with the same tokens."""
    prompts = _prompts(5, (8, 8, 8))
    sp = [dict(max_new_tokens=12)] * 3
    _, _, js, ts = _both(bridged, prompts, sp, n_slots=2, max_len=64,
                         block_size=8, num_blocks=4)
    assert js["preemptions"] > 0 and ts["preemptions"] > 0
    assert ts["preemptions"] == js["preemptions"]


def test_stop_sequences_and_eos_match_jax(bridged):
    """eos and stop sequences taken from a plain run, so both fire
    mid-generation; per-request params."""
    _, tparams = bridged
    prompts = _prompts(0, (5, 17, 33, 8, 12))
    plain = TLLM(tparams, TCFG, **ENGINE).generate(
        prompts, TSP(max_new_tokens=10))
    eos = plain[0].token_ids[3]
    stop = plain[1].token_ids[4:6]
    sp = [dict(max_new_tokens=10), dict(max_new_tokens=10, stop=[stop]),
          dict(max_new_tokens=10, stop=[(1, 2, 3), stop[:1]]),
          dict(max_new_tokens=6), dict(max_new_tokens=10, stop=7)]
    _, touts, _, _ = _both(bridged, prompts, sp, eos_id=int(eos), **ENGINE)
    reasons = [o.finish_reason for o in touts]
    assert "eos" in reasons and "stop" in reasons


def test_softmax_baseline_equals_reduced(bridged):
    """Theorem 1 at the API: the full softmax unit picks the same tokens
    as the reduced comparator."""
    _, tparams = bridged
    prompts = _prompts(3, (4, 9, 21))
    sp = TSP(max_new_tokens=8)
    red = TLLM(tparams, TCFG, **ENGINE).generate(prompts, sp)
    soft = TLLM(tparams, TCFG, head_mode="softmax", **ENGINE).generate(
        prompts, sp)
    mixed = TLLM(tparams, TCFG, **ENGINE).generate(
        prompts, [sp, TSP(max_new_tokens=8, head_mode="softmax"), sp])
    assert [o.token_ids for o in soft] == [o.token_ids for o in red]
    assert [o.token_ids for o in mixed] == [o.token_ids for o in red]


def test_stream_equals_generate(bridged):
    _, tparams = bridged
    prompt = _prompts(4, (11,))[0]
    sp = TSP(max_new_tokens=9)
    want = TLLM(tparams, TCFG, **ENGINE).generate([prompt], sp)[0]
    chunks = list(TLLM(tparams, TCFG, **ENGINE).stream(prompt, sp))
    assert tuple(c.token for c in chunks) == want.token_ids
    assert [c.index for c in chunks] == list(range(len(chunks)))
    assert chunks[-1].finish_reason == want.finish_reason
    assert all(c.finish_reason is None for c in chunks[:-1])


def test_device_guards_and_cpu_runs_launch_no_kernel(bridged):
    """Entry points run on the card and refuse a missing one; the CPU
    path (plain versions) never touches a kernel counter."""
    _, tparams = bridged
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TLLM.from_arch("qwen3-0.6b")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TLLM.from_arch("qwen3-0.6b", smoke=True, device="cuda")
    tpa.paged_attention.launches = 0
    tfah.fused_argmax_head_with_value.launches = 0
    llm = TLLM.from_arch("qwen3-0.6b", smoke=True, device="cpu", **ENGINE)
    outs = llm.generate(_prompts(6, (6, 13)), TSP(max_new_tokens=5))
    assert all(len(o.token_ids) == 5 or o.finish_reason == "eos"
               for o in outs)
    assert llm.stats["decode_steps"] > 0
    assert tpa.paged_attention.launches == 0
    assert tfah.fused_argmax_head_with_value.launches == 0
    assert llm.kv_usage()["blocks_free"] == llm.kv_usage()["num_blocks"]
    assert llm.health()["ok"]


@pytest.mark.parametrize("kw", [dict(chunk_size=16), dict(host_stride=4),
                                dict(tp=2), dict(scheduler="cohort"),
                                dict(kv_layout="dense"),
                                dict(kv_layout="dense", attn_approx="pseudo"),
                                dict(head_mode="sharded"),
                                dict(token_budget=8),
                                dict(prefix_cache=True),
                                dict(prefix_cache=False)])
def test_unported_engine_modes_raise(bridged, kw):
    _, tparams = bridged
    with pytest.raises(NotImplementedError):
        TLLM(tparams, TCFG, **ENGINE, **kw)


def test_submit_rejects_out_of_range_token_ids(bridged):
    _, tparams = bridged
    llm = TLLM(tparams, TCFG, **ENGINE)
    with pytest.raises(ValueError, match="token ids"):
        llm.submit(np.asarray([0, TCFG.vocab_size], np.int32))
    with pytest.raises(ValueError, match="token ids"):
        llm.submit(np.asarray([-1, 3], np.int32))
