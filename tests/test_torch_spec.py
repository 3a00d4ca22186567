"""Speculative decoding in the port against the JAX package, on the CPU,
with f32 weights bridged from JAX (``weights.from_numpy_params``).

  - ``PromptLookupDrafter`` proposes the JAX drafter's tokens on shared
    histories;
  - ``spec_k`` in {2, 4} (and 20: a 32-wide window, 64 query rows per KV
    head) serves the JAX engine's tokens and the port's own ``spec_k=0``
    tokens, with the same drafted/accepted counts -- on ragged mixed
    traffic, under forced preemption (a double preemption included),
    with stop and eos landing inside an accepted run;
  - ``store.rewind`` returns the rejected tail's blocks (a drafter that
    proposes garbage), and the store's rewind on its own;
  - submit refuses speculation without the comparator head.

Tokens are compared exactly: greedy decoding, f32 weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro.serve.spec import PromptLookupDrafter as JDrafter  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_kv import PagedKVStore  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402
from repro_torch.serve.spec import Drafter, PromptLookupDrafter  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _repetitive(rng, n, period):
    return np.tile(rng.integers(0, TCFG.vocab_size, period),
                   n // period + 1)[:n].astype(np.int32)


def _both(bridged, prompts, sp, **kw):
    """Serve with both packages; assert equal tokens, finish reasons and
    speculation counters; return (port outputs, port LLM)."""
    jparams, tparams = bridged
    jllm = JLLM(jparams, JCFG, **kw)
    tllm = TLLM(tparams, TCFG, **kw)
    jouts = jllm.generate(prompts, [JSP(**p) for p in sp])
    touts = tllm.generate(prompts, [TSP(**p) for p in sp])
    assert [o.token_ids for o in touts] == [o.token_ids for o in jouts]
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    for k in ("drafted", "accepted", "decode_steps", "preemptions"):
        assert tllm.stats[k] == jllm.stats[k], k
    return touts, tllm


@pytest.mark.parametrize("ngram,min_ngram", [(3, 1), (2, 2), (1, 1)])
def test_prompt_lookup_drafter_matches_jax(ngram, min_ngram):
    rng = np.random.default_rng(ngram)
    histories = [list(_repetitive(rng, n, p)) for n, p in
                 ((20, 3), (9, 4), (31, 5))]
    histories += [list(rng.integers(0, 50, n)) for n in (1, 2, 40, 60)]
    histories.append([7, 7, 7, 7, 7])
    ours = PromptLookupDrafter(ngram=ngram, min_ngram=min_ngram,
                               max_match_len=6)
    theirs = JDrafter(ngram=ngram, min_ngram=min_ngram, max_match_len=6)
    assert isinstance(ours, Drafter)
    for hist in histories:
        for k in (0, 1, 3, 8):
            assert ours.propose(hist, k) == theirs.propose(hist, k)
    with pytest.raises(ValueError):
        PromptLookupDrafter(ngram=1, min_ngram=2)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_matches_jax_and_greedy_on_mixed_traffic(bridged, spec_k):
    """Staggered prompts, half repetitive; speculative rows share fused
    steps with top-k and temperature rows."""
    _, tparams = bridged
    rng = np.random.default_rng(5)
    prompts = [_repetitive(rng, n, 3) if j % 2 == 0 else
               rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
               for j, n in enumerate((3, 9, 14, 22, 31, 6))]

    def plist(k):
        return [dict(max_new_tokens=12, top_k=4, temperature=0.8, seed=i)
                if i % 3 == 2 else
                dict(max_new_tokens=12, head_mode="temperature",
                     temperature=0.7, seed=i)
                if i % 3 == 1 else dict(max_new_tokens=12, spec_k=k)
                for i in range(len(prompts))]

    kw = dict(n_slots=4, max_len=96, eos_id=1)
    spec, tllm = _both(bridged, prompts, plist(spec_k), **kw)
    st = tllm.stats
    assert st["drafted"] > 0 and st["accepted"] > 0
    assert 0 < st["acceptance_rate"] <= 1
    assert st["decode_steps"] == st["iterations"]
    assert st["head_calls"]["verify"] > 0
    plain = TLLM(tparams, TCFG, **kw).generate(
        prompts, [TSP(**p) for p in plist(0)])
    assert [o.token_ids for o in spec] == [o.token_ids for o in plain]


class ReplayDrafter:
    """Drafts the continuation of a known stream wherever the history
    follows it, so every step drafts its whole window."""

    def __init__(self, streams):
        self.streams, self.widest = [list(x) for x in streams], 0

    def propose(self, history, k):
        n = len(history)
        for s in self.streams:
            if list(history) == s[:n]:
                self.widest = max(self.widest, len(s[n:n + k]))
                return s[n:n + k]
        return []


def test_spec_wide_window_matches_jax(bridged):
    """spec_k = 20 with a drafter replaying the greedy streams: 21-token
    windows widen the step to T = 32, 64 query rows per KV head at the
    smoke config's g = 2.  Every draft is accepted."""
    jparams, tparams = bridged
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
               for n in (40, 24)]
    kw = dict(n_slots=2, max_len=128, eos_id=-1)
    base = TLLM(tparams, TCFG, **kw).generate(prompts,
                                              TSP(max_new_tokens=30))
    streams = [[int(t) for t in p] + list(o.token_ids)
               for p, o in zip(prompts, base)]
    drafter = ReplayDrafter(streams)
    outs, tllm = _both(bridged, prompts,
                       [dict(max_new_tokens=30, spec_k=20)] * 2,
                       drafter=drafter, **kw)
    assert drafter.widest >= 16
    assert [o.token_ids for o in outs] == [o.token_ids for o in base]
    st = tllm.stats
    assert st["accepted"] == st["drafted"] > 0


def test_spec_stop_eos_and_length_truncate_mid_run(bridged):
    """A stop sequence or eos inside an accepted run stops emission where
    non-speculative decoding stops, and no block leaks."""
    _, tparams = bridged
    rng = np.random.default_rng(9)
    prompt = _repetitive(rng, 18, 3)
    kw = dict(n_slots=1, max_len=96, eos_id=-1)
    gen = TLLM(tparams, TCFG, **kw).generate(
        [prompt], TSP(max_new_tokens=12))[0].token_ids
    assert len(gen) == 12
    stop = [tuple(gen[4:6])]
    outs, _ = _both(bridged, [prompt, prompt],
                    [dict(max_new_tokens=12, stop=stop, spec_k=4),
                     dict(max_new_tokens=12, stop=stop)], n_slots=2,
                    max_len=96, eos_id=-1)
    assert outs[0].token_ids == outs[1].token_ids
    assert outs[0].finish_reason == outs[1].finish_reason == "stop"
    outs, tllm = _both(bridged, [prompt, prompt],
                       [dict(max_new_tokens=12, spec_k=4),
                        dict(max_new_tokens=12)], n_slots=2, max_len=96,
                       eos_id=int(gen[5]))
    assert outs[0].token_ids == outs[1].token_ids
    assert outs[0].finish_reason == "eos"
    kv = tllm.kv_usage()
    assert kv["blocks_free"] == kv["num_blocks"]


def test_spec_identical_under_forced_preemption(bridged):
    """Tight pool: deferral, preemption back to the queue and re-prefill
    (a double preemption of one request included) change no token."""
    _, tparams = bridged
    rng = np.random.default_rng(7)
    prompts = [_repetitive(rng, 8, 4) for _ in range(3)]
    sp = [dict(max_new_tokens=12, spec_k=4)] * 3
    kw = dict(n_slots=2, max_len=64, eos_id=-1, block_size=8)
    tight, tllm = _both(bridged, prompts, sp, num_blocks=4, **kw)
    assert tllm.stats["preemptions"] >= 2
    ample = TLLM(tparams, TCFG, **kw).generate(
        prompts, [TSP(**p) for p in sp])
    assert [o.token_ids for o in tight] == [o.token_ids for o in ample]


class GarbageDrafter:
    """Proposes token 0 for every draft: rejected nearly always."""

    def propose(self, history, k):
        return [0] * k


def test_spec_rewind_returns_rejected_tail_blocks(bridged):
    """Full rejection every step: after each step the slot owns exactly
    the cover of its real position (the 16-token windows were rewound),
    and the tokens are plain greedy's."""
    _, tparams = bridged
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, TCFG.vocab_size, 4).astype(np.int32)
    eng = ServeEngine(tparams, TCFG, n_slots=1, max_len=256, eos_id=-1,
                      block_size=8, drafter=GarbageDrafter())
    req = Request(0, prompt.copy(),
                  params=TSP(max_new_tokens=6, spec_k=16))
    eng.submit(req)
    surplus = []
    while eng.has_work:
        eng.step()
        if eng.slots[0] is not None:
            owned = len(eng.store.slot_blocks[0])
            need = int(eng.slot_pos[0]) // eng.store.block_size + 1
            surplus.append(owned - need)
    assert surplus and all(d == 0 for d in surplus), surplus
    assert eng.stats["drafted"] > 0
    base = TLLM(tparams, TCFG, n_slots=1, max_len=256, eos_id=-1,
                block_size=8).generate([prompt], TSP(max_new_tokens=6))
    assert req.generated == list(base[0].token_ids)
    kv = eng.store.usage()
    assert kv["blocks_free"] == kv["num_blocks"]


def test_store_rewind_unit():
    store = PagedKVStore(TCFG, n_slots=2, max_len=64, device="cpu",
                         block_size=8)
    store.alloc_blocks(0, 10)                     # 2 blocks: pos 0..15
    assert store.can_grow(0, 33) and store.ensure_capacity(0, 33)
    assert len(store.slot_blocks[0]) == 5
    free_before = store.allocator.n_free
    store.rewind(0, 17)                           # keep the cover of 17
    assert len(store.slot_blocks[0]) == 3
    assert store.allocator.n_free == free_before + 2
    store.rewind(0, 17)                           # idempotent
    assert len(store.slot_blocks[0]) == 3
    assert not store.can_grow(1, 8 * store.allocator.num_blocks)
    store.release(0)
    assert store.allocator.n_free == store.allocator.num_blocks


def test_spec_submit_guards(bridged):
    _, tparams = bridged
    with pytest.raises(ValueError):
        TSP(spec_k=4, top_k=2)
    with pytest.raises(ValueError):
        TSP(spec_k=4, head_mode="softmax")
    eng = ServeEngine(tparams, TCFG, n_slots=1, max_len=32,
                      head_mode="softmax")
    with pytest.raises(ValueError, match="comparator"):
        eng.submit(Request(0, np.arange(4, dtype=np.int32),
                           params=TSP(spec_k=2)))
    eng.submit(Request(1, np.arange(4, dtype=np.int32),
                       params=TSP(spec_k=2, head_mode="fused",
                                  max_new_tokens=3)))
    eng.run()
    assert eng.stats["completed"] == 1
