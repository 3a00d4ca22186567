"""Chunked prefill in the port (``repro_torch.serve``) against the JAX
package's engine, on the CPU at the smoke size of qwen3-0.6b (f32), with
weights bridged from JAX (``weights.from_numpy_params``).  The
counterpart of ``tests/test_serve_chunked.py``.

Every case serves the same requests through both engines and holds the
port to the JAX engine's token lists, finish reasons, scheduler stats
(``prefill_chunks``, ``prefills``, ``prefill_tokens``, ``prefix_hits``,
``prefix_hit_tokens``, ``cow_copies``, ``peak_in_use``, ``preemptions``,
``deferred``, ``decode_steps``, ``iterations``) and admission order,
exactly:

  - chunk sizes mid-block, on a block edge and beyond the prompt, which
    also give the port's one-shot tokens;
  - ``token_budget`` 1 to 32 (more iterations, the same tokens);
  - a stop sequence across the final chunk's first token;
  - chunk-only iterations (one jitted step each in JAX, one step here);
  - a half-prefilled preemption, and natural preemption under a small
    pool;
  - the chunk-aware ``LLM.submit`` bound;
  - ``prefill_per_step`` and length-bucket packing (admission order);
  - ``pseudo`` attention at window 32, chunked;
  - ``spec_k`` drafts in steps that carry chunk rows;
  - a chunk step's plan: tokens, (B, T) positions, block tables, the
    head group's rows and its ``step_graph.bucket_key``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.serve import step_graph  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402
from repro_torch.serve.sampler import Greedy  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
# the stats both engines must agree on
STATS = ("prefill_chunks", "prefills", "prefill_tokens", "prefix_hits",
         "prefix_hit_tokens", "cow_copies", "peak_in_use", "preemptions",
         "deferred", "decode_steps", "iterations", "completed", "fused_rows")


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
            for n in lens]


def _engine(jax_side, bridged, **kw):
    eng_cls = JEngine if jax_side else TEngine
    params, cfg = (bridged[0], JCFG) if jax_side else (bridged[1], TCFG)
    kw = {"n_slots": 4, "max_len": 64, "eos_id": 1, "block_size": 4, **kw}
    return eng_cls(params, cfg, **kw)


def _submit(jax_side, eng, prompts, sp):
    req_cls, sp_cls = (JRequest, JSP) if jax_side else (TRequest, TSP)
    sps = sp if isinstance(sp, list) else [sp] * len(prompts)
    reqs = [req_cls(i, p.copy(), params=sp_cls(**s))
            for i, (p, s) in enumerate(zip(prompts, sps))]
    for r in reqs:
        eng.submit(r)
    return reqs


def _result(eng, reqs):
    """(token lists, finish reasons, snapshot, admission order)."""
    order = sorted(range(len(reqs)), key=lambda k: reqs[k].t_admit)
    return ([list(r.generated) for r in reqs],
            [r.finish_reason for r in reqs], eng.snapshot(), order)


def _serve(jax_side, bridged, prompts, sp, **kw):
    eng = _engine(jax_side, bridged, **kw)
    reqs = _submit(jax_side, eng, prompts, sp)
    eng.run()
    return _result(eng, reqs), eng


def _assert_same(want, got):
    (wt, wf, ws, wo), (gt, gf, gs, go) = want, got
    assert gt == wt
    assert gf == wf
    for k in STATS:
        assert gs[k] == ws[k], (k, gs[k], ws[k])
    assert go == wo


def _both(bridged, prompts, sp=None, **kw):
    """Serve ``prompts`` through both engines with the same kwargs and
    assert the same result; returns (the port's result, its engine)."""
    sp = sp if sp is not None else dict(max_new_tokens=6)
    want, _ = _serve(True, bridged, prompts, sp, **kw)
    got, eng = _serve(False, bridged, prompts, sp, **kw)
    _assert_same(want, got)
    return got, eng


STRADDLE = (3, 7, 8, 13, 22, 31)      # prompt lengths around blocks of 4


@pytest.fixture(scope="module")
def oneshot(bridged):
    """The port's one-shot tokens on the straddling prompts."""
    (toks, _, stats, _), _ = _serve(False, bridged, _prompts(STRADDLE, 1),
                                    dict(max_new_tokens=6))
    assert stats["prefill_chunks"] == 0
    return toks


@pytest.mark.parametrize("chunk", [3, 4, 5, 8, 64])
def test_chunked_matches_jax_and_oneshot(bridged, oneshot, chunk):
    """Chunk sizes mid-block (3, 5), on block edges (4, 8) and beyond
    every prompt (64): the JAX engine's tokens and stats, the port's
    one-shot tokens, one step per iteration, ceil(S / chunk) chunk rows
    a prompt."""
    prompts = _prompts(STRADDLE, 1)
    (toks, _, stats, _), eng = _both(bridged, prompts, chunk_size=chunk)
    assert toks == oneshot
    assert stats["decode_steps"] == stats["iterations"]
    assert stats["prefill_chunks"] == sum(-(-len(p) // chunk)
                                          for p in prompts)
    assert stats["prefills"] == stats["completed"] == len(prompts)
    assert eng.store.allocator.n_free + eng.store.prefix_trie.nodes \
        == eng.store.allocator.num_blocks


@pytest.mark.parametrize("budget", [1, 3, 6, 16, 32])
def test_token_budget_matches_jax(bridged, budget):
    """token_budget throttles chunk widths only: the JAX engine's tokens
    and iteration count, and the unthrottled run's tokens."""
    prompts = _prompts((24, 30, 9, 28), 8)
    base, _ = _serve(False, bridged, prompts, dict(max_new_tokens=4),
                     max_len=96, chunk_size=8)
    (toks, _, stats, _), _ = _both(bridged, prompts, dict(max_new_tokens=4),
                                   max_len=96, chunk_size=8,
                                   token_budget=budget)
    assert toks == base[0]
    assert stats["iterations"] >= base[2]["iterations"]
    if budget <= 6:
        assert stats["iterations"] > base[2]["iterations"]


def test_stop_sequence_across_chunk_edge(bridged):
    """A stop sequence of the first two greedy tokens completes one token
    after the final chunk's emission: the same finish in both engines,
    at chunk 2 and 5 and one-shot."""
    prompts = _prompts((11, 19), 3)
    (base, _, _, _), _ = _serve(False, bridged, prompts,
                                dict(max_new_tokens=8))
    sps = [dict(max_new_tokens=8, stop=[tuple(int(t) for t in b[:2])])
           for b in base]
    for chunk in (None, 2, 5):
        (toks, reasons, _, _), _ = _both(bridged, prompts, sps, n_slots=2,
                                         chunk_size=chunk)
        assert reasons == ["stop", "stop"]
        assert toks == [b[:2] for b in base]


def test_chunk_only_iterations(bridged):
    """One 40-token prompt alone: five chunk-only iterations (the last
    emits token 0), then three decode iterations, one step each."""
    prompts = _prompts((40,), 4)
    (toks, _, stats, _), _ = _both(bridged, prompts, dict(max_new_tokens=4),
                                   max_len=96, n_slots=2, chunk_size=8)
    assert stats["prefill_chunks"] == 5
    assert stats["iterations"] == stats["decode_steps"] == 5 + 3
    (base, _, _, _), _ = _serve(False, bridged, prompts,
                                dict(max_new_tokens=4), max_len=96,
                                n_slots=2)
    assert toks == base


def test_preempt_half_prefilled(bridged):
    """A request preempted mid-chunked-prefill frees every block, goes
    back to the queue with its original prompt, and re-prefills to the
    JAX engine's tokens (which are an unpreempted run's)."""
    (prompt,) = _prompts((40,), 5)
    results = []
    for jax_side in (True, False):
        eng = _engine(jax_side, bridged, n_slots=2, max_len=96, eos_id=-1,
                      num_blocks=24, chunk_size=4, prefix_cache=False)
        (req,) = _submit(jax_side, eng, [prompt], dict(max_new_tokens=4))
        eng.step()
        eng.step()
        assert eng._prefilling(0) and len(eng.store.slot_blocks[0]) == 2
        assert eng._preempt_youngest(keep=-1)
        assert eng.slots[0] is None and eng.store.allocator.n_free == 24
        assert eng.queue[0] is req and req.generated == []
        assert np.array_equal(req.prompt, prompt)
        eng.run()
        assert eng.store.allocator.n_free == 24
        results.append(_result(eng, [req]))
    _assert_same(*results)
    (base, _, _, _), _ = _serve(False, bridged, [prompt],
                                dict(max_new_tokens=4), n_slots=2,
                                max_len=96, eos_id=-1)
    assert results[1][0] == base


def test_pool_pressure_preempts_and_recovers(bridged):
    """An overcommitted pool under chunked admission: the same
    preemptions and deferrals as JAX, the uncontended tokens, and the
    pool drains back to full."""
    prompts = _prompts((21, 34, 18, 29), 6)
    (toks, _, stats, _), eng = _both(
        bridged, prompts, dict(max_new_tokens=5), max_len=96, chunk_size=4,
        num_blocks=12, prefix_cache=False)
    assert stats["preemptions"] > 0
    assert eng.store.allocator.n_free == 12
    (base, _, _, _), _ = _serve(False, bridged, prompts,
                                dict(max_new_tokens=5), max_len=96)
    assert toks == base


def test_submit_bound_is_chunk_aware(bridged):
    """S 13 at block 4 on a pool of 4 blocks: one-shot needs 4 + 1
    blocks and is refused at submit; chunked needs blocks_for(14) = 4 and
    serves the JAX facade's tokens; 30 tokens never fit."""
    jparams, tparams = bridged
    (prompt,) = _prompts((13,), 7)
    kw = dict(n_slots=1, max_len=24, eos_id=-1, block_size=4, num_blocks=4)
    with pytest.raises(ValueError, match="never be admitted"):
        TLLM(tparams, TCFG, **kw).submit(prompt, TSP())
    chunked = TLLM(tparams, TCFG, chunk_size=4, **kw)
    got = chunked.generate(prompt, TSP(max_new_tokens=3))[0]
    want = JLLM(jparams, JCFG, chunk_size=4, **kw).generate(
        prompt, JSP(max_new_tokens=3))[0]
    assert got.token_ids == want.token_ids and len(got.token_ids) == 3
    with pytest.raises(ValueError, match="never be admitted"):
        chunked.submit(np.zeros(30, np.int32), TSP())


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_per_step_matches_jax(bridged, chunk):
    """At most one admission an iteration, one-shot and chunked: the JAX
    engine's iterations, admission order and tokens."""
    prompts = _prompts((9, 14, 6, 11), 9)
    (_, _, stats, _), _ = _both(bridged, prompts, dict(max_new_tokens=4),
                                chunk_size=chunk, prefill_per_step=1)
    free, _ = _serve(False, bridged, prompts, dict(max_new_tokens=4),
                     chunk_size=chunk)
    assert stats["iterations"] > free[2]["iterations"]
    with pytest.raises(ValueError, match="prefill_per_step"):
        _engine(False, bridged, prefill_per_step=0)


def test_length_bucket_packing_order_matches_jax(bridged):
    """Behind a 20-token head (first chunk 8 wide), the lookahead picks
    the next prompt whose first chunk is 8 wide too, ahead of the short
    ones: an admission order that is not FIFO, the JAX engine's."""
    prompts = _prompts((20, 3, 2, 5, 17, 30, 2, 6), 10)
    (_, _, _, order), _ = _both(bridged, prompts, dict(max_new_tokens=3),
                                chunk_size=8)
    assert order[:4] == [0, 3, 4, 5] and order != sorted(order)


def test_pseudo_window_chunked_matches_jax(bridged):
    """Chunk rows attend with the engine's mode and window (the one-shot
    prefill does not): pseudo at window 32, chunk 8, prompts longer than
    the window."""
    prompts = _prompts((45, 12, 38), 11)
    _both(bridged, prompts, dict(max_new_tokens=6), max_len=96,
          chunk_size=8, attn_approx="pseudo", attn_window=32)


def test_spec_with_chunk_rows_matches_jax(bridged):
    """spec_k 3 on repetitive prompts while longer prompts prefill in
    chunks of 8: draft rows verify in chunk-widened steps (T 8), with the
    JAX engine's drafted and accepted counts."""
    rng = np.random.default_rng(12)
    rep = [np.tile(rng.integers(0, TCFG.vocab_size, 4), 4).astype(np.int32)
           for _ in range(2)]
    prompts = rep + _prompts((30, 27), 13)
    sp = dict(max_new_tokens=10, spec_k=3)
    want, _ = _serve(True, bridged, prompts, sp, chunk_size=8)
    got, eng = _serve(False, bridged, prompts, sp, chunk_size=8)
    _assert_same(want, got)
    for k in ("drafted", "accepted"):
        assert got[2][k] == want[2][k] > 0, k
    (base, _, _, _), _ = _serve(False, bridged, prompts,
                                dict(max_new_tokens=10), chunk_size=8)
    assert got[0] == base


def test_chunk_step_plan_and_bucket_key():
    """A mid-prefill chunk row beside a decode row, then a final chunk:
    the plan's tokens, (B, T) positions, block tables, group rows and
    bucket key."""
    llm = TLLM.from_arch("qwen3-0.6b", device="cpu", n_slots=4, max_len=64,
                         block_size=4, chunk_size=8)
    eng = llm.engine
    long, short = _prompts((20, 5), 14)
    llm.submit(long, TSP(max_new_tokens=4))
    llm.submit(short, TSP(max_new_tokens=4))
    eng.step()                       # chunk [0, 8) of long; short whole
    assert eng._prefilling(0) and not eng._prefilling(1)
    plan = eng._plan_step([0, 1])
    assert plan.chunks == {0: (8, 8)}
    assert plan.where == [(None, None), (Greedy(), 0)]
    toks, pos, table, rows = plan.arrays
    g = eng.slots[1].generated[-1]
    assert toks.tolist() == [long[8:16].tolist(), [g] * 8]
    assert pos.tolist() == [list(range(8, 16)), [5] * 8]
    blocks = eng.store.slot_blocks
    assert table.tolist() == [blocks[0][:4],
                              blocks[1][:2] + [blocks[1][0]] * 2]
    assert rows.tolist() == [1, 1]
    assert plan.key == step_graph.bucket_key(
        (Greedy(),), (2, 8), (2, 4), (2,), 0) == (2, 4, 8, (Greedy(),),
                                                  (2,), 0)
    eng._decode_rows([0, 1])        # serve it
    final = eng._plan_step([0, 1])
    assert final.chunks == {0: (16, 4)}
    assert final.where == [(Greedy(), 0), (Greedy(), 1)]
    toks, pos, table, rows = final.arrays
    assert toks[0].tolist() == long[16:20].tolist()
    assert pos.tolist() == [[16, 17, 18, 19], [6] * 4]
    assert rows.tolist() == [0, 1] and table.shape == (2, 8)
    assert final.key == (2, 8, 4, (Greedy(),), (2,), 0)
