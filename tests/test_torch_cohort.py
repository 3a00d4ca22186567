"""The cohort scheduler in the port against the JAX package, on bridged
weights at the smoke size of qwen3-0.6b (f32).

``scheduler='cohort'`` is the reference's baseline: one step per
(position, device-form sampler) group of the active slots, so it needs
more decode steps than iterations where the fused scheduler needs one.
- the mirror of ``tests/test_serve_paged.py``'s fused-vs-cohort test
  (staggered prompts, mixed samplers) on both layouts: fused tokens
  equal cohort tokens, and each mode's ``decode_steps``, ``iterations``
  and ``fused_rows`` equal the JAX engine's;
- a pool too small for both slots preempts under cohort as in the JAX
  engine;
- ``spec_k`` under cohort is refused at submit
  (``tests/test_spec_decode.py``); ``chunk_size`` under cohort warns and
  admits one-shot, with the JAX engine's tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.serve import sampler as tsampler  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
STATS = ("decode_steps", "iterations", "fused_rows", "prefills",
         "preemptions", "completed")


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _serve(side, bridged, prompts, max_new, samplers=None, **kw):
    eng_cls, req_cls, mod = ((JEngine, JRequest, jsampler) if side == "jax"
                             else (TEngine, TRequest, tsampler))
    params, cfg = (bridged[0], JCFG) if side == "jax" else (bridged[1], TCFG)
    eng = eng_cls(params, cfg, eos_id=1, **kw)
    objs = [None] * len(prompts) if samplers is None else [
        getattr(mod, name)(**args) for name, args in samplers]
    reqs = [req_cls(i, p.copy(), max_new, sampler=s)
            for i, (p, s) in enumerate(zip(prompts, objs))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng.stats


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_fused_equals_cohort_with_the_jax_step_counts(bridged, layout):
    """Staggered prompt lengths (no two slots share a position) and mixed
    samplers: one step an iteration fused, more under cohort, the same
    tokens -- and each mode's counts are the JAX engine's."""
    prompts = _prompts(29, (3, 9, 14, 22))
    samplers = [("Greedy", {}), ("TopK", {"k": 4, "temperature": 0.8}),
                ("Temperature", {"temperature": 0.7}), ("Greedy", {})]
    kw = dict(n_slots=4, max_len=48, kv_layout=layout, block_size=8)
    runs = {}
    for sched in ("fused", "cohort"):
        want, js = _serve("jax", bridged, prompts, 6, samplers,
                          scheduler=sched, **kw)
        got, ts = _serve("torch", bridged, prompts, 6, samplers,
                         scheduler=sched, **kw)
        assert got == want, sched
        for k in STATS:
            assert ts[k] == js[k], (sched, k)
        runs[sched] = (got, ts)
    fused, fs = runs["fused"]
    cohort, cs = runs["cohort"]
    assert fused == cohort
    assert fs["decode_steps"] == fs["iterations"]
    assert fs["fused_rows"] == sum(len(g) - 1 for g in fused)
    assert cs["decode_steps"] > cs["iterations"]
    assert cs["fused_rows"] == fs["fused_rows"]


def test_cohort_preemption_matches_jax(bridged):
    """Two slots at one position share a cohort; a pool of 3 blocks of 8
    preempts the younger at a block boundary, as in the JAX engine."""
    prompts = _prompts(13, (8, 8, 8))
    kw = dict(n_slots=2, max_len=64, block_size=8, num_blocks=3,
              scheduler="cohort")
    want, js = _serve("jax", bridged, prompts, 12, **kw)
    got, ts = _serve("torch", bridged, prompts, 12, **kw)
    assert got == want
    assert ts["preemptions"] == js["preemptions"] >= 1
    for k in STATS:
        assert ts[k] == js[k], k


def test_spec_k_under_cohort_is_refused(bridged):
    eng = TEngine(bridged[1], TCFG, n_slots=1, max_len=32,
                  scheduler="cohort")
    with pytest.raises(ValueError, match="fused"):
        eng.submit(TRequest(0, np.arange(4, dtype=np.int32),
                            params=TSP(spec_k=2)))
    eng.submit(TRequest(1, np.arange(4, dtype=np.int32),
                        params=TSP(max_new_tokens=2)))
    eng.run()
    assert eng.stats["completed"] == 1


def test_chunk_size_under_cohort_warns(bridged):
    prompts = _prompts(31, (20, 5, 11))
    with pytest.warns(UserWarning, match="chunk_size=8 ignored"):
        eng = TEngine(bridged[1], TCFG, n_slots=3, max_len=48, eos_id=1,
                      scheduler="cohort", chunk_size=8)
    assert eng.chunk_size is None and not eng.prefix_cache
    reqs = [TRequest(i, p.copy(), params=TSP(max_new_tokens=5))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats["prefill_chunks"] == 0 and eng.stats["prefills"] == 3
    jeng = JEngine(bridged[0], JCFG, n_slots=3, max_len=48, eos_id=1,
                   scheduler="cohort")
    jreqs = [JRequest(i, p.copy(), params=JSP(max_new_tokens=5))
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    assert [list(r.generated) for r in reqs] == \
        [list(r.generated) for r in jreqs]
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
