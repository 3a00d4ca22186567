"""Approximate-attention serving and the divergence probe of the port
against the JAX package, on the CPU, at the smoke size of qwen3-0.6b with
f32 weights bridged from JAX:

  - ``attn_approx='exact'`` serves the stock port engine's tokens, plain
    and under ``spec_k=4``;
  - each exp-free mode at ``attn_window=16`` serves the JAX engine's
    tokens, and ``pseudo`` at window 8 does so under forced preemption
    (one-shot re-prefill); a stream may part from JAX's only at a
    near-tie of the two best f32 logits (gap <= 1e-3 * |max|), and the
    test prints such a case;
  - engine mode validation, and the report parked on the engine;
  - ``repro_torch.probe.run_probe`` gives ``repro.probe.run_probe``'s
    divergence lists and per-layer score errors (within 1e-5) on the
    same prompts, with the JAX report's schema, and its CLI runs;
  - the probe's tap scores each call before a later request reuses the
    call's pool blocks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import probe as jprobe  # noqa: E402
from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro_torch import probe as tprobe  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
ENGINE = dict(n_slots=2, max_len=64)
NEAR_TIE = 1e-3             # top-2 f32 logit gap over |max|, PERF.md §2


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size,
                         int(rng.integers(4, 20))).astype(np.int32)
            for _ in range(n)]


def _top2_gap(monkeypatch, tparams, prompt, tokens, k, **engine_kw):
    """(gap, max) of the f32 logits of the port's hidden state that chose
    ``tokens[k]``: the request served alone in the same mode, its final
    hidden states recorded (the prefill's gives token 0, decode step j
    token j)."""
    seen = []
    final_hidden = tlm.final_hidden

    def record(params, cfg, x):
        h = final_hidden(params, cfg, x)
        seen.append(h.reshape(-1, h.shape[-1])[0])
        return h

    monkeypatch.setattr(tlm, "final_hidden", record)
    llm = TLLM(tparams, TCFG, **engine_kw)
    out = llm.generate([prompt], TSP(max_new_tokens=k + 1))[0]
    monkeypatch.undo()
    assert list(out.token_ids[:k]) == list(tokens[:k])
    logits = seen[k].float() @ tlm.lm_head_weight(
        llm.engine.params, llm.cfg).float()
    top2 = torch.topk(logits, 2).values
    return float(top2[0] - top2[1]), float(top2[0])


def _same_or_near_tie(monkeypatch, tparams, prompts, want, got, what,
                      **engine_kw):
    """Port streams equal the JAX streams, or part from them only at a
    near-tie of the port's top-2 f32 logits (printed)."""
    for p, w, g in zip(prompts, want, got):
        if list(w) == list(g):
            continue
        k = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b),
                 min(len(w), len(g)))
        assert k < min(len(w), len(g)), (what, w, g)
        gap, top = _top2_gap(monkeypatch, tparams, p, g, k, **engine_kw)
        print(f"{what}: streams part at step {k}, top-2 f32 logit gap "
              f"{gap:.6g} (max {top:.6g})")
        assert gap <= NEAR_TIE * abs(top), (what, k, gap, top)


def _generate(jllm_or_tllm, prompts, sp_cls, max_new):
    outs = jllm_or_tllm.generate(prompts, sp_cls(max_new_tokens=max_new))
    return [list(o.token_ids) for o in outs]


def test_engine_exact_is_bit_identical(bridged):
    """attn_approx='exact' replaces to an equal cfg and serves the stock
    engine's tokens -- plain and under spec_k=4."""
    _, tparams = bridged
    prompts = _prompts(4, 0)
    base = _generate(TLLM(tparams, TCFG, **ENGINE), prompts, TSP, 8)
    llm = TLLM(tparams, TCFG, attn_approx="exact", **ENGINE)
    assert _generate(llm, prompts, TSP, 8) == base
    assert llm.cfg == dataclasses.replace(TCFG, attn_approx="exact") == TCFG
    rep = [np.tile(np.arange(2, 6, dtype=np.int32), 4) for _ in range(3)]
    spp = TSP(max_new_tokens=10, spec_k=4)
    b_spec = TLLM(tparams, TCFG, **ENGINE).generate(rep, spp)
    e_llm = TLLM(tparams, TCFG, attn_approx="exact", **ENGINE)
    g_spec = e_llm.generate(rep, spp)
    assert [o.token_ids for o in g_spec] == [o.token_ids for o in b_spec]
    assert e_llm.stats["accepted"] > 0


@pytest.mark.parametrize("variant", ["base2", "pseudo", "pwl", "maxonly"])
def test_engine_variants_match_jax(bridged, monkeypatch, variant):
    """Each exp-free mode at attn_window=16 serves the JAX engine's tokens
    on bridged weights, surfaces in stats and returns every block."""
    jparams, tparams = bridged
    prompts = _prompts(3, 1)
    kw = dict(attn_approx=variant, attn_window=16, **ENGINE)
    want = _generate(JLLM(jparams, JCFG, **kw), prompts, JSP, 10)
    llm = TLLM(tparams, TCFG, **kw)
    got = _generate(llm, prompts, TSP, 10)
    assert all(len(g) >= 1 for g in got)
    _same_or_near_tie(monkeypatch, tparams, prompts, want, got,
                      f"{variant} window 16", **kw)
    stats = llm.stats
    assert stats["attn_approx"] == variant and stats["attn_window"] == 16
    assert llm.cfg.attn_approx == variant and llm.cfg.attn_window == 16
    assert llm.kv_usage()["blocks_free"] == llm.kv_usage()["num_blocks"]


def test_windowed_pseudo_under_preemption_matches_jax(bridged, monkeypatch):
    """pseudo at window 8 on a pool of 5 blocks of 8: slots are preempted
    and re-prefilled one-shot in both packages, with the same tokens."""
    jparams, tparams = bridged
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, TCFG.vocab_size, size=9).astype(np.int32)
               for _ in range(3)]
    kw = dict(n_slots=2, max_len=64, block_size=8, num_blocks=5,
              attn_approx="pseudo", attn_window=8)
    jllm = JLLM(jparams, JCFG, **kw)
    want = _generate(jllm, prompts, JSP, 14)
    tllm = TLLM(tparams, TCFG, **kw)
    got = _generate(tllm, prompts, TSP, 14)
    _same_or_near_tie(monkeypatch, tparams, prompts, want, got,
                      "pseudo window 8 under preemption", **kw)
    assert tllm.stats["preemptions"] >= 1
    assert tllm.stats["preemptions"] == jllm.stats["preemptions"]


def test_engine_mode_validation(bridged):
    _, tparams = bridged
    with pytest.raises(ValueError):
        ServeEngine(tparams, TCFG, attn_approx="nope")
    with pytest.raises(ValueError):
        ServeEngine(tparams, TCFG, attn_window=0)
    # the port serves the paged layout only: dense is refused outright
    with pytest.raises(NotImplementedError):
        ServeEngine(tparams, TCFG, kv_layout="dense", attn_approx="pseudo")
    with pytest.raises(ValueError):
        TSP(attn_approx="nope")
    eng = ServeEngine(tparams, TCFG, attn_approx="pseudo")
    with pytest.raises(ValueError, match="engine-wide"):
        eng.submit(Request(0, np.arange(3, dtype=np.int32),
                           params=TSP(attn_approx="exact")))
    eng.submit(Request(1, np.arange(3, dtype=np.int32),
                       params=TSP(attn_approx="pseudo")))
    # a cfg that already carries a mode keeps it when the kwargs are None
    cfg = dataclasses.replace(TCFG, attn_approx="pwl", attn_window=4)
    eng = ServeEngine(tparams, cfg)
    assert (eng.cfg.attn_approx, eng.cfg.attn_window) == ("pwl", 4)
    eng = ServeEngine(tparams, cfg, attn_window=9)
    assert (eng.cfg.attn_approx, eng.cfg.attn_window) == ("pwl", 9)
    # the facade's from_arch passes both through, and stats() shows them
    llm = TLLM.from_arch("qwen3-0.6b", device="cpu", attn_approx="maxonly",
                         attn_window=16, **ENGINE)
    assert (llm.cfg.attn_approx, llm.cfg.attn_window) == ("maxonly", 16)
    assert (llm.stats["attn_approx"], llm.stats["attn_window"]) == (
        "maxonly", 16)


def _check_schema(rep, n, names):
    assert rep["n_requests"] == n and rep["baseline"] == "exact"
    assert set(rep["variants"]) == set(names)
    ex = rep["variants"]["exact"]
    assert ex["divergence"] == 0.0 and ex["diverged_requests"] == 0
    assert ex["first_divergence"] == [None] * n
    for name in names:
        if name == "exact":
            continue
        row = rep["variants"][name]
        assert set(row) == {"divergence", "diverged_requests", "n_requests",
                            "first_divergence", "mean_first_divergence",
                            "score_error"}, name
        assert 0.0 <= row["divergence"] <= 1.0
        assert len(row["first_divergence"]) == n
        assert all(0.0 <= v <= 1.0 for v in row["score_error"].values())


@pytest.mark.parametrize("window", [None, 8])
def test_probe_matches_jax(bridged, window):
    """The port's probe on the JAX probe's prompts: the same divergence
    lists, the exact arm at 0.0, per-layer score errors within 1e-5."""
    jparams, tparams = bridged
    prompts = _prompts(3, 2)
    variants = ("pseudo", "maxonly", "base2", "pwl")
    kw = dict(variants=variants, window=window, max_new_tokens=4, **ENGINE)
    want = jprobe.run_probe(jparams, JCFG, prompts, **kw)
    got = tprobe.run_probe(tparams, TCFG, prompts, **kw)
    names = ("exact",) + variants
    _check_schema(want, 3, names)
    _check_schema(got, 3, names)
    assert got["window"] == want["window"] == window
    # the port's report also lists its engine runs (the JAX one does not)
    assert [r["attn_approx"] for r in got["runs"]] == [
        "exact", *variants, "exact"]
    assert all(r["decode_steps"] > 0 and r["prefills"] >= 3
               for r in got["runs"])
    for name in names:
        g, w = got["variants"][name], want["variants"][name]
        for key in ("divergence", "diverged_requests", "n_requests",
                    "first_divergence", "mean_first_divergence"):
            assert g[key] == w[key], (name, key)
        if name != "exact":
            assert list(g["score_error"]) == list(w["score_error"]) == [
                f"layer_{i}" for i in range(TCFG.n_layers)]
            for layer, err in w["score_error"].items():
                assert abs(g["score_error"][layer] - err) <= 1e-5, (
                    name, layer)


def test_probe_report_rides_snapshot_and_cli(bridged, capsys):
    _, tparams = bridged
    rep = tprobe.run_probe(tparams, TCFG, _prompts(2, 4),
                           variants=("pseudo",), max_new_tokens=3,
                           score_probe=False, **ENGINE)
    assert "score_error" not in rep["variants"]["pseudo"]
    eng = ServeEngine(tparams, TCFG, **ENGINE)
    assert "attn_probe" not in eng.snapshot()
    eng.probe_report = rep
    assert eng.snapshot()["attn_probe"]["baseline"] == "exact"
    assert tprobe.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "3",
                        "--variants", "maxonly"]) == 0
    assert '"baseline": "exact"' in capsys.readouterr().out


class _Recorder:
    """A tap that forwards to the probe's tap and also keeps, per call,
    a copy of the operands (the scores as they were) and the operands
    themselves (the pools as they will be)."""

    def __init__(self, tap):
        self.tap, self.copies, self.refs = tap, [], []

    def append(self, operands):
        self.tap.append(operands)
        self.copies.append(tuple(t.clone() for t in operands))
        self.refs.append(operands)


def _score_run(tparams, prompts, variants, **kw):
    tap = tprobe._ScoreTap(variants, None, TCFG.n_layers)
    rec = _Recorder(tap)
    tlayers._ATTN_TAP = rec
    try:
        streams, stats = tprobe._serve(tparams, TCFG, prompts,
                                       TSP(max_new_tokens=10),
                                       attn_approx="exact",
                                       attn_window=None, **kw)
    finally:
        tlayers._ATTN_TAP = None
    return tap.report(), rec, streams, stats


def test_tap_scores_each_call_before_its_blocks_are_reused(bridged):
    """On a pool of 5 blocks of 8, slots are preempted and their blocks
    handed to the other request, so the pools a call read are overwritten
    later.  The probe's errors equal those of the operands copied at call
    time; errors recomputed from the live pools afterwards (what keeping
    references would give) differ; and a roomy pool gives the same
    per-layer errors."""
    _, tparams = bridged
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, TCFG.vocab_size, size=9).astype(np.int32)
               for _ in range(3)]
    variants = ["base2", "pseudo", "pwl", "maxonly"]
    tight, rec, t_streams, t_stats = _score_run(
        tparams, prompts, variants, n_slots=2, max_len=64, block_size=8,
        num_blocks=5)
    assert t_stats["preemptions"] >= 1

    def replay(calls):
        tap = tprobe._ScoreTap(variants, None, TCFG.n_layers)
        for ops_ in calls:
            tap.append(ops_)
        return tap.report()

    assert replay(rec.copies) == tight
    moved = sum(
        not torch.equal(tprobe._masked_scores(*c, None),
                        tprobe._masked_scores(*r, None))
        for c, r in zip(rec.copies, rec.refs))
    assert moved > 0                       # the pools really were reused
    roomy, _, r_streams, r_stats = _score_run(
        tparams, prompts, variants, n_slots=2, max_len=64, block_size=8)
    assert r_stats["preemptions"] == 0
    assert r_streams == t_streams
    for v in variants:
        for layer, err in roomy[v].items():
            assert abs(tight[v][layer] - err) <= 1e-5, (v, layer)
